"""The port's model families, one file each, found by a configuration's
``model`` (``cgbench.program.load``)."""
