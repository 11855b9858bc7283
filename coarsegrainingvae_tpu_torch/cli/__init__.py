"""Command-line entry points (port of ``coarsegrainingvae_tpu.cli``):
``run_cgvae`` (the k-fold CV run) and ``postanalysis`` (re-evaluate a
finished fold)."""
