"""The plain PyTorch reference of the benchmark's configurations: the
models (``dense``, ``sparse``), their building blocks (``layers``), and the
loss, optimiser and batches of a training step (``train``). Frozen copies of
the port's plain code at commit add70c80; it imports nothing of the port and
takes nothing the port made."""
