"""The benchmark of ``coarsegrainingvae_tpu_torch`` (the PyTorch/CUDA port).

``benchmark/run.py`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything the yardstick needs lives in this package and in the
data files beside it: the frame generator (``frames``), the weights
(``weights``), the plain reference (``reference``), the comparison that
decides ``correct`` (``compare``), the trace reduction, the table of peaks
and the kernels' cost functions (``profiling``). From the port it takes only
the system under test (``Trainer`` and the models) and its kernels' names.
"""
