"""Host C++ of the port (port of ``coarsegrainingvae_tpu.native``): the
cell-list radius graph (``cell_list``) and the bond-graph diff
(``bond_diff``), built with g++ on first use into ``build/native/`` and
loaded with ctypes (``build``). There is no fallback: a failed build
raises. The dense numpy paths in ``data/neighbors.py`` and
``eval/metrics.py`` are their plain versions.
"""
