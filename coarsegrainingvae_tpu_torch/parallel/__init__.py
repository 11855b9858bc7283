"""Multi-GPU training (port of ``coarsegrainingvae_tpu.parallel``): the data
mesh and its collectives (``mesh``), and the atom-sharded halo stack
(``halo``)."""
