"""Multi-GPU training (port of ``coarsegrainingvae_tpu.parallel``): the
('data', 'model') mesh and its collectives (``mesh``), tensor parallelism
over the model axis (``tensor``), and the atom-sharded halo stack
(``halo``)."""
