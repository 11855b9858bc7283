"""PyTorch/CUDA port of coarsegrainingvae_tpu.

Same layout and names as the JAX package (``config``, ``ops``, ``models``,
``data``, ``train``, ``serve``). The port imports torch and numpy only, never
JAX. The TPU's Pallas kernels, forward and backward, become hand-written
CUDA kernels for Hopper (``csrc/``), built with nvcc on first use on a CUDA
device. It trains and serves the dense CGVAE: ``train.trainer.Trainer``
over ``data.dataset.build_dataset`` / ``data.device.DeviceDataset``,
``models.dense_cgvae.DenseCGVAE`` and ``serve.Backmapper.backmap``;
``cli.run_cgvae`` runs the k-fold CV workflow (checkpoints in
``train.checkpoint``, evaluation in ``eval``), ``cli.postanalysis`` and
``serve.Backmapper.from_run`` read a fold back, and
``convert.convert_flax_params`` loads a JAX model's parameters. PCN and
StochasticPCN (``models.cgvae``) train through ``train.pcn_trainer`` and
``cli.run_pcn`` on the protein data of ``data.sidechain``; the host C++ of
``native`` (cell-list radius graphs, bond-graph diffs) is built with g++
on first use.
"""
