"""The port's dense CGVAE (``models/dense_cgvae.py::DenseCGVAE``): its
messages run through the fused CUDA kernels 1-4."""
from cgbench.program import TrainerProgram


class Program(TrainerProgram):

    @staticmethod
    def model(model_cfg):
        from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE

        return DenseCGVAE(model_cfg)
