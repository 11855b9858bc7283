"""The port's sparse CGequiVAE (``models/cgvae.py::CGequiVAE``, its
``sparse`` setting on): per-edge messages and CSR segment sums, no CUDA
kernel."""
from cgbench.program import TrainerProgram


class Program(TrainerProgram):
    settings = {"sparse": True}

    @staticmethod
    def model(model_cfg):
        from coarsegrainingvae_tpu_torch.models.cgvae import CGequiVAE

        return CGequiVAE(model_cfg)
