"""Kernels and the plain torch operations around them."""


def kernel_counters() -> tuple:
    """The kernel wrappers whose ``launches`` attributes count launches:
    kernels 1-4, then the fused optimizer step and its norm alone."""
    from coarsegrainingvae_tpu_torch.ops import fused_adam as ao
    from coarsegrainingvae_tpu_torch.ops import fused_message as mo
    from coarsegrainingvae_tpu_torch.ops import fused_pseudo as po

    return (mo.fused_message, mo.fused_message_vjp, po.fused_pseudo_message,
            po.fused_pseudo_vjp, ao.fused_adam, ao.fused_global_norm)
