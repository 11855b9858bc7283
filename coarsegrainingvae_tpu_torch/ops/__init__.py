"""Kernels and the plain torch operations around them."""


def kernel_counters() -> tuple:
    """The kernel wrappers whose ``launches`` attributes count launches."""
    from coarsegrainingvae_tpu_torch.ops import fused_message as mo
    from coarsegrainingvae_tpu_torch.ops import fused_pseudo as po

    return (mo.fused_message, mo.fused_message_vjp, po.fused_pseudo_message,
            po.fused_pseudo_vjp)
