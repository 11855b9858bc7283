"""Kernels and the plain torch operations around them."""


class RouteCount:
    """A wrapper's launches on one route (its ``<route>_launches``), read and
    set as ``launches`` under the name ``<wrapper>_<route>``, so that the
    readers of ``kernel_counters()`` take it as one more counter."""

    def __init__(self, fn, route: str):
        self.fn, self.attr = fn, f"{route}_launches"
        self.__name__ = f"{fn.__name__}_{route}"

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.fn, self.attr, n)


def kernel_counters() -> tuple:
    """The kernel wrappers whose ``launches`` attributes count launches:
    kernels 1-4, the fused optimizer step and its norm alone, then kernel
    1's launches on the tensor-core route."""
    from coarsegrainingvae_tpu_torch.ops import fused_adam as ao
    from coarsegrainingvae_tpu_torch.ops import fused_message as mo
    from coarsegrainingvae_tpu_torch.ops import fused_pseudo as po

    return (mo.fused_message, mo.fused_message_vjp, po.fused_pseudo_message,
            po.fused_pseudo_vjp, ao.fused_adam, ao.fused_global_norm,
            RouteCount(mo.fused_message, "tc"))
