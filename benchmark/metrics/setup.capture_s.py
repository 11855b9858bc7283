"""setup.capture_s: host seconds of this process's set-up in capturing the
train step (the epoch program's warm-up steps, the capture and the first
instantiation), the program's own ``train.capture`` spans in its
``utils.tracing`` registry; None where the port records no such span."""


def read(ctx):
    try:
        from coarsegrainingvae_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.find("train.capture")
    return sum(s.seconds for s in spans) if spans else None
