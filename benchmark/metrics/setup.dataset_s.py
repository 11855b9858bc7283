"""setup.dataset_s: host seconds of this process's set-up in the port's
``build_dataset`` (frames to arrays: CG coordinates, both radius graphs,
the bonded edges), the program's own ``data.build_dataset`` spans in its
``utils.tracing`` registry; None where the port records no such span."""


def read(ctx):
    try:
        from coarsegrainingvae_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.find("data.build_dataset")
    return sum(s.seconds for s in spans) if spans else None
