"""epoch.host_launches_per_step: the host's launch calls in the traced
window (``cudaGraphLaunch`` and every kernel-launch API call) per step. An
exact count: a captured step makes one graph launch, and work that falls out
of the graph adds its kernels' launches."""


def read(ctx):
    if ctx.trace.steps == 0:
        return None
    return ctx.trace.launches() / ctx.trace.steps
