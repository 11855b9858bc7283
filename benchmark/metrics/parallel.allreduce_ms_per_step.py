"""parallel.allreduce_ms_per_step: rank 0's device milliseconds per step in
NCCL kernels (the one all-reduce of gradient, loss and metrics a
data-parallel step makes). Nothing overlaps it, so all of it is exposed."""


def read(ctx):
    t = ctx.trace
    seconds, found = t.seconds_where(lambda name: "nccl" in name.lower())
    if not found or t.steps == 0:
        return None
    return 1e3 * seconds / t.steps
