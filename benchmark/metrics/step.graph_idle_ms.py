"""step.graph_idle_ms: device milliseconds per traced step, inside the
step's own interval (the start of ``cgvae_mark_step`` to the end of
``cgvae_mark_end``, rank 0's), in which no device operation ran: the
dispatch gaps between the captured graph's nodes, mean over the steps. The
time between replays is outside it."""
from cgbench import phases


def read(ctx):
    return phases.idle_ms(ctx.trace, phases.steps(ctx.trace))
