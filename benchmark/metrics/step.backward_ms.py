"""step.backward_ms: device milliseconds per traced step of
``autograd.grad``, read from the program's own phase marks: the start of
each ``cgvae_mark_backward`` to the start of the next ``cgvae_mark_exchange``
(several ranks) or ``cgvae_mark_optimizer`` (rank 0's), mean over the
steps."""
from cgbench import phases


def read(ctx):
    return phases.phase_ms(ctx.trace, "backward", ("exchange", "optimizer"))
