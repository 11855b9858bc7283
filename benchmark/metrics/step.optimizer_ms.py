"""step.optimizer_ms: device milliseconds per traced step of the update
(the flat gradient on one rank, its norm, the skip-batch guard, clip, Adam,
the apply and the moments' selects), read from the program's own phase
marks: the start of each ``cgvae_mark_optimizer`` to the start of the next
``cgvae_mark_bookkeeping`` (rank 0's), mean over the steps."""
from cgbench import phases


def read(ctx):
    return phases.phase_ms(ctx.trace, "optimizer", ("bookkeeping",))
