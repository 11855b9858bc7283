"""step.forward_ms: device milliseconds per traced step of the model's
forward and ``vae_loss``, read from the program's own phase marks: the
start of each ``cgvae_mark_forward`` to the start of the next
``cgvae_mark_backward`` (rank 0's), mean over the steps."""
from cgbench import phases


def read(ctx):
    return phases.phase_ms(ctx.trace, "forward", ("backward",))
