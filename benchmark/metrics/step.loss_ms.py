"""step.loss_ms: device milliseconds per traced step of ``vae_loss``'s
forward (recon, KL, graph and, where zeta is set, the steric term), read from
the program's own marks: the start of each ``cgvae_mark_loss`` to the start
of the next ``cgvae_mark_backward`` (rank 0's), mean over the steps. None
where the program has no such mark."""
from cgbench import parts


def read(ctx):
    return parts.part_ms(ctx.trace, "loss", "backward")
