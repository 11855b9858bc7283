"""step.decode_ms: device milliseconds per traced step of the dense model's
decoder (its message and update layers and the channel lift), read from the
program's own marks inside the forward phase: the start of each
``cgvae_mark_decode`` to the start of the next ``cgvae_mark_loss`` (rank
0's), mean over the steps. None where the program has no such marks."""
from cgbench import parts


def read(ctx):
    return parts.part_ms(ctx.trace, "decode", "loss")
