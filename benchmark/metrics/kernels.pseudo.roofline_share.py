"""kernels.pseudo.roofline_share: kernels 3-4 (``fused_pseudo`` forward and
backward), in %: the sum of their launches' roofline bounds over the sum of
the device time of every ``fused_pseudo`` kernel in the traced window. Per
step the pseudo decoder launches each once per decoder layer on the beads
(M beads, the atom cutoff); ``pairs`` as for the message kernels."""
from cgbench.profiling import bound, kernel_cost


def read(ctx):
    t = ctx.trace
    seconds, found = t.seconds_where(lambda name: "fused_pseudo" in name)
    if not found or t.steps == 0:
        return None
    c, b = ctx.config, ctx.rows_per_chip
    pairs = int(round(b * ctx.pairs_per_frame("beads", c["atom_cutoff"])))
    per_step = sum(c["dec_nconv"] * bound(*kernel_cost(kind, b, c["n_cgs"], 9, c["n_basis"],
                                                       c["n_rbf"], pairs))
                   for kind in ("pseudo", "pseudo_vjp"))
    return 100.0 * per_step * t.steps / seconds
