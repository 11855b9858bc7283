"""kernels.message.roofline_share: kernels 1-2 (``fused_message`` forward
and backward), in %: the sum of their launches' roofline bounds over the sum
of the device time of every ``fused_message`` kernel in the traced window.
Per step the dense model launches each once per encoder layer on the atoms
(N atoms, the CG cutoff) and once per prior layer on the beads (M beads, the
CG cutoff), S = 3; ``pairs`` of a launch is its batch rows times the mean
ordered pairs per frame within the cutoff."""
from cgbench.profiling import bound, kernel_cost


def read(ctx):
    t = ctx.trace
    seconds, found = t.seconds_where(lambda name: "fused_message" in name)
    if not found or t.steps == 0:
        return None
    c, b = ctx.config, ctx.rows_per_chip
    n, m = len(c["molecule"]["z"]), c["n_cgs"]
    per_step = 0.0
    for nodes, level in ((n, "atoms"), (m, "beads")):
        pairs = int(round(b * ctx.pairs_per_frame(level, c["cg_cutoff"])))
        for kind in ("message", "message_vjp"):
            per_step += c["enc_nconv"] * bound(*kernel_cost(kind, b, nodes, 3, c["n_basis"],
                                                            c["n_rbf"], pairs))
    return 100.0 * per_step * t.steps / seconds
