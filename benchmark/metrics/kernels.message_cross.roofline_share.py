"""kernels.message_cross.roofline_share: kernels 1-2 (``fused_message``
forward and backward) over every use the dense model makes of them, in %:
the sum of their launches' roofline bounds over the sum of the device time
of every ``fused_message`` kernel in the traced window. Per step
``models/dense_cgvae.py::DenseCGVAE`` launches each once per encoder layer
on the atoms (``enc_msgs``: N atoms, the CG cutoff, S = 3), once per prior
layer on the beads (``prior_msgs``: M beads, the CG cutoff, S = 3) and, with
a decoder other than the pseudo one, once per decoder layer on the beads
(``dec_msgs``: the atom cutoff, S = 4 for the cross decoder, 3 for painn).
``pairs`` of a launch is its batch rows times the mean ordered pairs per
frame within the cutoff. With the pseudo decoder it reads what
``kernels.message.roofline_share`` reads."""
from cgbench.profiling import bound, kernel_cost


def uses(c: dict) -> list:
    """(launches per step, nodes, level, cutoff, S) of each use of kernels
    1-2 by the dense model of configuration ``c``."""
    n, m = len(c["molecule"]["z"]), c["n_cgs"]
    out = [(c["enc_nconv"], n, "atoms", c["cg_cutoff"], 3),
           (c["enc_nconv"], m, "beads", c["cg_cutoff"], 3)]
    if c["dec_type"] != "pseudo":
        out.append((c["dec_nconv"], m, "beads", c["atom_cutoff"],
                    4 if c["dec_type"] == "cross" else 3))
    return out


def read(ctx):
    t = ctx.trace
    seconds, found = t.seconds_where(lambda name: "fused_message" in name)
    if not found or t.steps == 0:
        return None
    c, b = ctx.config, ctx.rows_per_chip
    per_step = 0.0
    for launches, nodes, level, cutoff, s in uses(c):
        pairs = int(round(b * ctx.pairs_per_frame(level, cutoff)))
        for kind in ("message", "message_vjp"):
            per_step += launches * bound(*kernel_cost(kind, b, nodes, s, c["n_basis"],
                                                      c["n_rbf"], pairs))
    return 100.0 * per_step * t.steps / seconds
