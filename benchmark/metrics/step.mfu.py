"""step.mfu: the whole step's share of the chips' peak, in %: the model's
FLOPs per step (forward and backward, no recompute, as
``torch.utils.flop_counter`` counts them over one step of the plain
reference at the cell's shapes; on several chips the global batch's) times
the traced steps, over the traced window's seconds times the chips' dense
bf16 peak (989 TFLOP/s each, the configuration's matmul dtype)."""


def read(ctx):
    t = ctx.trace
    if not ctx.flops_per_step or t.steps == 0:
        return None
    return 100.0 * ctx.flops_per_step * t.steps / (t.wall_s * ctx.peaks.BF16_FLOP_PER_S * ctx.chips)
