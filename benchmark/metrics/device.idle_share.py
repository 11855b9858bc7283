"""device.idle_share: the share of the traced window, in %, in which no
operation ran on the device (rank 0's): 1 - the union of the device
intervals over the window's wall time."""


def read(ctx):
    t = ctx.trace
    if not t.kernels or t.wall_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.wall_s)
