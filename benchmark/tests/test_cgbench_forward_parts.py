"""The readers of the chignolin cell's new per-layer metrics on built
traces: ``kernels.message_cross.roofline_share`` (kernels 1-2 over every use
the dense model makes of them: the cross decoder's S = 4 launches counted
only for it), and ``step.decode_ms`` / ``step.loss_ms`` (the marks inside
the forward phase); each gives None where the program has no such marks."""
import sys

import pytest

from cgbench import frames as fr, registry
from cgbench.context import Context
from cgbench.profiling import Trace, bound, kernel_cost
from coarsegrainingvae_tpu_torch.utils import tracing

US = 1e-6
STEP_S = 0.01
CHIG = "chig_dense.train_b16"


def _cell_ctx(name, trace, **changes):
    cell = registry.resolve(name)
    cfg = dict(cell.config, **changes)
    frames = fr.make_frames(cfg["molecule"], cell.traffic["frames"], 8, 5)
    return Context(trace, cfg, cell.traffic, cell.chips, frames, None)


def _kernel_trace(steps=2, seconds=0.02):
    """``fused_message`` forward and backward kernels of ``seconds`` in
    all, and one unrelated kernel that must not count."""
    kernels = [("fused_message_fwd_kernel", 0.0, seconds / 2),
               ("fused_message_bwd_kernel", 0.1, 0.1 + seconds / 2),
               ("other_kernel", 0.2, 0.5)]
    return Trace(kernels, [], 1.0, steps)


def _bounds(ctx, launches, nodes, level, cutoff, s):
    c, b = ctx.config, ctx.rows_per_chip
    pairs = int(round(b * ctx.pairs_per_frame(level, cutoff)))
    return launches * sum(bound(*kernel_cost(kind, b, nodes, s, c["n_basis"], c["n_rbf"], pairs))
                          for kind in ("message", "message_vjp"))


def test_the_cross_decoders_s4_launches_are_counted_for_it_alone():
    t = _kernel_trace()
    read = registry.reader("kernels.message_cross.roofline_share")
    cross = _cell_ctx(CHIG, t)
    c = cross.config
    n, m = len(c["molecule"]["z"]), c["n_cgs"]
    encoder_prior = (_bounds(cross, c["enc_nconv"], n, "atoms", c["cg_cutoff"], 3)
                     + _bounds(cross, c["enc_nconv"], m, "beads", c["cg_cutoff"], 3))
    decoder = _bounds(cross, c["dec_nconv"], m, "beads", c["atom_cutoff"], 4)
    assert read(cross) == pytest.approx(100.0 * (encoder_prior + decoder) * t.steps / 0.02)
    painn = _cell_ctx(CHIG, t, dec_type="painn")
    decoder_s3 = _bounds(painn, c["dec_nconv"], m, "beads", c["atom_cutoff"], 3)
    assert 0 < decoder_s3 < decoder
    assert read(painn) == pytest.approx(100.0 * (encoder_prior + decoder_s3) * t.steps / 0.02)
    pseudo = _cell_ctx(CHIG, t, dec_type="pseudo")
    assert read(pseudo) == pytest.approx(100.0 * encoder_prior * t.steps / 0.02)
    assert read(pseudo) == pytest.approx(registry.reader("kernels.message.roofline_share")(pseudo))


@pytest.mark.parametrize("name", ["dip_dense.train_b128", "dip_dense.train_b32"])
def test_with_the_pseudo_decoder_it_reads_what_the_message_share_reads(name):
    ctx = _cell_ctx(name, _kernel_trace(steps=3, seconds=0.01))
    assert ctx.config["dec_type"] == "pseudo"
    got = registry.reader("kernels.message_cross.roofline_share")(ctx)
    assert got == pytest.approx(registry.reader("kernels.message.roofline_share")(ctx))
    assert registry.reader("kernels.message_cross.roofline_share")(
        _cell_ctx(name, Trace([("other_kernel", 0.0, 1.0)], [], 1.0, 3))) is None


# the work after each mark, in us: the forward phase holds the encoder and
# prior (after forward), the decoder (after decode) and the loss (after loss)
WORK = {"step": 8, "forward": 40, "decode": 30, "loss": 17, "backward": 197, "optimizer": 97,
        "bookkeeping": 7}
ORDER = ["step", "forward", "decode", "loss", "backward", "optimizer", "bookkeeping", "end"]


def _marked_trace(n=3, order=ORDER):
    kernels = []
    for i in range(n):
        t = 1.0 + i * STEP_S
        for mark in order:
            kernels.append((tracing.kernel_name(mark), t, t + US))
            t += 2 * US
            if mark in WORK:
                kernels.append((f"kernel_after_{mark}", t, t + WORK[mark] * US))
                t += (WORK[mark] + 1) * US
    return Trace(kernels, [], n * STEP_S, n)


def _read(metric, trace):
    return registry.reader(metric)(Context(trace, {}, {"batch_size": 16}, 1, None, None))


def test_part_readers_measure_mark_to_mark_inside_the_forward_phase():
    t = _marked_trace()
    assert _read("step.decode_ms", t) == pytest.approx(0.033)     # 1 + 1 + 30 + 1 us
    assert _read("step.loss_ms", t) == pytest.approx(0.020)       # 1 + 1 + 17 + 1 us
    # the forward phase still runs from forward to backward, the parts in it
    assert _read("step.forward_ms", t) == pytest.approx(0.043 + 0.033 + 0.020)
    assert _read("step.backward_ms", t) == pytest.approx(0.200)


def test_a_model_without_a_decode_mark_reads_its_loss_alone():
    t = _marked_trace(order=[m for m in ORDER if m != "decode"])
    assert _read("step.decode_ms", t) is None
    assert _read("step.loss_ms", t) == pytest.approx(0.020)


def test_part_readers_give_none_without_the_marks(monkeypatch):
    plain = _marked_trace(order=[m for m in ORDER if m not in ("decode", "loss")])
    assert _read("step.decode_ms", plain) is None and _read("step.loss_ms", plain) is None
    # a program from before the forward phase's marks
    monkeypatch.delattr(tracing, "FORWARD_MARKS")
    assert _read("step.decode_ms", _marked_trace()) is None
    assert _read("step.loss_ms", _marked_trace()) is None
    # a program from before any marks: no utils/tracing.py to import
    monkeypatch.setitem(sys.modules, "coarsegrainingvae_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(sys.modules["coarsegrainingvae_tpu_torch.utils"], "tracing")
    assert _read("step.decode_ms", _marked_trace()) is None
