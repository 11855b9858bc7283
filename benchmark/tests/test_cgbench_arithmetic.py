"""The metric arithmetic: the window's rate, the interval union, the launch
count with graph launches, the frozen kernel costs against their hand
counts, the FLOP count behind step.mfu, and the comparison's gaps."""
import pytest
import torch

from cgbench import compare, harness, profiling, registry
from cgbench.context import Context


def trace(kernels, host=(), wall=1.0, steps=1):
    return profiling.Trace(list(kernels), list(host), wall, steps)


def test_busy_time_is_the_union_of_device_intervals():
    t = trace([("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 2.0, 2.5), ("d", 2.1, 2.2)], wall=4.0)
    assert t.busy_s() == pytest.approx(2.0)
    assert registry.reader("device.idle_share")(ctx_of(t)) == pytest.approx(50.0)


def test_launches_count_graph_launches_and_kernel_launches_alone():
    host = [("cudaGraphLaunch", 0, 1), ("cudaLaunchKernel", 1, 2), ("cuLaunchKernelEx", 2, 3),
            ("cudaMemcpyAsync", 3, 4), ("aten::add", 4, 5), ("cudaGraphLaunch", 5, 6)]
    t = trace([("k", 0, 1)], host, steps=2)
    assert t.launches() == 4
    assert registry.reader("epoch.host_launches_per_step")(ctx_of(t)) == 2.0


def test_idle_gaps_are_labelled_by_the_host_call_that_covers_them():
    t = trace([("k", 0.0, 1.0), ("k", 3.0, 4.0)], [("cudaStreamSynchronize", 0.5, 3.2)])
    assert t.idle_gaps() == [["cudaStreamSynchronize", pytest.approx(2.0)]]


@pytest.mark.parametrize("kind,s,n_bytes,flops", [
    ("message", 3, 4 * 34, 2 * 16 + 12),
    ("message", 4, 4 * 38, 2 * 23 + 16 + 2 * 12),
    ("message_vjp", 4, 4 * 60, 36 + 2 * 45 + 2 * 33),
    ("pseudo", 9, 4 * 76, 36 + 2 * 64 + 2 * 57),
    ("pseudo_vjp", 9, 4 * 128, 81 + 2 * 161 + 2 * 88),
])
def test_kernel_cost_matches_the_hand_count(kind, s, n_bytes, flops):
    # B 1, N 2, F 1, R 1, one unordered pair: the port's hand counts
    # (tests/test_torch_chip_smoke.py, commit add70c80)
    assert profiling.kernel_cost(kind, 1, 2, s, 1, 1, pairs=2) == (n_bytes, flops)


def test_bound_of_the_encoder_backward_at_bench_size():
    n_bytes, flops = profiling.kernel_cost("message_vjp", 128, 27, 3, 600, 8, 128 * 702)
    assert flops == 600 * 128 * (351 * 111 + 702 * 25 + 27 * 3)
    assert profiling.bound(n_bytes, flops) == pytest.approx(0.0649e-3, abs=1e-7)


def ctx_of(t, flops=None, chips=1):
    cell = registry.resolve("dip_dense.train_b128")
    return Context(t, cell.config, cell.traffic, chips, None, flops)


def test_mfu_is_the_model_flops_over_the_window_at_the_bf16_peak():
    t = trace([("k", 0, 1)], wall=2.0, steps=10)
    value = registry.reader("step.mfu")(ctx_of(t, flops=989e12 * 0.01, chips=4))
    assert value == pytest.approx(100 * 989e10 * 10 / (2.0 * 989e12 * 4))


def test_flop_counter_counts_a_dense_forward_and_backward():
    from torch.utils.flop_counter import FlopCounterMode

    from cgbench.reference.layers import Dense

    layer = Dense(8, 5, dtype=torch.float32)
    torch.nn.init.normal_(layer.weight)
    torch.nn.init.zeros_(layer.bias)
    x = torch.randn(3, 8, requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        layer(x).sum().backward()
    # forward 2 m n k; backward the input's and the weight's gradients
    assert counter.get_total_flops() == 3 * 2 * 3 * 5 * 8


def test_roofline_shares_sum_bounds_over_kernel_time(tiny_root):
    cell = registry.resolve("dip_dense.train_b32", tiny_root)
    frames = harness.Inputs(cell, 3).frames
    kernels = [("void cgvae::fused_message_kernel<5, 3>", 0.0, 1e-3),
               ("void cgvae::fused_pseudo_bwd_kernel<5, 3>", 1e-3, 3e-3), ("other", 3e-3, 4e-3)]
    ctx = Context(trace(kernels, steps=2), cell.config, cell.traffic, 1, frames, None)
    c, b = cell.config, cell.traffic["batch_size"]
    msg = sum(c["enc_nconv"] * profiling.bound(*profiling.kernel_cost(
        kind, b, nodes, 3, c["n_basis"], c["n_rbf"],
        int(round(b * ctx.pairs_per_frame(level, c["cg_cutoff"])))))
        for nodes, level in ((27, "atoms"), (3, "beads")) for kind in ("message", "message_vjp"))
    assert registry.reader("kernels.message.roofline_share")(ctx) == pytest.approx(
        100 * msg * 2 / 1e-3)
    assert registry.reader("kernels.pseudo.roofline_share")(ctx) > 0
    assert registry.reader("parallel.allreduce_ms_per_step")(ctx) is None


def test_pairs_count_the_ordered_pairs_inside_the_cutoff():
    import numpy as np

    from cgbench.frames import pair_counts

    xyz = np.array([[[0, 0, 0], [1, 0, 0], [5, 0, 0]]], np.float32)
    assert pair_counts(xyz, 2.0).tolist() == [2]
    assert pair_counts(xyz, 6.0).tolist() == [6]


def fake_results(steps, window_s, peaks, starts):
    return [{"steps": steps, "window_s": window_s, "failed": 0, "peak": p, "window_start": s,
             "numbers": dict.fromkeys(compare.NUMBERS, 0.0), "kind": "x"}
            for p, s in zip(peaks, starts)]


def test_the_rate_is_every_frame_of_the_window_over_its_wall_time():
    cell = registry.resolve("dip_dense.train_b128.dp4")
    line, text = harness.compose(cell, fake_results(300, 4.0, [2e9, 3e9, 1e9, 2e9],
                                                    [10.0, 11.0, 10.5, 10.2]), False, 1.0)
    m = line["metrics"]
    assert m["train_samples_per_s"]["value"] == pytest.approx(300 * 128 / 4.0)
    assert m["peak_mem_gb"]["value"] == pytest.approx(3.0)
    assert m["setup_s"]["value"] == pytest.approx(10.0)
    assert line["correct"] is True and list(line)[-1] == "checks"
    assert text[0].startswith("check loss_gap")


def test_gaps_take_the_worst_leaf_against_the_median_leaf():
    ref = {"names": ["a", "b", "c"], "losses": [2.0, 1.0],
           "grad_norms": torch.tensor([1.0, 1e-6, 4.0], dtype=torch.float64),
           "exact_grad_norms": torch.tensor([1.0, 1e-6, 4.0], dtype=torch.float64),
           "change_norms": torch.tensor([2.0, 5.0, 2.0], dtype=torch.float64)}
    prog = {"names": ["c", "a", "b"], "losses": [2.002, 1.0],
            "grad_norms": torch.tensor([4.0, 1.1, 1e-3]),
            "change_norms": torch.tensor([2.0, 2.0, 0.0])}
    values = compare.numbers(prog, ref)
    assert values["loss_gap"] == pytest.approx(1e-3)
    # leaf b's gradient sits under the median's: its gap is read against the median (1.0)
    assert values["grad_gap"] == pytest.approx(0.1)
    # leaf b (a thousandth of the median gradient) is left out of the change
    assert values["change_gap"] == pytest.approx(0.0)
    assert compare.judge(values, {"loss_gap": 1e-2, "grad_gap": 0.2, "change_gap": 0.1})
    assert not compare.judge(dict(values, loss_gap=float("nan")),
                             {"loss_gap": 1e-2, "grad_gap": 0.2, "change_gap": 0.1})
