"""The fused optimizer step (``ops.fused_adam``) on the CPU: its chunk
table and the kernel's index arithmetic, emulated; its plain version
against the step as it was written before the kernel, bit for bit; the
wrapper's input checks. The CUDA kernel itself is compared with the plain
version on the card by tests/test_torch_gpu.py and by chip_smoke.py."""
import math

import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu_torch.ops import fused_adam as fa
from coarsegrainingvae_tpu_torch.train import trainer as tt

torch.set_num_threads(1)


# ------------------------------------------------- the table, emulated
def _layout(sizes, dtypes, shifts):
    """(address, numel, element size) of parameters laid out as separate
    allocations at 512-byte boundaries, each moved by its shift in elements
    (a parameter that is a view into a larger storage)."""
    out, addr = [], 1 << 20
    for n, dt, shift in zip(sizes, dtypes, shifts):
        size = 2 if dt == "bf16" else 4
        out.append((addr + shift * size, n, size))
        addr += -(-(n + shift) * size // 512) * 512
    return out


def _emulate_update(rows, vec=fa.VEC):
    """The flat offsets each chunk's threads touch, as fused_adam_update's
    loops compute them: VEC at a time over len // VEC groups when the
    chunk is VECTOR, then one at a time; with each vector group's flat
    offset and parameter address."""
    touched, groups = [], []
    for addr, flat, n, flags in rows:
        size = 2 if flags & fa.BF16 else 4
        n_vec = n // vec if flags & fa.VECTOR else 0
        for i in range(n_vec):
            groups.append((flat + i * vec, addr + i * vec * size))
            touched.extend(range(flat + i * vec, flat + (i + 1) * vec))
        touched.extend(range(flat + n_vec * vec, flat + n))
    return touched, groups


LAYOUTS = {
    "recipe-like": ([600 * 600, 600, 9 * 3 * 600, 100 * 600], ["f32", "f32", "bf16", "f32"],
                    [0, 0, 0, 0]),
    "odd sizes": ([1, 7, 13, 4099, fa.CHUNK + 5, 3, 2 * fa.CHUNK],
                  ["f32", "bf16", "f32", "bf16", "f32", "f32", "bf16"], [0] * 7),
    "views": ([17, 1000, fa.CHUNK + 9, 31], ["f32", "f32", "bf16", "bf16"], [0, 1, 3, 2]),
    "one element each": ([1] * 19, ["f32", "bf16"] * 9 + ["f32"], [0] * 19),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_chunk_table_covers_every_element_once_within_its_parameter(name):
    """Every flat element is touched exactly once; each chunk lies inside
    one parameter, at the flat offset that matches its address; heads are
    the only chunks that start off a multiple of VEC and hold fewer than
    VEC elements at a parameter's start; each vector group is VEC-aligned
    in the flat vectors and 16-byte aligned in its parameter."""
    params = _layout(*LAYOUTS[name])
    rows = fa.chunk_table(params)
    total = sum(n for _, n, _ in params)
    touched, groups = _emulate_update(rows)
    assert sorted(touched) == list(range(total))
    starts = np.cumsum([0] + [n for _, n, _ in params])
    for addr, flat, n, flags in rows:
        assert 0 < n <= fa.CHUNK
        k = int(np.searchsorted(starts, flat, side="right")) - 1
        p_addr, p_n, p_size = params[k]
        assert flat + n <= starts[k + 1]                       # inside one parameter
        assert addr == p_addr + (flat - starts[k]) * p_size
        assert bool(flags & fa.BF16) == (p_size == 2)
        if flat % fa.VEC:
            assert flat == starts[k] and n < fa.VEC and not flags & fa.VECTOR
    for flat, addr in groups:
        assert flat % fa.VEC == 0 and addr % 16 == 0
    # a parameter that is neither a view nor after an odd size goes in vectors
    if name == "recipe-like":
        assert all(flags & fa.VECTOR for *_, flags in rows)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 4 * 6 * 8 - 1, 4 * 6 * 8, 4 * 6 * 8 * 3 + 2, 1000])
@pytest.mark.parametrize("blocks,threads", [(2, 3), (4, 8)])
def test_norm_partials_visit_every_gradient_element_once(n, blocks, threads):
    """fused_adam_sq_partials' loops at a small grid: each thread's float4
    pairs (i, i + stride), its last single float4 and the scalar tail
    visit every element of g exactly once."""
    stride = blocks * threads
    n4 = n // 4
    seen = []
    for t in range(stride):
        i = t
        while i + stride < n4:
            seen += [*range(4 * i, 4 * i + 4), *range(4 * (i + stride), 4 * (i + stride) + 4)]
            i += 2 * stride
        if i < n4:
            seen += range(4 * i, 4 * i + 4)
        seen += range(4 * n4 + t, n, stride)
    assert sorted(seen) == list(range(n))


# --------------------------------- the plain version against the old step
def _old_guarded_update_flat(tx, params, g, loss, opt_state, lr, thresh):
    """``train.trainer.guarded_update_flat`` as it was before the fused
    step (one device, no ZeRO-1, no tensor parallelism), verbatim."""
    adam = tx.adam
    with torch.no_grad():
        g_norm = torch.sqrt(torch.sum(g * g))
        ok = torch.isfinite(loss) & (loss < thresh) & torch.isfinite(g_norm)
        clipped = torch.where(g_norm < tx.grad_clip, g, (g / g_norm) * tx.grad_clip)
        count = opt_state.count + 1
        c1 = 1.0 - adam.b1 ** count.to(torch.float32)
        c2 = 1.0 - adam.b2 ** count.to(torch.float32)
        m32 = adam.b1 * opt_state.mu.to(torch.float32) + (1.0 - adam.b1) * clipped
        n32 = adam.b2 * opt_state.nu.to(torch.float32) + (1.0 - adam.b2) * (clipped * clipped)
        upd = (m32 / c1) / (torch.sqrt(n32 / c2) + adam.eps)
        upd = torch.where(ok, -lr * upd, 0.0)
        updates = [u.view_as(p) for u, p in zip(
            torch.split(upd, [p.numel() for p in params]), params)]
        same = [(p, u) for p, u in zip(params, updates) if p.dtype == u.dtype]
        if same:
            torch._foreach_add_([p for p, _ in same], [u for _, u in same])
        for p, u in zip(params, updates):
            if p.dtype != u.dtype:
                p.add_(u)
        return tt.AdamState(count=torch.where(ok, count, opt_state.count),
                            mu=torch.where(ok, m32.to(adam.moment_dtype), opt_state.mu),
                            nu=torch.where(ok, n32.to(adam.moment_dtype), opt_state.nu)), ok


def _problem(seed, moment_dtype, steps_done=3):
    """Parameters of odd sizes in f32 and bf16, a flat f32 gradient, moments
    and a count as after a few steps, lr as a 0-d tensor."""
    rng = np.random.default_rng(seed)
    sizes = [5, 600, 17, 1203, 8]
    dtypes = [torch.float32, torch.bfloat16, torch.float32, torch.float32, torch.bfloat16]
    params = [torch.tensor(rng.normal(size=n), dtype=torch.float32).to(dt)
              for n, dt in zip(sizes, dtypes)]
    n = sum(sizes)
    g = torch.tensor(rng.normal(scale=0.05, size=n), dtype=torch.float32)
    mu = torch.tensor(rng.normal(scale=0.01, size=n), dtype=torch.float32).to(moment_dtype)
    nu = torch.tensor(rng.uniform(0, 1e-4, size=n), dtype=torch.float32).to(moment_dtype)
    state = tt.AdamState(count=torch.tensor(steps_done, dtype=torch.int32), mu=mu, nu=nu)
    return params, g, state, torch.tensor(3.2e-4, dtype=torch.float32)


CLIPS = {"active": 0.01, "inactive": 1e3, "infinite": math.inf}
LOSSES = {"accepted": 1.0, "at the threshold": 5000.0, "nan": math.nan}


@pytest.mark.parametrize("loss", list(LOSSES))
@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_plain_step_equals_the_old_step_bit_for_bit(moments, clip, loss):
    """``guarded_update_flat`` on the CPU (``fused_adam_reference``) gives
    the old step's parameters, moments, count and ok bit for bit, clip
    active, inactive and infinite, accepted and rejected; the state passed
    in is left untouched, as the plain path promises."""
    tx = tt.make_optimizer(CLIPS[clip], moments)
    runs = []
    for fn in (_old_guarded_update_flat, tt.guarded_update_flat):
        params, g, state, lr = _problem(0, tx.adam.moment_dtype)
        before = [t.clone() for t in (state.count, state.mu, state.nu)]
        new, ok = fn(tx, params, g, torch.tensor(LOSSES[loss]), state, lr, 5000.0)
        for t, b in zip((state.count, state.mu, state.nu), before):
            assert torch.equal(t, b)
        assert new.mu is not state.mu and new.count is not state.count
        runs.append((params, new, ok))
    (p_old, s_old, ok_old), (p_new, s_new, ok_new) = runs
    assert bool(ok_old) == bool(ok_new) == (loss == "accepted")
    for a, b in zip(p_old, p_new):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for f in ("count", "mu", "nu"):
        a, b = getattr(s_old, f), getattr(s_new, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


def test_plain_step_rejects_an_inf_gradient_and_keeps_every_bit():
    """An inf in the gradient: ok is false, parameters and moments keep
    their bits, the count stays."""
    tx = tt.make_optimizer(0.01, "bfloat16")
    params, g, state, lr = _problem(1, torch.bfloat16)
    g[7] = math.inf
    before = [p.clone() for p in params]
    new, ok = tt.guarded_update_flat(tx, params, g, torch.tensor(1.0), state, lr, 5000.0)
    assert not bool(ok) and int(new.count) == 3
    assert torch.equal(new.mu, state.mu) and torch.equal(new.nu, state.nu)
    for a, b in zip(params, before):
        assert torch.equal(a, b)


def test_global_norm_on_the_cpu_is_the_plain_sum():
    g = torch.tensor(np.random.default_rng(2).normal(size=1001), dtype=torch.float32)
    assert torch.equal(tt.global_norm(g), torch.sqrt(torch.sum(g * g)))


def test_bytes_of_the_recipe_step():
    """24 B/P for f32 parameters and bf16 moments, 32 with the flat
    gradient's concatenation."""
    params = [torch.empty(1000), torch.empty(24)]
    assert fa.kernel_bytes(params, torch.bfloat16, flat_gradient=False) == 24 * 1024
    assert fa.kernel_bytes(params, torch.bfloat16) == 32 * 1024
    assert fa.kernel_bytes(params, torch.float32, flat_gradient=False) == 32 * 1024


# ------------------------------------------------------ the input checks
def _good(moment_dtype=torch.bfloat16):
    params, g, state, lr = _problem(3, moment_dtype)
    return dict(params=params, g=g, loss=torch.tensor(1.0), count=state.count, mu=state.mu,
                nu=state.nu, lr=lr)


BAD = {
    "g float64": lambda a: dict(a, g=a["g"].double()),
    "g 2-D": lambda a: dict(a, g=a["g"].view(1, -1)),
    "g unaligned": lambda a: dict(a, g=torch.cat([torch.zeros(1), a["g"]])[1:]),
    "g too short": lambda a: dict(a, g=a["g"][:-8].clone()),
    "mu float16": lambda a: dict(a, mu=a["mu"].half()),
    "nu another dtype": lambda a: dict(a, nu=a["nu"].float()),
    "nu too long": lambda a: dict(a, nu=torch.zeros(a["nu"].numel() + 8, dtype=a["nu"].dtype)),
    "count int64": lambda a: dict(a, count=a["count"].long()),
    "loss float64": lambda a: dict(a, loss=a["loss"].double()),
    "lr a float": lambda a: dict(a, lr=3e-4),
    "lr two entries": lambda a: dict(a, lr=torch.zeros(2)),
    "a float64 parameter": lambda a: dict(a, params=[a["params"][0].double()] + a["params"][1:]),
    "a strided parameter": lambda a: dict(
        a, params=[torch.zeros(10)[::2]] + a["params"][1:]),
}


@pytest.mark.parametrize("name", list(BAD))
def test_wrapper_rejects_inputs_the_kernel_does_not_take(name):
    fa.check_inputs(**_good())
    with pytest.raises((ValueError, TypeError)):
        fa.check_inputs(**BAD[name](_good()))


def test_the_epoch_program_counts_the_fused_step_among_its_kernels():
    """The optimizer's counts are among the ledger's (``ops.LAUNCHES``), so an
    epoch program's per-replay launches show whether the step took it."""
    from coarsegrainingvae_tpu_torch.ops import KERNELS, LAUNCHES

    assert {"fused_adam", "fused_global_norm"} <= set(KERNELS)
    assert all(isinstance(LAUNCHES[k], int) for k in ("fused_adam", "fused_global_norm"))


@pytest.mark.parametrize("name", ["pcn float32", "pcn bfloat16", "diffpool", "baseline"])
def test_eager_trainers_hand_the_fused_step_inputs_it_takes(name, monkeypatch):
    """The PCN, DiffPool and baseline steps keep their learning rate on the
    host as a number; on a card their one step a batch is the fused
    kernel, which raises on inputs it does not take. Here their step hands
    ``fused_adam`` exactly once what the kernel's checks accept, with the
    number turned into the tensor the wrapper makes of it."""
    calls = []

    def checked(params, g, loss, count, mu, nu, lr, *rest):
        fa.check_inputs(list(params), g, loss, count, mu, nu, fa.lr_tensor(lr, g.device))
        calls.append(isinstance(lr, float))
        return fa.fused_adam(params, g, loss, count, mu, nu, lr, *rest)

    from test_torch_gpu import EAGER_STEPS

    state, step = EAGER_STEPS[name](torch.device("cpu"))
    monkeypatch.setattr(tt, "fused_adam", checked)
    step(state)
    assert calls == [True]


def test_a_learning_rate_number_becomes_the_kernels_float32_tensor():
    lr = fa.lr_tensor(3.2e-4, torch.device("cpu"))
    assert lr.dtype == torch.float32 and lr.dim() == 0
    assert float(lr) == float(torch.tensor(3.2e-4, dtype=torch.float32))
    assert fa.lr_tensor(lr, torch.device("cpu")) is lr
