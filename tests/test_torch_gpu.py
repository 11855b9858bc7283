"""The port's CUDA kernels, forward and backward, against their plain
PyTorch versions on the card, and one train step on the card against the
same step on the CPU.

This file imports no JAX, so it runs on a machine with a GPU and no JAX
(``--noconftest`` skips tests/conftest.py, which configures JAX):

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Without a CUDA device every test skips: the kernels are CUDA C++ for
sm_90a and have no CPU or interpret mode (their plain versions and plain
VJPs are held against the JAX package by tests/test_torch_kernels.py).
"""
import pytest
import torch

from coarsegrainingvae_tpu_torch.config import ModelConfig
from coarsegrainingvae_tpu_torch.data.batch import CGBatch
from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
from coarsegrainingvae_tpu_torch.ops.fused_message import (
    fused_message,
    fused_message_vjp,
    message_reference,
    message_vjp_reference,
)
from coarsegrainingvae_tpu_torch.ops.fused_pseudo import (
    fused_pseudo_message,
    fused_pseudo_vjp,
    pseudo_reference,
    pseudo_vjp_reference,
)

torch.set_num_threads(1)

B, F, R, CUT = 3, 24, 6, 9.0
TOL = dict(rtol=1e-4, atol=1e-5)


def _message_inputs(n, s, seed, device, f=F, r=R, b=B):
    """The last node masked in every batch element and, with b > 1, every
    node of the last batch element."""
    g = torch.Generator().manual_seed(seed)
    xyz = torch.randn(b, n, 3, generator=g) * 3.0
    mask = torch.ones(b, n)
    mask[:, -1] = 0.0
    if b > 1:
        mask[-1] = 0.0
    args = (xyz, mask, torch.randn(b, n, s, f, generator=g),
            torch.randn(b, n, 3, f, generator=g), torch.randn(r + 1, s, f, generator=g) * 0.3)
    return [a.to(device) for a in args]


def _pseudo_inputs(m, seed, device, f=F, r=R, b=B):
    """The last node masked in every batch element and, with b > 1, every
    node of the last batch element."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones(b, m)
    mask[:, -1] = 0.0
    if b > 1:
        mask[-1] = 0.0
    args = (torch.randn(b, m, 3, generator=g) * 3.0, mask,
            torch.randn(b, m, 9, f, generator=g), torch.randn(b, m, f, generator=g),
            torch.randn(b, m, f, generator=g), torch.randn(b, m, 3, f, generator=g),
            torch.randn(b, m, 3, f, generator=g), torch.randn(r + 1, 9, f, generator=g) * 0.3)
    return [a.to(device) for a in args]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a "
                    "and have no CPU or interpret mode")
    return torch.device("cuda")


def _close_rel(out, ref, rtol=1e-4):
    """max |kernel - plain| <= rtol * max |plain|, per output (f32, another
    order of summation; d_w also sums over the batch in another order)."""
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= rtol * float(b.abs().max())


# node counts at the kernels' edges: one node, the encoder's 27 (one tile),
# one 32-partner chunk exactly and one past it, several chunks and tiles (70),
# and the chignolin cross decoder's 209
NODE_COUNTS = [1, 3, 11, 27, 32, 33, 70, 209]


@pytest.mark.gpu
@pytest.mark.parametrize("n,s", [(n, s) for n in NODE_COUNTS for s in (3, 4)])
def test_message_kernel_matches_plain_on_card(cuda_device, n, s):
    args = _message_inputs(n, s, 5, cuda_device)
    before = fused_message.launches
    out = fused_message(*args, CUT, R)
    torch.cuda.synchronize()
    assert fused_message.launches == before + 1
    for a, b in zip(out, message_reference(*args, CUT, R)):
        torch.testing.assert_close(a, b, **TOL)
    # masked receivers, the whole last batch element among them, get exact zeros
    masked = args[1] == 0
    assert float(out[0][masked].abs().max()) == 0.0 and float(out[1][masked].abs().max()) == 0.0


# (M, F, n_rbf) of the pseudo kernels: M from one bead through the register
# path's bound of 6 (3 and 6 instantiated, 2 and 4 predicated) to its first
# chunked M, 7, and past one 64-partner chunk, 70; the decoder's width; F not
# a multiple of 32; the templated R+1 at its ends
PSEUDO_CASES = ([(m, F, R) for m in (1, 2, 3, 4, 6, 7, 70)]
                + [(3, 600, 8), (6, 600, 8), (3, 40, 1), (6, 40, 15), (7, 40, 15), (70, 40, 1)])


@pytest.mark.gpu
@pytest.mark.parametrize("m,f,r", PSEUDO_CASES)
def test_pseudo_kernel_matches_plain_on_card(cuda_device, m, f, r):
    args = _pseudo_inputs(m, 6, cuda_device, f=f, r=r)
    before = fused_pseudo_message.launches
    out = fused_pseudo_message(*args, CUT, r)
    torch.cuda.synchronize()
    assert fused_pseudo_message.launches == before + 1
    for a, b in zip(out, pseudo_reference(*args, CUT, r)):
        torch.testing.assert_close(a, b, **TOL)
    # masked receivers, the whole last batch element among them, get exact zeros
    masked = args[1] == 0
    for t in out:
        assert float(t[masked].abs().max()) == 0.0


def _cotangents(like, seed, device):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(t.shape, generator=g).to(device) for t in like]


@pytest.mark.gpu
@pytest.mark.parametrize("n", NODE_COUNTS)
@pytest.mark.parametrize("s", [3, 4])
def test_message_vjp_kernel_matches_plain_on_card(cuda_device, n, s):
    args = _message_inputs(n, s, 8, cuda_device)
    gs, gv = _cotangents(message_reference(*args, CUT, R), 9, cuda_device)
    before = fused_message_vjp.launches
    out = fused_message_vjp(*args, gs, gv, CUT, R)
    torch.cuda.synchronize()
    assert fused_message_vjp.launches == before + 1
    ref = message_vjp_reference(*args, gs, gv, CUT, R)
    _close_rel(out, ref)
    # masked nodes, the whole last batch element among them, get no gradient
    masked = args[1] == 0
    assert float(out[0][masked].abs().max()) == 0.0
    assert float(out[1][masked].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,r", [(27, 600, 8),    # the encoder's full width
                                   (27, 40, 8),     # F not a multiple of 32 features
                                   (33, 70, 1),     # the templated R+1 at its ends
                                   (27, 24, 15),
                                   (70, 33, 15)])
@pytest.mark.parametrize("s", [3, 4])
def test_message_kernels_at_width_and_basis_edges_on_card(cuda_device, n, f, r, s):
    args = _message_inputs(n, s, 14, cuda_device, f=f, r=r, b=2)
    out = fused_message(*args, CUT, r)
    ref = message_reference(*args, CUT, r)
    _close_rel(out, ref)
    gs, gv = _cotangents(ref, 15, cuda_device)
    _close_rel(fused_message_vjp(*args, gs, gv, CUT, r),
               message_vjp_reference(*args, gs, gv, CUT, r))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [27, 70])
def test_message_vjp_weight_gradient_is_bit_identical_on_card(cuda_device, n):
    """No atomics and a fixed order of summation: two launches on the same
    inputs give the same d_w, bit for bit."""
    args = _message_inputs(n, 3, 16, cuda_device, f=600, r=8, b=16)
    gs, gv = _cotangents(message_reference(*args, CUT, 8), 17, cuda_device)
    first = fused_message_vjp(*args, gs, gv, CUT, 8)
    second = fused_message_vjp(*args, gs, gv, CUT, 8)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("m,f,r", PSEUDO_CASES)
def test_pseudo_vjp_kernel_matches_plain_on_card(cuda_device, m, f, r):
    args = _pseudo_inputs(m, 10, cuda_device, f=f, r=r)
    cts = _cotangents(pseudo_reference(*args, CUT, r), 11, cuda_device)
    before = fused_pseudo_vjp.launches
    out = fused_pseudo_vjp(*args, *cts, CUT, r)
    torch.cuda.synchronize()
    assert fused_pseudo_vjp.launches == before + 1
    _close_rel(out, pseudo_vjp_reference(*args, *cts, CUT, r))
    # masked nodes, the whole last batch element among them, get no gradient
    masked = args[1] == 0
    for grad in out[:5]:
        assert float(grad[masked].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("m,b", [(3, 128), (6, 64), (70, 8)])
def test_pseudo_vjp_weight_gradient_is_bit_identical_on_card(cuda_device, m, b):
    """No atomics and a fixed order of summation (one partial per frame
    group, or per batch element past M 6): two launches on the same inputs
    give the same d_w, bit for bit."""
    args = _pseudo_inputs(m, 18, cuda_device, f=600, r=8, b=b)
    g = torch.Generator().manual_seed(19)
    cts = [torch.randn(t.shape, generator=g).to(cuda_device)
           for t in (args[3], args[4], args[5], args[6])]
    first = fused_pseudo_vjp(*args, *cts, CUT, 8)
    second = fused_pseudo_vjp(*args, *cts, CUT, 8)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_autograd_runs_both_kernels_on_card(cuda_device):
    """Backward through the wrappers launches the backward kernels, and a
    non-contiguous upstream gradient is accepted."""
    margs = _message_inputs(11, 4, 12, cuda_device)
    for t in margs[2:]:
        t.requires_grad_(True)
    before = (fused_message.launches, fused_message_vjp.launches)
    ds, dv = fused_message(*margs, CUT, R)
    (ds.sum() + dv.transpose(2, 3).square().sum()).backward()
    assert (fused_message.launches, fused_message_vjp.launches) == (before[0] + 1, before[1] + 1)
    cpu = [t.detach().cpu().requires_grad_(t.requires_grad) for t in margs]
    ds, dv = fused_message(*cpu, CUT, R)
    (ds.sum() + dv.transpose(2, 3).square().sum()).backward()
    _close_rel([t.grad.cpu() for t in margs[2:]], [t.grad for t in cpu[2:]])

    pargs = _pseudo_inputs(3, 13, cuda_device)
    for t in pargs[2:]:
        t.requires_grad_(True)
    before = fused_pseudo_vjp.launches
    ds, dsbar, dv, dvbar = fused_pseudo_message(*pargs, CUT, R)
    (ds.sum() + dv.square().sum()).backward()       # dsbar and dvbar unused
    assert fused_pseudo_vjp.launches == before + 1


@pytest.mark.gpu
def test_wrappers_reject_bad_inputs_on_card(cuda_device):
    args = _message_inputs(5, 3, 7, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        fused_message(*args[:2], args[2].double(), *args[3:], CUT, R)
    with pytest.raises(ValueError, match="contiguous"):
        fused_message(*args[:3], args[3].transpose(1, 3).contiguous().transpose(1, 3), args[4], CUT, R)
    with pytest.raises(ValueError, match="shape"):
        fused_message(*args[:4], args[4][:, :, :-1].contiguous(), CUT, R)


@pytest.mark.gpu
def test_generate_on_card_matches_cpu(cuda_device):
    """A small DenseCGVAE, pseudo and cross decoders: the card (kernels)
    against the CPU (plain versions), same parameters and eps."""
    for dec_type in ("pseudo", "cross"):
        cfg = ModelConfig(n_cgs=3, n_basis=F, n_rbf=R, enc_nconv=2, dec_nconv=2,
                          dec_type=dec_type, breaksym=True, compute_dtype="float32")
        cpu = DenseCGVAE(cfg, generator=torch.Generator().manual_seed(0)).eval()
        gpu = DenseCGVAE(cfg, generator=torch.Generator().manual_seed(0)).to(cuda_device).eval()
        g = torch.Generator().manual_seed(1)
        n, b = 9, 4
        mapping = torch.arange(n) % 3
        batch = CGBatch(z=torch.randint(1, 9, (b, n), generator=g), xyz=torch.zeros(b, n, 3),
                        atom_mask=torch.ones(b, n, dtype=torch.bool),
                        cg_z=torch.arange(3).expand(b, 3), cg_xyz=torch.randn(b, 3, 3, generator=g) * 3,
                        cg_mask=torch.ones(b, 3, dtype=torch.bool), mapping=mapping.expand(b, n),
                        channel_idx=(torch.arange(n) // 3).expand(b, n))
        eps = torch.randn(b, 3, F, generator=g)
        with torch.inference_mode():
            want = cpu.generate(batch, eps=eps)
            got = gpu.generate(batch.to(cuda_device), eps=eps).cpu()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda_device):
    """One f32 train step of a small DenseCGVAE on the card (kernels forward
    and backward) against the same step on the CPU (plain versions and plain
    VJPs): every gradient and every updated parameter within 1e-4 of the
    tensor's max |ref|; each message layer's backward kernel launches
    once."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.config import DataConfig, ExperimentConfig, TrainConfig
    from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
    from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=8, seed=0, device=cuda_device)
    ds = build_dataset(newman_mapping(bonds, z.shape[0], 3, seed=0), frames, 8.5, 9.5, z,
                       bonds, order=2)
    cfg = ExperimentConfig(
        model=ModelConfig(n_cgs=3, n_basis=F, n_rbf=R, enc_nconv=2, dec_nconv=2,
                          breaksym=True, det=True, compute_dtype="float32"),
        data=DataConfig(batch_size=8),
        train=TrainConfig(lr=3e-4, gamma=25.0, adam_moment_dtype="bfloat16"))
    batch = ds.batch(np.arange(8))
    steps = {}
    for device in ("cpu", cuda_device):
        tr = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(0)), cfg,
                     device=device)
        state = tr.init_state(batch)
        before = (fused_message_vjp.launches, fused_pseudo_vjp.launches)
        loss, _, grads = tr.loss_and_grads(state, batch.to(device))
        after = (fused_message_vjp.launches, fused_pseudo_vjp.launches)
        steps[str(device)] = (tr, state, loss, grads, (after[0] - before[0], after[1] - before[1]))
    assert steps["cpu"][4] == (0, 0) and steps["cuda"][4] == (4, 2)
    for got, want in zip(steps["cuda"][3], steps["cpu"][3]):
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())
    # the update: the card's step against the CPU's optimizer applied to the
    # card's gradient (Adam's first step maps g to g / (|g| + 1e-8), so
    # rounding-level gradient differences near zero would move it by ~lr)
    tr, state, loss, grads, _ = steps["cuda"]
    state, ok = tr.apply_gradients(state, loss, grads)
    tr_cpu, state_cpu, _, _, _ = steps["cpu"]
    state_cpu, ok_cpu = tr_cpu.apply_gradients(state_cpu, loss.cpu(), [g.cpu() for g in grads])
    assert bool(ok) and bool(ok_cpu)
    for name, want in state_cpu.params.items():
        got = state.params[name].detach().cpu()
        assert float((got - want.detach()).abs().max()) <= 1e-4 * float(want.abs().max()), name


# the cv workflow's new kernel shapes: sample_ensemble reconstructs one frame
# at a time (B 1: the encoder at N 27, the prior and decoder at M 3) and
# generates n_ensemble samples (B 16); the cross decoder trains the message
# kernels at S 4, M 3
@pytest.mark.gpu
@pytest.mark.parametrize("kind,b,n,s", [
    ("message", 1, 27, 3), ("message", 1, 3, 3), ("message", 16, 3, 3),
    ("message", 128, 3, 4), ("message_vjp", 128, 3, 4), ("message_vjp", 1, 27, 3),
    ("pseudo", 1, 3, 9), ("pseudo", 16, 3, 9)])
def test_kernels_at_the_cv_shapes_on_card(cuda_device, kind, b, n, s):
    if kind == "pseudo":
        args = _pseudo_inputs(n, 3, cuda_device, f=600, r=8, b=b)
        out, ref = fused_pseudo_message(*args, CUT, 8), pseudo_reference(*args, CUT, 8)
    else:
        args = _message_inputs(n, s, 4, cuda_device, f=600, r=8, b=b)
        if kind == "message":
            out, ref = fused_message(*args, CUT, 8), message_reference(*args, CUT, 8)
        else:
            cts = _cotangents(message_reference(*args, CUT, 8), 5, cuda_device)
            out = fused_message_vjp(*args, *cts, CUT, 8)
            ref = message_vjp_reference(*args, *cts, CUT, 8)
    torch.cuda.synchronize()
    _close_rel(out, ref)


# the kernel shape table's new shapes (examples/profile_kernels_torch.py):
# the pseudo kernels' chunked path at PCN-scale M 100 (B 4) and M 300 (B 1),
# the message kernels at N 500 (B 2, S 4), F 600, R 8, the table's cutoffs
@pytest.mark.gpu
@pytest.mark.parametrize("kind,b,n", [("pseudo", 4, 100), ("pseudo", 1, 300),
                                      ("message", 2, 500)])
@pytest.mark.parametrize("vjp", [False, True])
def test_kernels_at_the_shape_table_shapes_on_card(cuda_device, kind, b, n, vjp):
    if kind == "pseudo":
        args = [*_pseudo_inputs(n, 12, cuda_device, f=600, r=8, b=b), 21.0, 8]
        fwd, plain, bwd, plain_bwd = (fused_pseudo_message, pseudo_reference,
                                      fused_pseudo_vjp, pseudo_vjp_reference)
    else:
        args = [*_message_inputs(n, 4, 13, cuda_device, f=600, r=8, b=b), 9.5, 8]
        fwd, plain, bwd, plain_bwd = (fused_message, message_reference, fused_message_vjp,
                                      message_vjp_reference)
    if vjp:
        cts = _cotangents(plain(*args), 14, cuda_device)
        out, ref = bwd(*args[:-2], *cts, *args[-2:]), plain_bwd(*args[:-2], *cts, *args[-2:])
    else:
        out, ref = fwd(*args), plain(*args)
    torch.cuda.synchronize()
    _close_rel(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("per_graph,replays", [(1, 2), (5, 3)])
def test_graph_ms_counts_only_launches_that_ran_on_card(cuda_device, per_graph, replays):
    """Around ``graph_ms`` of fwd + bwd, each counter rises by the warm-up's
    three calls and the 1 + ``replays`` replays of ``per_graph`` calls; the
    capture launches nothing."""
    from coarsegrainingvae_tpu_torch.ops import kernel_counters
    from coarsegrainingvae_tpu_torch.utils.profiling import graph_ms

    args = [*_message_inputs(27, 3, 15, cuda_device, f=64, r=8, b=4), 9.5, 8]
    cts = _cotangents(message_reference(*args), 16, cuda_device)

    def step():
        fused_message(*args)
        fused_message_vjp(*args[:-2], *cts, *args[-2:])

    counters = kernel_counters()
    before = [c.launches for c in counters]
    graph_ms(step, per_graph, replays, counters)
    rose = {c.__name__: c.launches - n for c, n in zip(counters, before)}
    want = 3 + per_graph * (1 + replays)
    assert rose == {"fused_message": want, "fused_message_vjp": want,
                    "fused_pseudo_message": 0, "fused_pseudo_vjp": 0}


def _tiny_train_cfg(dec_type="pseudo"):
    from coarsegrainingvae_tpu_torch.config import DataConfig, ExperimentConfig, TrainConfig

    return ExperimentConfig(
        model=ModelConfig(n_cgs=3, n_basis=F, n_rbf=R, enc_nconv=2, dec_nconv=2,
                          dec_type=dec_type, breaksym=True),
        data=DataConfig(batch_size=8),
        train=TrainConfig(lr=3e-4, gamma=25.0, adam_moment_dtype="bfloat16"))


@pytest.mark.gpu
def test_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    """A state saved from CUDA tensors restores bit for bit on the card, and
    on the CPU through map_location."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
    from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=16, seed=0, device=cuda_device)
    ds = build_dataset(newman_mapping(bonds, z.shape[0], 3, seed=0), frames, 8.5, 9.5, z,
                       bonds, order=2)
    cfg = _tiny_train_cfg()
    tr = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(0)), cfg,
                 device=cuda_device)
    state = tr.init_state(ds.batch(np.arange(8)))
    for lo in (0, 8):
        state, _ = tr.train_step(state, ds.batch(np.arange(lo, lo + 8)).to(cuda_device))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, state, metadata={"epoch": 5})
    for device in (cuda_device, torch.device("cpu")):
        other = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(3)),
                        cfg, device=device)
        restored, meta, step = mgr.restore(other.init_state(ds.batch(np.arange(8))))
        assert step == 5 and meta == {"epoch": 5}
        for name, p in state.params.items():
            got = restored.params[name]
            assert got.device.type == device.type and got is dict(
                other.model.named_parameters())[name]
            assert torch.equal(got.detach().cpu(), p.detach().cpu())
        for field in ("count", "mu", "nu"):
            assert torch.equal(getattr(restored.opt_state, field).cpu(),
                               getattr(state.opt_state, field).cpu())
        assert torch.equal(restored.step.cpu(), state.step.cpu())
    payload = torch.load(tmp_path / "5" / STATE_FILE, map_location="cpu", weights_only=True)
    assert torch.equal(payload["opt_state"]["mu"], state.opt_state.mu.cpu())


@pytest.mark.gpu
def test_from_run_on_card_serves_the_trained_model(cuda_device, tmp_path, monkeypatch):
    """A tiny CV run on the card; Backmapper.from_run of fold 0 serves what
    a Backmapper around the model the fold trained serves."""
    import json

    import numpy as np

    from coarsegrainingvae_tpu_torch.cli import run_cgvae
    from coarsegrainingvae_tpu_torch.config import ExperimentConfig
    from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.serve import Backmapper
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=48, seed=0, device=cuda_device)
    save_npz_traj(str(tmp_path / "dipeptide.npz"), z, frames, bonds)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path))
    trained = []

    class Recording(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trained.append(self)

    monkeypatch.setattr(run_cgvae, "Trainer", Recording)
    rows = run_cgvae.main(["-logdir", str(tmp_path / "run"), "-n_basis", "16", "-n_rbf", "4",
                           "-enc_nconv", "1", "-dec_nconv", "2", "-ndata", "48", "-nepochs", "2",
                           "-batch_size", "16", "-nsplits", "2", "-max_folds", "1",
                           "-n_ensemble", "2", "-nevals", "2", "--dec_type", "pseudo"])
    assert len(rows) == 1 and np.isfinite(rows[0]["test_all_recon_rmsd"])
    (run,) = [p for p in tmp_path.iterdir() if p.name.startswith("run")]
    bm = Backmapper.from_run(str(run / "modelparams.json"), str(run / "fold0"))
    assert bm.device.type == "cuda"
    mapping = json.loads((run / "fold0" / "mapping.json").read_text())
    ref = Backmapper(trained[0].model, mapping, z,
                     ExperimentConfig.load(str(run / "modelparams.json")), device=cuda_device)
    cg = np.random.default_rng(0).normal(size=(3, 3, 3)).astype(np.float32) * 3.0
    got, want = bm.backmap(cg, n_samples=4, seed=1), ref.backmap(cg, n_samples=4, seed=1)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-6 * float(np.abs(want).max())


# the wide kernels (R+1 > 16, pair_geometry.cuh): n_rbf 16 and 20 and the
# largest each wrapper takes, at the encoder's N 27 (S 3 and 4) and the
# decoder's M 3 and 6
@pytest.mark.gpu
@pytest.mark.parametrize("r", [16, 20, "max"])
@pytest.mark.parametrize("n,s", [(27, 3), (27, 4)])
def test_wide_message_kernels_match_plain_on_card(cuda_device, n, s, r):
    from coarsegrainingvae_tpu_torch.ops.fused_message import MAX_RBF

    r = MAX_RBF if r == "max" else r
    args = _message_inputs(n, s, 20, cuda_device, f=40, r=r)
    ref = message_reference(*args, CUT, r)
    _close_rel(fused_message(*args, CUT, r), ref)
    gs, gv = _cotangents(ref, 21, cuda_device)
    _close_rel(fused_message_vjp(*args, gs, gv, CUT, r),
               message_vjp_reference(*args, gs, gv, CUT, r))


@pytest.mark.gpu
@pytest.mark.parametrize("r", [16, 20, "max"])
@pytest.mark.parametrize("m", [3, 6])
def test_wide_pseudo_kernels_match_plain_on_card(cuda_device, m, r):
    from coarsegrainingvae_tpu_torch.ops.fused_pseudo import MAX_RBF

    r = MAX_RBF if r == "max" else r
    args = _pseudo_inputs(m, 22, cuda_device, f=40, r=r, b=8)
    ref = pseudo_reference(*args, CUT, r)
    _close_rel(fused_pseudo_message(*args, CUT, r), ref)
    cts = _cotangents(ref, 23, cuda_device)
    _close_rel(fused_pseudo_vjp(*args, *cts, CUT, r), pseudo_vjp_reference(*args, *cts, CUT, r))


@pytest.mark.gpu
def test_wrappers_name_the_wide_bound_on_card(cuda_device):
    from coarsegrainingvae_tpu_torch.ops import fused_message as mo
    from coarsegrainingvae_tpu_torch.ops import fused_pseudo as po

    args = _message_inputs(5, 3, 7, cuda_device, r=mo.MAX_RBF + 1)
    with pytest.raises(ValueError, match="shared memory"):
        fused_message(*args, CUT, mo.MAX_RBF + 1)
    args = _pseudo_inputs(3, 7, cuda_device, r=po.MAX_RBF + 1)
    with pytest.raises(ValueError, match="shared memory"):
        fused_pseudo_message(*args, CUT, po.MAX_RBF + 1)


def _epoch_setup(cuda_device, n_frames=32, det=False, sparse=False, zeta=0.0,
                 zeta_warmup=0):
    """A small trainer on the card (the dense model, or the sparse
    CGequiVAE; with zeta > 0 the steric tables) and a DeviceDataset of
    n_frames."""
    import dataclasses

    import numpy as np

    from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
    from coarsegrainingvae_tpu_torch.data.device import DeviceDataset
    from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.models.cgvae import build_flagship_model
    from coarsegrainingvae_tpu_torch.train.losses import build_steric_tables
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=n_frames, seed=0,
                                         device=cuda_device)
    ds = build_dataset(newman_mapping(bonds, z.shape[0], 3, seed=0), frames, 8.5, 9.5, z,
                       bonds, order=2)
    cfg = _tiny_train_cfg()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, det=det, sparse=sparse),
        train=dataclasses.replace(cfg.train, zeta=zeta, zeta_warmup=zeta_warmup))
    tr = Trainer(build_flagship_model(cfg.model, generator=torch.Generator().manual_seed(0)),
                 cfg, device=cuda_device,
                 steric_tables=build_steric_tables(z, bonds) if zeta > 0 else None)
    return tr, tr.init_state(ds.batch(np.arange(8))), DeviceDataset.from_dataset(ds, cuda_device)


def _tensors(state):
    return (*state.params.values(), state.opt_state.count, state.opt_state.mu,
            state.opt_state.nu, state.step)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, dict(sparse=True), dict(zeta=100.0, zeta_warmup=2)],
                         ids=["dense", "sparse", "steric"])
def test_captured_epoch_equals_eager_on_card(cuda_device, kw):
    """run_epoch_scan's replays against the same static step run eagerly,
    from the same state and generator, with the model's noise on: metrics,
    parameters, moments and the generator's state bit for bit. For the
    dense model, the sparse CGequiVAE (its segment sums are CSR reductions,
    no atomics) and the steric loss across the end of its warm-up ramp."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.data.device import epoch_index_batches

    tr, state, dds = _epoch_setup(cuda_device, **kw)
    start = [t.detach().clone() for t in _tensors(state)]
    batches = epoch_index_batches(dds.n_frames, 8, np.random.default_rng(0))
    runs = []
    for capture in (False, True):
        with torch.no_grad():
            for t, v in zip(_tensors(state), start):
                t.copy_(v)
        gen = torch.Generator(device=cuda_device).manual_seed(4)
        st, m = tr._run_program(state, dds, batches, gen, True, capture)
        runs.append((m, [t.detach().clone() for t in _tensors(st)], gen.get_state()))
    tr.release_graphs()
    (m_e, p_e, g_e), (m_c, p_c, g_c) = runs
    assert m_e == m_c and torch.equal(g_e, g_c)
    for a, b in zip(p_e, p_c):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_registered_generator_streams_per_epoch_on_card(cuda_device):
    """Each captured epoch draws from the generator it is given: epochs
    seeded a, b, a replay what eager epochs seeded a, b, a draw, and the
    given generator ends where the eager one does."""
    import numpy as np

    tr, state, dds = _epoch_setup(cuda_device)
    start = [t.detach().clone() for t in _tensors(state)]
    out = {}
    for scan in (True, False):
        with torch.no_grad():
            for t, v in zip(_tensors(state), start):
                t.copy_(v)
        rows = []
        for seed in (1, 2, 1):
            gen = torch.Generator(device=cuda_device).manual_seed(seed)
            if scan:
                state, m = tr.run_epoch_scan(state, dds, gen, np.random.default_rng(seed))
            else:
                state, m = tr.run_epoch_device(state, dds, gen, shuffle_rng=np.random.default_rng(seed))
            rows.append((m, gen.get_state()))
        out[scan] = rows
    tr.release_graphs()
    for (m_s, g_s), (m_d, g_d) in zip(out[True], out[False]):
        assert m_s == m_d and torch.equal(g_s, g_d)


@pytest.mark.gpu
def test_replays_count_their_launches_on_card(cuda_device):
    """A replay runs no Python; each credits the launches its capture
    counted: 2 + 2 message forwards and backwards and 2 pseudo ones per
    train step, 2 + 2 and 2 forwards per eval step. The warm-up and the
    capture itself count none."""
    counters = (fused_message, fused_message_vjp, fused_pseudo_message, fused_pseudo_vjp)
    tr, state, dds = _epoch_setup(cuda_device)
    before = [fn.launches for fn in counters]
    state, m = tr.run_epoch_scan(state, dds, torch.Generator(device=cuda_device).manual_seed(0))
    mid = [fn.launches for fn in counters]
    tr.run_epoch_scan_eval(state.params, dds, torch.Generator(device=cuda_device).manual_seed(1))
    after = [fn.launches for fn in counters]
    tr.release_graphs()
    steps = m["n_steps"]
    assert [b - a for a, b in zip(before, mid)] == [4 * steps, 4 * steps, 2 * steps, 2 * steps]
    assert [b - a for a, b in zip(mid, after)] == [4 * steps, 0, 2 * steps, 0]


@pytest.mark.gpu
def test_learn_map_on_card_matches_cpu(cuda_device):
    """learn_map's core on the card and on the CPU from the same draws: the
    same mapping, logits within 1e-3 of their range."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.models import cgae

    rng = np.random.default_rng(0)
    data = cgae.centred_frames(rng.normal(size=(64, 12, 3)).astype(np.float32) * 3)
    logits0 = (rng.normal(size=(12, 3)) * 0.1).astype(np.float32)
    decode0 = (rng.normal(size=(12, 3)) / np.sqrt(3)).astype(np.float32)
    idx = rng.integers(0, 64, size=(300, 32))
    u = rng.uniform(1e-10, 1.0, size=(300, 32, 12, 3)).astype(np.float32)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        logits, _ = cgae.learn_map_core(
            torch.as_tensor(data).to(dev), torch.as_tensor(logits0).to(dev),
            torch.as_tensor(decode0).to(dev),
            zip(torch.as_tensor(idx).to(dev), torch.as_tensor(u).to(dev)))
        out.append(logits.cpu())
    got, want = out
    np.testing.assert_array_equal(cgae.hard_mapping(got), cgae.hard_mapping(want))
    assert float((got - want).abs().max()) <= 1e-3 * float(want.max() - want.min())
    mapping = cgae.learn_map(data, 3, n_steps=100, seed=0, device=cuda_device)
    assert mapping.shape == (12,) and mapping[0] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_sum_is_deterministic_and_capturable_on_card(cuda_device, sorted_ids):
    """The CSR segment sum on the card: the CPU's sums within f32 rounding,
    the same bits on every call and backward, and the same bits again
    replayed from a CUDA graph."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.ops.segment import segment_sum

    rng = np.random.default_rng(0)
    e, n_seg = 20000, 700
    ids = rng.integers(0, n_seg - 1, size=e)
    ids = torch.as_tensor(np.sort(ids) if sorted_ids else ids)
    data = torch.as_tensor(rng.normal(size=(e, 3, 16)).astype(np.float32) * 1e3)
    mask = torch.as_tensor(rng.random(e) > 0.2)
    want = segment_sum(data, ids, n_seg, mask, indices_are_sorted=sorted_ids)
    d_ids, d_mask = ids.to(cuda_device), mask.to(cuda_device)
    outs, grads = [], []
    for _ in range(2):
        x = data.to(cuda_device).requires_grad_(True)
        out = segment_sum(x, d_ids, n_seg, d_mask, indices_are_sorted=sorted_ids)
        (out * out).sum().backward()
        outs.append(out.detach())
        grads.append(x.grad)
    assert torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])
    assert float((outs[0].cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    static = data.to(cuda_device)
    segment_sum(static, d_ids, n_seg, d_mask, indices_are_sorted=sorted_ids)    # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = segment_sum(static, d_ids, n_seg, d_mask, indices_are_sorted=sorted_ids)
    graph.replay()
    assert torch.equal(replayed, outs[0])


@pytest.mark.gpu
@pytest.mark.parametrize("dec_type", ["pseudo", "pseudo2", "cross", "en", "inv"])
def test_sparse_step_on_card_matches_cpu(cuda_device, dec_type):
    """One f32 train step of the sparse CGequiVAE: every gradient on the
    card within 1e-4 of its max |CPU| (the segment sums add in the same
    order on both; the matmuls do not)."""
    import dataclasses

    import numpy as np

    from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
    from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.models.cgvae import CGequiVAE
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=8, seed=0, device=cuda_device)
    ds = build_dataset(newman_mapping(bonds, z.shape[0], 3, seed=0), frames, 8.5, 9.5, z,
                       bonds, order=2)
    cfg = _tiny_train_cfg(dec_type)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, sparse=True, det=True, compute_dtype="float32"))
    batch = ds.batch(np.arange(8))
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        tr = Trainer(CGequiVAE(cfg.model, generator=torch.Generator().manual_seed(0)), cfg,
                     device=dev)
        _, _, g = tr.loss_and_grads(tr.init_state(batch), batch.to(dev))
        grads.append([t.cpu() for t in g])
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-4 * max(float(want.abs().max()), 1e-30)


@pytest.mark.gpu
def test_project_h_bonds_on_card_matches_cpu(cuda_device):
    """The H projection's scatter-min and index-adds on the card: the CPU's
    result, and the same bits on a second call."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.models.cgvae import project_h_bonds

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=4, seed=0, device=cuda_device)
    n, b = z.shape[0], 4
    directed = np.concatenate([bonds, bonds[:, ::-1]], 0)
    edges = torch.as_tensor((directed[None] + n * np.arange(b)[:, None, None]).reshape(-1, 2))
    zz = torch.as_tensor(np.tile(z, b))
    true = torch.as_tensor(frames.reshape(-1, 3), dtype=torch.float32)
    recon = true + 0.3 * torch.randn(true.shape, generator=torch.Generator().manual_seed(0))
    want = project_h_bonds(recon, zz, true, edges, None)
    args = [t.to(cuda_device) for t in (recon, zz, true, edges)]
    got = [project_h_bonds(*args, None) for _ in range(2)]
    assert torch.equal(got[0], got[1])
    assert float((got[0].cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _pcn_batch(n_proteins=4, device="cpu"):
    """Four synthetic proteins of 6-14 residues as one padded batch, with
    its C-alpha mask and dihedral quads."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.data.sidechain import build_pcn_dataset
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_protein

    items = [synthetic_protein(n, seed=s, device=device)
             for n, s in ((6, 0), (9, 1), (14, 2), (11, 3))[:n_proteins]]
    ds = build_pcn_dataset(items, cg_cutoff=10.0)
    idx = np.arange(n_proteins)
    return (ds.batch(idx), ds.ca_mask_for(idx), *ds.dihedrals_for(idx))


PCN_CARD_KW = dict(gamma=5.0, lr=3e-3, grad_clip=1.0, zeta=20.0, zeta_warmup=10)


def _pcn_step_grads(dev, dec_type, dtype, kw):
    """(trainer, state, loss, gradients) of one PCN step on ``dev`` at
    ``dtype`` (the model and the coordinates), aux 0.5, zeta mid-ramp."""
    import dataclasses

    from coarsegrainingvae_tpu_torch.models.cgvae import PCN
    from coarsegrainingvae_tpu_torch.train.pcn_trainer import PCNTrainer

    batch, cam, quads, qmask = _pcn_batch()
    if dtype == "float64":
        batch = dataclasses.replace(batch, xyz=batch.xyz.double(), cg_xyz=batch.cg_xyz.double())
    cfg = ModelConfig(n_basis=32, n_rbf=10, atom_cutoff=10.0, dec_nconv=2, dec_type=dec_type,
                      compute_dtype=dtype)
    model = PCN(cfg, generator=torch.Generator().manual_seed(0)).to(getattr(torch, dtype))
    tr = PCNTrainer(model, device=dev, **kw)
    state = tr.init_state()
    b, c, q, qm = tr._inputs(batch, cam, quads, qmask)
    loss, _ = tr._loss(b, c, q, qm, 0.5, tr.zeta_at(5))
    params = list(state.params.values())
    # pseudo2's last dvbar mix reaches no output: a zero gradient
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return tr, state, loss.detach(), grads


def _worst_rel(got, want) -> float:
    """max over tensors of max|got - want| / max|want|."""
    return max(float((a.detach().cpu().double() - b.detach().cpu().double()).abs().max())
               / max(float(b.detach().abs().max()), 1e-30) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dec_type", ["cross", "painn", "pseudo", "pseudo2"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pcn_step_on_card_matches_cpu(cuda_device, dec_type, dtype):
    """One PCN train step: every gradient on the card within 1e-4 of its
    max |CPU|, then every updated parameter against the CPU's optimizer
    applied to the card's gradients (Adam's first step maps g to
    g / (|g| + 1e-8), which turns rounding-level gradient differences into
    update differences up to lr). At float64 the whole loss (the dihedral
    term, the ramped steric term and the rooted bond projection); at f32
    its smooth terms: at random weights the dihedral's atan2 wraps at +-pi
    and the projection divides by decoded bond lengths near zero, so f32
    rounding alone moves some of their gradients by far more than 1e-4
    (the test below holds the whole loss at f32)."""
    from coarsegrainingvae_tpu_torch.train.trainer import guarded_update

    kw = dict(PCN_CARD_KW)
    kw.update(dict(kappa=1.0, bond_project=True) if dtype == "float64" else dict(kappa=0.0))
    tr, state, loss, grads = _pcn_step_grads(cuda_device, dec_type, dtype, kw)
    tr_ref, state_ref, _, grads_ref = _pcn_step_grads(torch.device("cpu"), dec_type, dtype, kw)
    assert _worst_rel(grads, grads_ref) <= 1e-4
    params = list(state.params.values())
    guarded_update(tr.tx, params, grads, loss, state.opt_state, state.lr, 1e9)
    params_ref = list(state_ref.params.values())
    guarded_update(tr_ref.tx, params_ref, [g.cpu() for g in grads], loss.cpu(),
                   state_ref.opt_state, state_ref.lr, 1e9)
    assert _worst_rel(params, params_ref) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dec_type", ["cross", "painn", "pseudo", "pseudo2"])
def test_pcn_whole_loss_f32_step_on_card_within_its_conditioning(cuda_device, dec_type):
    """The whole loss (dihedral, ramped steric, rooted projection) at f32:
    its gradients on the card are held to the f32 conditioning the CPU
    shows on the same step ("own": the CPU's f32 gradients against its
    float64 ones). The card's f32 lies within max(2 * own, 1e-4) of the
    CPU's float64 and within max(own, 1e-4) of the CPU's f32."""
    kw = dict(PCN_CARD_KW, kappa=1.0, bond_project=True)
    card = _pcn_step_grads(cuda_device, dec_type, "float32", kw)[3]
    cpu = _pcn_step_grads(torch.device("cpu"), dec_type, "float32", kw)[3]
    exact = _pcn_step_grads(torch.device("cpu"), dec_type, "float64", kw)[3]
    own = _worst_rel(cpu, exact)
    assert _worst_rel(card, exact) <= max(2.0 * own, 1e-4)
    assert _worst_rel(card, cpu) <= max(own, 1e-4)


@pytest.mark.gpu
def test_pcn_projection_and_atom14_relaxation_repeat_their_bits_on_card(cuda_device):
    """project_bonds_rooted's segment sums and the atom14 relaxation's on
    the card: the same bits on a second call, and the CPU's result within
    float32 summation-order tolerance."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_protein
    from coarsegrainingvae_tpu_torch.models.cgvae import flatten_batch, project_bonds_rooted

    batch, cam, _, _ = _pcn_batch()
    g = flatten_batch(batch)
    noisy = g.xyz + 0.5 * torch.randn(g.xyz.shape, generator=torch.Generator().manual_seed(0))
    args = (noisy, g.xyz, g.bonds, g.bond_mask, torch.as_tensor(cam).reshape(-1), g.atom_mask)
    want = project_bonds_rooted(*args)
    on_card = [a.to(cuda_device) for a in args]
    got = [project_bonds_rooted(*on_card) for _ in range(2)]
    assert torch.equal(got[0], got[1])
    torch.testing.assert_close(got[0].cpu(), want, rtol=1e-4, atol=1e-4)

    runs = [synthetic_protein(40, seed=7, well_posed=True, device=cuda_device)[1]
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    cpu = synthetic_protein(40, seed=7, well_posed=True, device="cpu")[1]
    np.testing.assert_allclose(runs[0], cpu, rtol=0, atol=1e-3)


@pytest.mark.gpu
def test_native_routes_on_the_card_machine(cuda_device, tmp_path, monkeypatch):
    """The g++ build of both native sources where the card is, and each
    route against its dense plain version: the cell list at N 300 (edges
    per receiver and mask), the bond diff's metrics past the threshold."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.data import neighbors
    from coarsegrainingvae_tpu_torch.eval import metrics
    from coarsegrainingvae_tpu_torch.native import bond_diff, build, cell_list

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    frames = (np.random.default_rng(0).normal(size=(4, 300, 3)) * 8.0).astype(np.float32)
    calls = cell_list.calls
    e, m = neighbors.radius_graph_frames(frames, 4.5)
    assert cell_list.calls == calls + 1
    de, dm = neighbors.radius_graph_frames_dense(frames, 4.5)
    np.testing.assert_array_equal(m, dm)
    for k in range(frames.shape[0]):
        got, want = e[k][m[k]], de[k][dm[k]]
        np.testing.assert_array_equal(got[np.lexsort((got[:, 1], got[:, 0]))],
                                      want[np.lexsort((want[:, 1], want[:, 0]))])

    rng = np.random.default_rng(1)
    z = rng.choice([1, 6, 7, 8], size=120)
    ref = rng.normal(size=(120, 3)).astype(np.float32) * 4.0
    gen = ref[None] + rng.normal(scale=np.linspace(0.0, 0.5, 4)[:, None, None],
                                 size=(4, 120, 3)).astype(np.float32)
    calls = bond_diff.calls
    cell = metrics.evaluate_samples(ref, gen, z, large_n_threshold=1)
    assert bond_diff.calls == calls + 2
    dense = metrics.evaluate_samples(ref, gen, z)
    for k in ("valid_ratio", "valid_allatom_ratio", "graph_val_ratio", "graph_edit_ratio"):
        np.testing.assert_allclose(cell[k], dense[k], rtol=1e-9, err_msg=k)
    assert sorted(p.name[:len("libcell_list")] for p in tmp_path.iterdir()) == [
        "libbond_diff", "libcell_list"]


# ------------------------------------------------------- DiffPool, baselines
# the committed DiffPool v6 recipe's width (examples/results/diffpool_demo)
V6 = dict(n_cgs=8, feat_dim=512, n_rbf=7, atom_cutoff=8.0, cg_cutoff=30.0, pool_nconv=1,
          enc_nconv=2, dec_nconv=3, activation="swish", cross=True, tau_min=0.1)
V6_TRAIN = dict(beta=0.02, gamma=25.0, lr=3e-4, zeta=50.0, zeta_warmup=5000, graph_grad=True,
                graph_warmup=5000, h_project=True)


def _diffpool_setup(n_frames=32):
    import numpy as np

    from coarsegrainingvae_tpu_torch.data.diffpool import build_diffpool_dataset
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.train.losses import build_steric_tables

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=n_frames, seed=0, device="cpu")
    ds = build_diffpool_dataset(frames, z, bonds, rotate=True, seed=1)
    return z, ds, build_steric_tables(z, bonds, margin=0.3), ds.batch(np.arange(n_frames))


def _diffpool_trainer(device, z, steric):
    from coarsegrainingvae_tpu_torch.config import DiffPoolConfig
    from coarsegrainingvae_tpu_torch.train.diffpool_trainer import DiffPoolTrainer

    return DiffPoolTrainer(DiffPoolConfig(n_atoms=z.shape[0], **V6), steric_tables=steric,
                           device=device, **V6_TRAIN)


def _v6_draws(tr, batch_size):
    from coarsegrainingvae_tpu_torch.models.cgae import uniform_noise

    g = torch.Generator().manual_seed(3)
    u = uniform_noise(tr.model.pooler.noise_shape(batch_size, tr.cfg.n_atoms), g, "cpu")
    return u, torch.randn((batch_size, tr.cfg.n_cgs, tr.cfg.feat_dim), generator=g)


@pytest.mark.gpu
def test_diffpool_step_on_card_matches_cpu(cuda_device):
    """The v6 recipe's f32 step at full width and batch 32 mid-ramp (step
    2,500 of the 5,000-step graph and zeta ramps, h_project): every
    gradient on the card within 1e-4 of its max |CPU|, with the same
    weights and draws."""
    z, _, steric, batch = _diffpool_setup()
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        tr = _diffpool_trainer(dev, z, steric)
        u, eps = _v6_draws(tr, 32)
        tr.noise = lambda key, b, u=u, eps=eps, dev=dev: (u.to(dev), eps.to(dev))
        state = tr.init_state()
        total, metrics = tr.loss(batch.to(dev), 2500, (0,))
        assert "steric" in metrics
        g = torch.autograd.grad(total, list(state.params.values()), allow_unused=True)
        grads.append([torch.zeros_like(p).cpu() if t is None else t.cpu()
                      for p, t in zip(state.params.values(), g)])
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-4 * max(float(want.abs().max()), 1e-30)


@pytest.mark.gpu
def test_diffpool_sample_hard_on_card_matches_cpu(cuda_device):
    z, _, steric, batch = _diffpool_setup(8)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        tr = _diffpool_trainer(dev, z, steric)
        u, eps = _v6_draws(tr, 8)
        tr.noise = lambda key, b, u=u, eps=eps, dev=dev: (u.to(dev), eps.to(dev))
        out.append(tr.sample(batch, seed=0, hard=True).cpu())
    assert torch.isfinite(out[0]).all()
    assert float((out[0] - out[1]).abs().max()) <= 1e-4 * float(out[1].abs().max())


@pytest.mark.gpu
def test_diffpool_steps_repeat_their_bits_on_card(cuda_device):
    """Two v6 steps from one state (the same key, so the same draws): the
    parameters and both moments bit for bit."""
    import dataclasses

    z, _, steric, batch = _diffpool_setup()
    tr = _diffpool_trainer(cuda_device, z, steric)
    state = dataclasses.replace(tr.init_state(), step=2500)
    start = {k: p.detach().clone() for k, p in state.params.items()}
    after = []
    for _ in range(2):
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(start[k])
        new, _ = tr.train_step(state, batch, (0, 1))
        after.append([p.detach().clone() for p in new.params.values()]
                     + [new.opt_state.mu.clone(), new.opt_state.nu.clone()])
    assert all(torch.equal(x, y) for x, y in zip(*after))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["linear", "mlp", "equimlp", "equimlp2", "setequimlp",
                                  "edgesetmlp", "equilinear"])
def test_baseline_step_on_card_matches_cpu(cuda_device, name):
    """One f32 step of each zoo entry at the baseline_demo recipe's knn 3,
    batch 32 and gamma 5, on 6 beads (at the recipe's 3 the kNN graph is
    complete, the edge sums cancel and equimlp's gradients are 0 up to
    rounding): every gradient within 1e-4 of its max |CPU|."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.data.diffpool import build_diffpool_dataset
    from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.data.topology import (
        channel_index_from_mapping,
        max_atoms_per_bead,
    )
    from coarsegrainingvae_tpu_torch.models.baseline import build_baseline
    from coarsegrainingvae_tpu_torch.train.baseline_trainer import BaselineTrainer

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=32, seed=0, device="cpu")
    mapping = newman_mapping(bonds, z.shape[0], 6, seed=0)
    batch = build_diffpool_dataset(frames, z, bonds).batch(np.arange(32))
    kw = dict(linear={}, mlp=dict(width=1, depth=1), edgesetmlp=dict(knn=3),
              equilinear=dict(knn=3)).get(name, dict(knn=3, width=1, depth=1))
    if name == "setequimlp":
        kw.update(channel_idx=channel_index_from_mapping(mapping),
                  n_channels=max_atoms_per_bead(mapping))
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        model = build_baseline(name, 6, z.shape[0], mapping,
                               generator=torch.Generator().manual_seed(0), **kw)
        tr = BaselineTrainer(model, gamma=5.0, lr=3e-4, device=dev)
        state = tr.init_state()
        total, _ = tr.loss(batch.to(dev))
        g = torch.autograd.grad(total, list(state.params.values()))
        grads.append([t.cpu() for t in g])
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-4 * max(float(want.abs().max()), 1e-30)


@pytest.mark.gpu
def test_diffpool_baseline_and_hpo_clis_run_on_card(cuda_device, tmp_path, monkeypatch):
    """run_diffpool, run_baseline and one hpo trial at a tiny size with
    --device cuda, each writing its files; and an hpo trial that fails on
    the card (a basis beyond the wide kernels' bound raises in the
    wrapper, before any launch) is reported as failed while the next
    trial runs."""
    import csv

    from coarsegrainingvae_tpu_torch.cli import hpo, run_baseline, run_cgvae, run_diffpool
    from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide

    save_npz_traj(str(tmp_path / "dipeptide.npz"),
                  *synthetic_peptide("dipeptide", n_frames=32, seed=0, device=cuda_device))
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path))
    rows = run_diffpool.main(["-logdir", str(tmp_path / "dp"), "-n_cgs", "4", "-num_features",
                              "16", "-ndata", "32", "-nepochs", "1", "-batch_size", "8",
                              "-n_pretrain", "1", "--h_project", "--device", "cuda"])
    assert len(rows) == 2 and all(r["test_recon"] > 0 for r in rows)
    rows = run_baseline.main(["-logdir", str(tmp_path / "bl"), "-model", "setequimlp",
                              "-ndata", "32", "-nepochs", "1", "-batch_size", "8",
                              "--device", "cuda"])
    assert len(rows) == 2 and all(r["test_recon_rmsd"] > 0 for r in rows)

    args = run_cgvae.build_parser().parse_args([
        "-logdir", str(tmp_path / "hpo"), "-ndata", "32", "-batch_size", "8", "-nsplits", "2",
        "-cg_method", "newman", "--device", "cuda"])
    objective = hpo._cv_objective(args)
    space = {k: ("choice", (v,), None) for k, v in dict(
        lr=3e-4, beta=0.05, gamma=5.0, n_basis=16, enc_nconv=1, dec_nconv=1, atom_cutoff=8.0,
        cg_cutoff=9.0).items()}
    space["n_rbf"] = ("choice", (300, 4), None)
    _, _, trials = hpo.random_search(lambda c: objective(c, 1), space, 6, seed=0,
                                     log_path=str(tmp_path / "hpo" / "log.csv"))
    by_rbf = {r["n_rbf"]: r for r in trials}
    assert by_rbf[300]["failed"] and "200" in by_rbf[300]["error"]
    assert not by_rbf[4]["failed"] and by_rbf[4]["value"] > 0
    with open(tmp_path / "hpo" / "log.csv", newline="") as f:
        assert {r["failed"] for r in csv.DictReader(f)} == {"True", "False"}


# ------------------------------------------------ multi-GPU (A14) on one card
def _dp_cfg(n_basis=24, compute_dtype="float32", batch=8, **parallel):
    from coarsegrainingvae_tpu_torch.config import (DataConfig, ExperimentConfig,
                                                    ParallelConfig, TrainConfig)

    return ExperimentConfig(
        model=ModelConfig(n_basis=n_basis, n_rbf=R, enc_nconv=2, dec_nconv=2, breaksym=True,
                          compute_dtype=compute_dtype),
        data=DataConfig(batch_size=batch),
        train=TrainConfig(lr=1e-3, gamma=1.0, adam_moment_dtype="float32"),
        parallel=ParallelConfig(**parallel))


def _dp_dataset(n_frames=32):
    from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
    from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=n_frames, seed=0, device="cpu")
    return build_dataset(newman_mapping(bonds, z.shape[0], 3, seed=0), frames, 8.5, 9.5, z,
                         bonds, order=2)


@pytest.mark.gpu
def test_one_nccl_rank_captured_epoch_equals_the_plain_trainer_on_card(cuda_device, tmp_path):
    """Trainer(mesh=make_mesh()) on one NCCL rank: its captured epoch, the
    all-reduce in the graph, gives the plain trainer's bits from the same
    weights and draws, at bf16 compute."""
    import numpy as np
    import torch.distributed as dist

    from coarsegrainingvae_tpu_torch.data.device import DeviceDataset, epoch_index_batches
    from coarsegrainingvae_tpu_torch.parallel.mesh import Mesh, make_mesh
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    ds = _dp_dataset()
    cfg = _dp_cfg(compute_dtype="bfloat16")
    dds = DeviceDataset.from_dataset(ds, cuda_device)
    batches = epoch_index_batches(dds.n_frames, 8, np.random.default_rng(0))
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        runs = []
        for mesh in (Mesh(0, 1, None, None, torch.device("cuda")), make_mesh()):
            tr = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(0)), cfg,
                         device=cuda_device, mesh=mesh)
            assert tr.captures
            st = tr.init_state(ds.batch(np.arange(8)))
            gen = torch.Generator(device=cuda_device).manual_seed(3)
            st, m = tr._run_program(st, dds, batches, gen, True, True)
            runs.append(([p.detach().clone() for p in st.params.values()]
                         + [st.opt_state.mu.clone(), st.opt_state.nu.clone()],
                         tr._programs[(id(dds), True)].metrics.clone()))
            tr.release_graphs()
    finally:
        dist.destroy_process_group()
    (a, ma), (b, mb) = runs
    assert torch.equal(ma, mb)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_match_one_rank(cuda_device, tmp_path):
    """Two gloo ranks sharing the card: 3 f32 steps with noise against one
    rank within 1e-4 of each tensor's largest entry, ZeRO-1 bit for bit the
    replicated optimizer, each rank holding half the moments."""
    import numpy as np
    import torch_parallel_ranks as ranks

    from coarsegrainingvae_tpu_torch.parallel.launch import spawn_ranks

    ds = _dp_dataset()
    batches = [ds.batch(np.arange(8 * i, 8 * i + 8)) for i in range(3)]
    cfg = _dp_cfg()
    cases = {"dp": (ranks.train_steps, dict(cfg=cfg, batches=batches, gen_seed=5,
                                            device="cuda")),
             "zero": (ranks.train_steps, dict(cfg=ranks.replace_parallel(cfg, zero_optimizer=True),
                                              batches=batches, gen_seed=5, device="cuda"))}
    got = spawn_ranks(ranks.run_all, 2, str(tmp_path / "store"), (cases,))
    want = ranks.train_steps(cfg, batches, parallel=False, gen_seed=5, device="cuda")
    n_params = want["moments"]
    for r in got:
        assert r["zero"]["moments"] == -(-n_params // 2)
        for k, ref in want["params"].items():
            err = np.abs(r["dp"]["params"][k] - ref).max() / max(np.abs(ref).max(), 1e-30)
            assert err <= 1e-4, (k, err)
            np.testing.assert_array_equal(r["zero"]["params"][k], r["dp"]["params"][k])


@pytest.mark.gpu
def test_halo_stack_on_two_gloo_ranks_matches_the_unsharded_stack_on_card(cuda_device,
                                                                            tmp_path):
    """The halo stack (2 layers, F 16) on two gloo ranks sharing the card
    against the unsharded EquiStack on the card: forward, the input
    gradient and the parameter gradients within 1e-4 of max|ref|."""
    import numpy as np
    import torch_parallel_ranks as ranks

    from coarsegrainingvae_tpu_torch.data.neighbors import radius_graph_frames_dense
    from coarsegrainingvae_tpu_torch.parallel import halo
    from coarsegrainingvae_tpu_torch.parallel.launch import spawn_ranks

    rng = np.random.default_rng(0)
    n, cutoff = 600, 3.0
    side = (n / 0.05) ** (1 / 3)
    xyz = (rng.uniform(0, 1, (n, 3)) * np.array([3 * side, side, side])).astype(np.float32)
    e, m = radius_graph_frames_dense(xyz[None], cutoff)
    edges = e[0][m[0]]
    kw = dict(n_conv=2, feat_dim=16, n_rbf=6, activation="swish", cutoff=cutoff)
    stack = halo.EquiStack(**kw, generator=torch.Generator().manual_seed(0))
    s = rng.normal(size=(n, 16)).astype(np.float32)
    v = rng.normal(size=(n, 3, 16)).astype(np.float32)
    case = dict(xyz=xyz, edges=edges, s=s, v=v, kw=kw, stack=True,
                state_dict={k: t.numpy() for k, t in stack.state_dict().items()},
                halo=halo.min_halo(xyz, edges, 2))
    got = spawn_ranks(ranks.halo_cases, 2, str(tmp_path / "store"),
                      ({"stack": case}, True, "cuda"))
    stack.to(cuda_device)
    s_in = torch.as_tensor(s, device=cuda_device).requires_grad_(True)
    so, vo = stack(s_in, torch.as_tensor(v, device=cuda_device),
                   torch.as_tensor(xyz, device=cuda_device),
                   torch.as_tensor(edges, dtype=torch.long, device=cuda_device))
    loss = (so ** 2).sum() + (vo ** 2).sum()
    names = [k for k, _ in stack.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in stack.named_parameters()] + [s_in])
    plan = halo.plan_halo(xyz, edges, 2, case["halo"])

    def gathered(key):
        return np.concatenate([r["stack"][key] for r in got])[plan.inv_order]

    def close(a, b):
        b = b.detach().cpu().numpy()
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()

    close(gathered("s"), so)
    close(gathered("v"), vo)
    close(gathered("g_s"), grads[-1])
    for k, g in zip(names, grads[:-1]):
        close(got[0]["stack"]["grads"][k], g)


# ------------------------------------------------------------------ run files
@pytest.fixture(scope="module")
def full_width_run(tmp_path_factory):
    """One fold of chip_smoke's cv recipe at full width (n_basis 600, enc 4 /
    dec 5, pseudo, bf16), one epoch on 320 frames, trained on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a "
                    "and have no CPU or interpret mode")
    import chip_smoke
    from coarsegrainingvae_tpu_torch.cli import run_cgvae
    from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide

    base = tmp_path_factory.mktemp("runfiles")
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=320, seed=0)
    save_npz_traj(str(base / "dipeptide.npz"), z, frames, bonds)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("COARSEGRAININGVAE_DATA", str(base))
        run_cgvae.main(chip_smoke.CV_RECIPE + chip_smoke.CV_WIDTH + [
            "-ndata", "320", "-nsplits", "5", "-max_folds", "1", "-nepochs", "1",
            "-n_ensemble", "2", "-nevals", "2", "--dec_type", "pseudo",
            "-logdir", str(base / "run")])
        (run,) = [p for p in base.iterdir() if p.name.startswith("run")]
        yield run


@pytest.mark.gpu
def test_full_width_state_round_trips_through_the_flax_tree_on_card(cuda_device,
                                                                    full_width_run):
    """(a) The fold's checkpoint through JAX's tree, the codec's bytes and
    back: every tensor bit for bit, the re-written bytes identical."""
    import chip_smoke
    from coarsegrainingvae_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig.load(str(full_width_run / "modelparams.json"))
    back, _, step, _ = chip_smoke.state_round_trip(full_width_run / "fold0", cfg)
    assert step == 0 and back["opt_state"]["mu"].dtype == torch.bfloat16


@pytest.mark.gpu
def test_full_width_converted_fold_serves_and_resumes_bit_for_bit_on_card(
        cuda_device, full_width_run, tmp_path):
    """(b) from_run of the fold rewritten from (a)'s state serves the
    original's bits through kernels 1 and 3; (c) an epoch resumed from it
    gives the original's parameters, through kernels 1-4."""
    import chip_smoke
    from coarsegrainingvae_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig.load(str(full_width_run / "modelparams.json"))
    back, meta, step, _ = chip_smoke.state_round_trip(full_width_run / "fold0", cfg)
    original = chip_smoke.copy_fold(full_width_run, "fold0", tmp_path / "original", step)
    converted = chip_smoke.copy_fold(full_width_run, "fold0", tmp_path / "converted", step,
                                     back, meta)
    served, _ = chip_smoke.serve_converted(original, converted, "cuda")
    assert served["fused_message"] > 0 and served["fused_pseudo_message"] > 0
    assert served["fused_message_vjp"] == served["fused_pseudo_vjp"] == 0
    after_conv, launches, _ = chip_smoke.resume_one_epoch(converted, "cuda")
    after_orig, _, _ = chip_smoke.resume_one_epoch(original, "cuda")
    assert min(launches.values()) > 0
    assert all(chip_smoke.torch_equal(after_conv[k], after_orig[k]) for k in after_orig)


@pytest.mark.gpu
def test_relaxed_frames_repeat_their_bits_on_card(cuda_device, tmp_path):
    """relax_frames sums its bond forces in a fixed order: the synthetic
    dipeptide's relaxed frames on the card have the same bits on a second
    call and in two other processes, and agree with the CPU's within the
    relaxation's float32 tolerance."""
    import numpy as np
    import torch_parallel_ranks as ranks

    from coarsegrainingvae_tpu_torch.parallel.launch import spawn_ranks

    runs = [ranks.synthetic_frames("cuda") for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    for other in spawn_ranks(ranks.synthetic_frames, 2, str(tmp_path / "store"), ("cuda",)):
        np.testing.assert_array_equal(other, runs[0])
    np.testing.assert_allclose(runs[0], ranks.synthetic_frames("cpu"), rtol=0, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["message", "pseudo"])
def test_kernels_on_feature_slices_equal_the_whole_width_on_card(cuda_device, kind):
    """Tensor parallelism's compute split: each kernel, forward and
    backward, run on the two halves of F 600 and concatenated along F
    gives the whole-width launch's bits (every output at feature f reads
    feature f alone; d_w sums the batch per feature)."""
    f, h = 600, 300
    if kind == "message":
        ins = _message_inputs(27, 4, seed=3, device=cuda_device, f=f, b=8)
        cts = [torch.randn(8, 27, f, device=cuda_device), torch.randn(8, 27, 3, f, device=cuda_device)]
        fwd, vjp, geo = fused_message, fused_message_vjp, 2
    else:
        ins = _pseudo_inputs(3, seed=3, device=cuda_device, f=f, b=8)
        cts = [torch.randn(8, 3, f, device=cuda_device), torch.randn(8, 3, f, device=cuda_device),
               torch.randn(8, 3, 3, f, device=cuda_device),
               torch.randn(8, 3, 3, f, device=cuda_device)]
        fwd, vjp, geo = fused_pseudo_message, fused_pseudo_vjp, 2

    def halves(ts, lo):
        return [t[..., lo:lo + h].contiguous() for t in ts]

    with torch.no_grad():
        whole = fwd(*ins, CUT, R)
        parts = [fwd(*ins[:geo], *halves(ins[geo:], lo), CUT, R) for lo in (0, h)]
        for a, p0, p1 in zip(whole, *parts):
            assert torch.equal(a, torch.cat([p0, p1], -1))
        whole = vjp(*ins, *cts, CUT, R)
        parts = [vjp(*ins[:geo], *halves(ins[geo:], lo), *halves(cts, lo), CUT, R)
                 for lo in (0, h)]
        for a, p0, p1 in zip(whole, *parts):
            assert torch.equal(a, torch.cat([p0, p1], -1))


@pytest.mark.gpu
def test_tensor_parallel_gloo_ranks_on_one_card_match_one_rank(cuda_device, tmp_path):
    """Two gloo ranks sharing the card on a (1, 2) ('data', 'model') mesh:
    3 f32 steps with noise, every message block's kernels on half the
    features, against one rank within 1e-4 of each tensor's largest entry,
    both ranks alike, each holding half the moments of the sharded
    tensors."""
    import numpy as np
    import torch_parallel_ranks as ranks

    from coarsegrainingvae_tpu_torch.parallel.launch import spawn_ranks

    ds = _dp_dataset()
    batches = [ds.batch(np.arange(8 * i, 8 * i + 8)) for i in range(3)]
    cfg = _dp_cfg(n_basis=128, model_devices=2)
    cases = {"tp": (ranks.train_steps, dict(cfg=cfg, batches=batches, gen_seed=5,
                                            device="cuda"))}
    got = spawn_ranks(ranks.run_all, 2, str(tmp_path / "store"), (cases,))
    want = ranks.train_steps(ranks.replace_parallel(cfg, model_devices=1), batches,
                             parallel=False, gen_seed=5, device="cuda")
    for r in got:
        assert r["tp"]["shards"] and r["tp"]["moments"] < want["moments"]
        for k, ref in want["params"].items():
            err = np.abs(r["tp"]["params"][k] - ref).max() / max(np.abs(ref).max(), 1e-30)
            assert err <= 1e-4, (k, err)
            np.testing.assert_array_equal(r["tp"]["params"][k], got[0]["tp"]["params"][k])
