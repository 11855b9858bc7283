"""The learned cgae mapping in the PyTorch port against the JAX package:
gumbel_softmax, cgae_forward, the learn_map trajectory with the JAX
package's own draws injected, repair_mapping, get_mapping("cgae")'s retry
and repair, and ``run_cgvae -cg_method cgae`` on the CPU."""
import csv
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coarsegrainingvae_tpu.data import mappings as jmap
from coarsegrainingvae_tpu.data.synthetic import synthetic_peptide as jax_peptide
from coarsegrainingvae_tpu.models import cgae as jcgae
from coarsegrainingvae_tpu_torch.cli import run_cgvae
from coarsegrainingvae_tpu_torch.data import mappings as tmap
from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
from coarsegrainingvae_tpu_torch.models import cgae

torch.set_num_threads(1)

RTOL = 1e-5
N_STEPS = 120
# learn_map's final logits after 120 Adam steps, f32 in another summation
# order: Adam scales each step to ~lr whatever the gradient's size, so a
# rounding-level difference in a gradient near zero moves a logit by up to
# lr = 4e-3 per step; measured here ~1e-5, gated at 1e-3 of the logits' range
LOGIT_ATOL = 1e-3


@pytest.fixture(scope="module")
def dipeptide():
    return jax_peptide("dipeptide", n_frames=32, seed=0)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_matches_jax(hard):
    key = jax.random.PRNGKey(3)
    logits = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (6, 4)))
    u = np.asarray(jax.random.uniform(key, logits.shape, minval=1e-10, maxval=1.0))
    want = jcgae.gumbel_softmax(key, jnp.asarray(logits), jnp.asarray(0.4), hard=hard)
    got = cgae.gumbel_softmax(torch.as_tensor(logits), 0.4, torch.as_tensor(u), hard=hard)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-7)


def test_uniform_noise_bounds():
    u = cgae.uniform_noise((4096,), torch.Generator().manual_seed(0), "cpu")
    assert float(u.min()) >= 1e-10 and float(u.max()) < 1.0


def test_cgae_forward_matches_jax():
    n, k, b = 10, 3, 4
    key = jax.random.PRNGKey(0)
    params = jcgae.CGaeParams(assign_logits=jax.random.normal(key, (n, k)),
                              decode=jax.random.normal(jax.random.fold_in(key, 1), (n, k)))
    xyz = jax.random.normal(jax.random.fold_in(key, 2), (b, n, 3))
    noise_key = jax.random.fold_in(key, 3)
    u = jax.random.uniform(noise_key, (b, n, k), minval=1e-10, maxval=1.0)
    want = jcgae.cgae_forward(params, xyz, noise_key, jnp.asarray(0.7))
    got = cgae.cgae_forward(*(torch.as_tensor(np.asarray(a)) for a in
                              (params.assign_logits, params.decode, xyz, u)), 0.7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-6)


def _jax_draws(frames, n_cgs, seed, n_steps, batch_size=32):
    """learn_map's initial parameters and per-step draws, from JAX's keys
    exactly as coarsegrainingvae_tpu/models/cgae.py:96-121 derives them."""
    f, n = frames.shape[:2]
    b = min(batch_size, f)
    k_init, k_scan = jax.random.split(jax.random.PRNGKey(seed))
    logits = np.asarray(jax.random.normal(k_init, (n, n_cgs)) * 0.1)
    decode = np.asarray(jax.random.normal(jax.random.fold_in(k_init, 1), (n, n_cgs))
                        * (1.0 / np.sqrt(n_cgs)))
    idx, u = [], []
    for i in range(n_steps):
        k = jax.random.fold_in(k_scan, i)
        idx.append(np.asarray(jax.random.randint(jax.random.fold_in(k, 1), (b,), 0, f)))
        u.append(np.asarray(jax.random.uniform(k, (b, n, n_cgs), minval=1e-10, maxval=1.0)))
    return logits, decode, np.stack(idx), np.stack(u)


def _jax_final_logits(frames, logits, decode, seed, n_steps):
    """JAX's learn_map loop (cgae.py:103-132) to its final logits, which
    learn_map itself does not return."""
    data = jnp.asarray(cgae.centred_frames(frames))
    f = data.shape[0]
    params = jcgae.CGaeParams(jnp.asarray(logits), jnp.asarray(decode))
    tx = optax.adam(4e-3)

    def loss_fn(p, batch, key, tau):
        x_recon, cg_xyz, m = jcgae.cgae_forward(p, batch, key, tau)
        lifted = jnp.einsum("bnk,bkd->bnd", m, cg_xyz)
        return jnp.mean((x_recon - batch) ** 2) + jnp.mean((lifted - batch) ** 2)

    @jax.jit
    def run(params, key):
        def step(carry, i):
            p, o = carry
            k = jax.random.fold_in(key, i)
            tau = jnp.maximum(1.0 - 0.001 * i.astype(jnp.float32), 0.025)
            idx = jax.random.randint(jax.random.fold_in(k, 1), (min(32, f),), 0, f)
            grads = jax.grad(loss_fn)(p, jnp.take(data, idx, axis=0), k, tau)
            updates, o = tx.update(grads, o, p)
            return (optax.apply_updates(p, updates), o), None

        (p, _), _ = jax.lax.scan(step, (params, tx.init(params)), jnp.arange(n_steps))
        return p.assign_logits

    k_scan = jax.random.split(jax.random.PRNGKey(seed))[1]
    return np.asarray(run(params, k_scan))


@pytest.mark.parametrize("seed", [0, 1])
def test_learn_map_core_matches_jax(dipeptide, seed):
    z, frames, _ = dipeptide
    logits0, decode0, idx, u = _jax_draws(frames, 3, seed, N_STEPS)
    data = torch.as_tensor(cgae.centred_frames(frames))
    logits, _ = cgae.learn_map_core(data, torch.as_tensor(logits0), torch.as_tensor(decode0),
                                    zip(torch.as_tensor(idx, dtype=torch.long),
                                        torch.as_tensor(u)))
    want_map = jcgae.learn_map(frames, 3, n_steps=N_STEPS, seed=seed)
    np.testing.assert_array_equal(cgae.hard_mapping(logits), want_map)
    want = _jax_final_logits(frames, logits0, decode0, seed, N_STEPS)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=LOGIT_ATOL * (want.max() - want.min()))


def test_learn_map_on_the_cpu_is_seeded(dipeptide):
    z, frames, _ = dipeptide
    a = cgae.learn_map(frames, 3, n_steps=60, seed=4, device="cpu")
    b = cgae.learn_map(frames, 3, n_steps=60, seed=4, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert a.shape == (z.shape[0],) and set(a) <= {0, 1, 2} and a[0] == 0


def test_hard_mapping_relabels_by_first_occurrence():
    logits = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 0.0, 2.0], [0.0, 3.0, 0.0]])
    np.testing.assert_array_equal(cgae.hard_mapping(logits), [0, 1, 0, 2])


@pytest.mark.parametrize("n,k,beads", [(200, 16, 4), (30, 7, 2), (3, 5, 1)])
def test_repair_mapping_matches_jax(n, k, beads):
    rng = np.random.default_rng(n)
    frames = rng.normal(size=(2, n, 3)).astype(np.float32) * 5.0
    mapping = rng.integers(0, beads, size=n).astype(np.int32)
    if n < k:       # more beads than atoms: both refuse
        for fn in (jmap.repair_mapping, tmap.repair_mapping):
            with pytest.raises(RuntimeError, match="cannot repair"):
                fn(mapping, frames, k)
        return
    got = tmap.repair_mapping(mapping, frames, k)
    np.testing.assert_array_equal(got, jmap.repair_mapping(mapping, frames, k))
    assert (np.bincount(got, minlength=k) > 0).all()


@pytest.mark.parametrize("n,k,covered_at", [(120, 30, None), (40, 4, 2), (40, 4, 0)])
def test_get_mapping_cgae_retry_matches_jax(monkeypatch, n, k, covered_at):
    """The retry over seed + attempt, the early break and the repair
    (tests/test_cgae.py:97-112) with learn_map replaced in both packages:
    every bead is covered only from attempt ``covered_at`` on (never when
    None)."""
    frames = np.random.default_rng(1).normal(size=(2, n, 3)).astype(np.float32)
    calls = {"jax": [], "port": []}

    def fake(name):
        def learn_map(frames, n_cgs, seed=0, **kw):
            calls[name].append(seed)
            rng = np.random.default_rng(seed)
            full = covered_at is not None and seed >= 10 + covered_at
            return (np.arange(n) % n_cgs if full else rng.integers(0, 3, size=n)).astype(np.int32)
        return learn_map

    monkeypatch.setattr("coarsegrainingvae_tpu.models.cgae.learn_map", fake("jax"))
    monkeypatch.setattr(cgae, "learn_map", fake("port"))
    want = jmap.get_mapping("cgae", k, n, frames=frames, seed=10)
    got = tmap.get_mapping("cgae", k, n, frames=frames, seed=10, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert calls["port"] == calls["jax"]
    assert np.unique(got).size == k


def test_run_cgvae_cgae_on_the_cpu(tmp_path, monkeypatch):
    """The README quickstart's -cg_method cgae at a tiny width: each fold
    learns a 3-bead mapping and trains; the cv_stats.csv rows are finite."""
    data = tmp_path / "data"
    data.mkdir()
    z, frames, bonds = jax_peptide("dipeptide", n_frames=40, seed=0)
    save_npz_traj(str(data / "dipeptide.npz"), z, frames, bonds)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(data))
    rows = run_cgvae.main([
        "-cg_method", "cgae", "-n_cgs", "3", "-n_basis", "16", "-n_rbf", "4",
        "-enc_nconv", "1", "-dec_nconv", "1", "-ndata", "40", "-nepochs", "1",
        "-batch_size", "8", "-nsplits", "2", "-max_folds", "1", "-n_ensemble", "2",
        "-nevals", "2", "--dec_type", "pseudo", "--graph_eval", "-logdir", str(tmp_path / "run"),
        "--device", "cpu"])
    (run,) = [p for p in tmp_path.iterdir() if p.name.startswith("run")]
    assert "cgae" in run.name and len(rows) == 1
    mapping = json.loads((run / "fold0" / "mapping.json").read_text())
    assert len(mapping) == z.shape[0] and sorted(set(mapping)) == [0, 1, 2]
    with open(run / "cv_stats.csv", newline="") as f:
        (row,) = list(csv.DictReader(f))
    # sample RMSDs average over valid samples only: NaN when none is valid
    bad = [k for k, v in row.items() if not math.isfinite(float(v))
           and k not in ("sample_all_rmsd", "sample_heavy_rmsd")]
    assert not bad, bad
