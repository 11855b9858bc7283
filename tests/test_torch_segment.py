"""The port's segment sums against ``jax.ops.segment_sum``, their
determinism, and the receiver-sorted edge invariant they rely on.

``ops/segment.py`` is a CSR reduction over sorted ids (``searchsorted``
offsets, ``torch.segment_reduce``), so the sparse model's sums carry the
same bits on every call. Its receivers are sorted because the data
pipeline emits receiver-sorted edge lists padded at the tail with
``(n-1, n-1)`` self-loops; the port's ``radius_graph_frames`` must give the
JAX package's arrays exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.data.neighbors import radius_graph_frames as jax_radius_graph
from coarsegrainingvae_tpu.ops import segment as jseg
from coarsegrainingvae_tpu_torch.data.batch import flatten_ids
from coarsegrainingvae_tpu_torch.data.neighbors import radius_graph_frames
from coarsegrainingvae_tpu_torch.ops import segment as tseg

torch.set_num_threads(1)

# f32 sums of the same rows in another order
TOL = dict(rtol=1e-5, atol=1e-6)


def _case(seed, sorted_ids, n_seg=7, e=40, tail=(3, 5)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_seg - 1, size=e)        # the last segment stays empty
    if sorted_ids:
        ids = np.sort(ids)
    data = rng.normal(size=(e,) + tail).astype(np.float32)
    mask = rng.random(e) > 0.25
    return data, ids.astype(np.int64), mask, n_seg


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_segment_sum_matches_jax(sorted_ids, masked):
    data, ids, mask, n_seg = _case(0, sorted_ids)
    m = mask if masked else None
    want = jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids, jnp.int32), n_seg,
                            None if m is None else jnp.asarray(m),
                            indices_are_sorted=sorted_ids)
    got = tseg.segment_sum(torch.as_tensor(data), torch.as_tensor(ids), n_seg,
                           None if m is None else torch.as_tensor(m),
                           indices_are_sorted=sorted_ids)
    assert got.shape == (n_seg, 3, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got[-1].numpy(), 0.0)      # an empty segment sums to 0


@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_mean_matches_jax(sorted_ids):
    data, ids, mask, n_seg = _case(1, sorted_ids, tail=(4,))
    want = jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids, jnp.int32), n_seg,
                             jnp.asarray(mask))
    got = tseg.segment_mean(torch.as_tensor(data), torch.as_tensor(ids), n_seg,
                            torch.as_tensor(mask), indices_are_sorted=sorted_ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.isfinite(got.numpy()).all()


def test_segment_sum_gradient_matches_jax():
    data, ids, mask, n_seg = _case(2, False)
    ct = np.random.default_rng(3).normal(size=(n_seg, 3, 5)).astype(np.float32)
    want = jax.grad(lambda d: jnp.sum(jseg.segment_sum(
        d, jnp.asarray(ids, jnp.int32), n_seg, jnp.asarray(mask)) * ct))(jnp.asarray(data))
    x = torch.as_tensor(data).requires_grad_(True)
    (tseg.segment_sum(x, torch.as_tensor(ids), n_seg, torch.as_tensor(mask))
     * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_sum_is_deterministic(sorted_ids):
    """Two calls, and two backward passes, give the same bits."""
    rng = np.random.default_rng(4)
    e, n_seg = 5000, 300
    ids = rng.integers(0, n_seg, size=e)
    ids = torch.as_tensor(np.sort(ids) if sorted_ids else ids)
    data = torch.as_tensor(rng.normal(size=(e, 3, 16)).astype(np.float32) * 1e3)
    outs, grads = [], []
    for _ in range(2):
        x = data.clone().requires_grad_(True)
        out = tseg.segment_sum(x, ids, n_seg, indices_are_sorted=sorted_ids)
        (out * out).sum().backward()
        outs.append(out.detach())
        grads.append(x.grad)
    assert torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])


def test_radius_graph_matches_jax_and_is_receiver_sorted(small_dataset):
    """The port's radius graphs equal the JAX package's arrays, the
    receiver column is sorted within every frame and stays sorted once
    flatten_ids offsets the batch, and the padding is (n-1, n-1)."""
    frames = np.asarray(small_dataset.xyz[:6])
    n = frames.shape[1]
    for cutoff, max_edges in ((8.5, None), (3.0, None), (8.5, 1024)):
        want = jax_radius_graph(frames, cutoff, max_edges=max_edges, directed=True)
        got = radius_graph_frames(frames, cutoff, max_edges=max_edges, directed=True)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        edges, mask = got
        assert (np.diff(edges[..., 0], axis=1) >= 0).all()
        assert (edges[~mask] == n - 1).all()
        flat = flatten_ids(torch.as_tensor(edges, dtype=torch.long), n)
        assert bool((flat[1:, 0] >= flat[:-1, 0]).all())
    np.testing.assert_array_equal(small_dataset.nbrs[:6], radius_graph_frames(
        frames, 8.5, max_edges=small_dataset.nbrs.shape[1])[0])
