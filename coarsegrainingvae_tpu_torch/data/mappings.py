"""CG-mapping protocols.

Host-side (per-fold, once) reimplementations of the reference's mapping
dispatch (get_cg_and_xyz, datasets.py:252-342 of the original code):

  random            -- rejection-sampled uniform assignment (datasets.py:412-420)
  seqpartition      -- random contiguous sequence partition (datasets.py:314-322)
  newman            -- Girvan-Newman community partition of the bond graph
                       (datasets.py:363-385), optional mapshuffle corruption
  backbonepartition -- random cumsum partition of backbone indices + nearest-
                       site assignment for the rest (datasets.py:73-105)
  spectral          -- repo addition: k-means over bond-graph spectral
                       embedding (fast, deterministic alternative to newman)
  minimal / alpha   -- mdtraj atom-index selections; available when mdtraj is
                       installed (gated)
  cgae              -- learned gumbel-softmax autoencoder (models/cgae.py),
                       trained on ``device``, retried with fresh seeds and
                       repaired (repair_mapping) when beads stay empty
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def random_mapping(n_cgs: int, n_atoms: int, seed: int = 0, max_tries: int = 10_000_000) -> np.ndarray:
    """Uniform random assignment, rejected until all beads populated
    (get_random_mapping, datasets.py:412-420)."""
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        mapping = rng.integers(0, n_cgs, size=n_atoms)
        if np.unique(mapping).shape[0] == n_cgs:
            return mapping.astype(np.int32)
    raise RuntimeError("could not sample a mapping covering all CG beads")


def seq_partition(n_cgs: int, n_atoms: int, seed: int = 0) -> np.ndarray:
    """Random contiguous partition of the atom sequence
    (datasets.py:314-322)."""
    rng = np.random.default_rng(seed)
    cut = np.sort(rng.choice(np.arange(n_atoms), size=n_cgs - 1, replace=False))
    mapping = np.zeros(n_atoms)
    mapping[cut] = 1
    return np.cumsum(mapping).astype(np.int32)


def _edge_betweenness(adj_list, n: int) -> dict:
    """Brandes' algorithm for edge betweenness centrality (unweighted)."""
    betweenness: dict = {}
    for u in range(n):
        for v in adj_list[u]:
            if u < v:
                betweenness[(u, v)] = 0.0
    for s in range(n):
        # BFS
        dist = [-1] * n
        sigma = [0.0] * n
        preds = [[] for _ in range(n)]
        dist[s] = 0
        sigma[s] = 1.0
        queue = [s]
        order = []
        head = 0
        while head < len(queue):
            u = queue[head]
            head += 1
            order.append(u)
            for v in adj_list[u]:
                if dist[v] < 0:
                    dist[v] = dist[u] + 1
                    queue.append(v)
                if dist[v] == dist[u] + 1:
                    sigma[v] += sigma[u]
                    preds[v].append(u)
        delta = [0.0] * n
        for w in reversed(order):
            for u in preds[w]:
                c = sigma[u] / sigma[w] * (1.0 + delta[w])
                key = (u, w) if u < w else (w, u)
                betweenness[key] += c
                delta[u] += c
    return betweenness


def _components(adj_list, n: int):
    seen = [False] * n
    comps = []
    for s in range(n):
        if seen[s]:
            continue
        stack = [s]
        seen[s] = True
        comp = []
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in adj_list[u]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
        comps.append(sorted(comp))
    return comps


def newman_mapping(
    bonds: np.ndarray,
    n_atoms: int,
    n_cgs: int,
    mapshuffle: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """Girvan-Newman community partition of the bonded graph
    (get_partition/parition2mapping, datasets.py:363-385), implemented
    directly with Brandes edge betweenness (no networkx dependency).
    Optionally corrupts a fraction of assignments (mapshuffle,
    datasets.py:290-296) for the robustness ablation.
    """
    edges = {(int(a), int(b)) if a < b else (int(b), int(a)) for a, b in bonds}
    adj_list = [[] for _ in range(n_atoms)]
    for a, b in edges:
        adj_list[a].append(b)
        adj_list[b].append(a)

    while len(_components(adj_list, n_atoms)) < n_cgs:
        bt = _edge_betweenness(adj_list, n_atoms)
        if not bt:
            break
        (a, b), _ = max(bt.items(), key=lambda kv: kv[1])
        adj_list[a].remove(b)
        adj_list[b].remove(a)

    comps = _components(adj_list, n_atoms)
    comps = sorted(comps)[:]
    mapping = np.zeros(n_atoms, dtype=np.int32)
    for k, comp in enumerate(comps):
        mapping[comp] = min(k, n_cgs - 1)

    if mapshuffle > 0.0:
        rng = np.random.default_rng(seed)
        n_shuf = int(mapshuffle * n_atoms)
        idx = rng.choice(n_atoms, size=n_shuf, replace=False)
        mapping[idx] = mapping[rng.permutation(idx)]
    return mapping


def backbone_partition_mapping(
    frames: np.ndarray,
    backbone_index: np.ndarray,
    n_cgs: int,
    seed: int = 0,
    skip: int = 100,
) -> np.ndarray:
    """Random partition of the backbone + nearest-CG assignment of the rest
    (backbone_partition, datasets.py:73-105)."""
    rng = np.random.default_rng(seed)
    nb = backbone_index.shape[0]
    if nb < n_cgs:
        raise ValueError(f"n_cgs={n_cgs} larger than n_backbone={nb}")
    if nb == n_cgs:
        part = np.arange(1, n_cgs)
    else:
        part = np.sort(rng.choice(np.arange(nb), size=n_cgs - 1, replace=False))
    bb_map = np.zeros(nb)
    bb_map[part] = 1
    bb_map = np.cumsum(bb_map).astype(np.int64)

    sub = frames[::skip]
    bb_xyz = sub[:, backbone_index]  # (S, nb, 3)
    cg_xyz = np.stack(
        [bb_xyz[:, bb_map == k].mean(axis=1) for k in range(int(bb_map.max()) + 1)],
        axis=1,
    )  # (S, n_cgs, 3)
    d = np.linalg.norm(sub[:, :, None, :] - cg_xyz[:, None, :, :], axis=-1).mean(0)
    return np.argmin(d, axis=-1).astype(np.int32)


def spectral_mapping(bonds: np.ndarray, n_atoms: int, n_cgs: int, seed: int = 0) -> np.ndarray:
    """k-means over the bond-graph Laplacian spectral embedding.

    A fast alternative to Girvan-Newman (which is O(E^2 N); the
    reference accepts its slowness since it runs once per fold,
    SURVEY.md "Hard parts"). Deterministic given the seed.
    """
    adj = np.zeros((n_atoms, n_atoms))
    adj[bonds[:, 0], bonds[:, 1]] = 1
    adj[bonds[:, 1], bonds[:, 0]] = 1
    deg = adj.sum(1)
    with np.errstate(divide="ignore"):
        dinv = np.where(deg > 0, deg**-0.5, 0.0)
    lap = np.eye(n_atoms) - dinv[:, None] * adj * dinv[None, :]
    w, v = np.linalg.eigh(lap)
    emb = v[:, 1 : n_cgs + 1]
    rng = np.random.default_rng(seed)
    centers = emb[rng.choice(n_atoms, n_cgs, replace=False)]
    for _ in range(100):
        d = ((emb[:, None] - centers[None]) ** 2).sum(-1)
        lbl = d.argmin(1)
        new = np.stack(
            [emb[lbl == k].mean(0) if (lbl == k).any() else centers[k] for k in range(n_cgs)]
        )
        if np.allclose(new, centers):
            break
        centers = new
    # relabel by first occurrence for determinism
    remap = {}
    out = np.empty(n_atoms, dtype=np.int32)
    for i, l in enumerate(lbl):
        if l not in remap:
            remap[l] = len(remap)
        out[i] = remap[l]
    return out


_MINIMAL_NAMES = {"N", "CA", "C", "O", "CB"}


def _heavy_backbone_path(z: np.ndarray, bonds: np.ndarray) -> list:
    """Longest heavy-atom path through the bond graph (double BFS: exact on
    trees, diameter path otherwise) -- the graph analogue of the protein
    backbone for topologies that carry no atom names."""
    z = np.asarray(z)
    heavy = np.nonzero(z > 1)[0]
    hset = set(int(i) for i in heavy)
    adj: dict = {int(i): [] for i in heavy}
    for a, b in np.asarray(bonds):
        a, b = int(a), int(b)
        if a in hset and b in hset:
            adj[a].append(b)
            adj[b].append(a)

    def bfs(s):
        parent = {s: -1}
        order = [s]
        head = 0
        while head < len(order):
            u = order[head]
            head += 1
            for v in adj[u]:
                if v not in parent:
                    parent[v] = u
                    order.append(v)
        return order[-1], parent

    if not heavy.size:
        raise ValueError("no heavy atoms in topology")
    u, _ = bfs(int(heavy[0]))
    v, parent = bfs(u)
    path = [v]
    while parent[path[-1]] != -1:
        path.append(parent[path[-1]])
    return path[::-1]


def derive_site_index(
    method: str,
    z: Optional[np.ndarray] = None,
    bonds: Optional[np.ndarray] = None,
    atom_names: Optional[list] = None,
) -> np.ndarray:
    """Topology-derived CG site atoms for the 'minimal'/'alpha' protocols.

    The reference gets these from mdtraj selections on the trajectory
    topology (traj.top.select_atom_indices(cg_method),
    CoarseGrainingVAE/datasets.py:262-272): 'alpha' is the
    C-alpha of every residue, 'minimal' the heavy backbone markers
    {N, CA, C, O, CB}. Two derivations, no MD library required:

    * atom_names given (PDB-parsed / SidechainNet data, utils/pdb.py +
      data/sidechain.py carry per-atom names): the exact same selections.
    * z + bonds only (synthetic ensembles, npz caches): the backbone is the
      longest heavy-atom path of the bond graph; 'alpha' picks one site per
      3 backbone atoms (the N-CA-C period of a peptide backbone, preferring
      carbons within each triplet) and 'minimal' takes the backbone plus
      its first-shell heavy substituents (the CB/carbonyl-O analogues).
    """
    if atom_names is not None:
        names = [str(nm) for nm in atom_names]
        if method == "alpha":
            sites = [i for i, nm in enumerate(names) if nm == "CA"]
        else:
            sites = [i for i, nm in enumerate(names) if nm in _MINIMAL_NAMES]
        if not sites:
            raise ValueError(
                f"no {method!r} site atoms found in atom_names"
            )
        return np.asarray(sites, np.int64)

    if z is None or bonds is None:
        raise ValueError(
            f"derive_site_index({method!r}) needs atom_names or (z, bonds)"
        )
    z = np.asarray(z)
    path = _heavy_backbone_path(z, bonds)
    if method == "alpha":
        sites = []
        for k in range(0, len(path), 3):
            triplet = path[k : k + 3]
            carbons = [i for i in triplet if z[i] == 6]
            mid = triplet[min(1, len(triplet) - 1)]
            sites.append(carbons[0] if carbons and z[mid] != 6 else mid)
        return np.asarray(sites, np.int64)
    # minimal: backbone + first-shell heavy substituents
    on_path = set(path)
    first_shell = set()
    for a, b in np.asarray(bonds):
        a, b = int(a), int(b)
        if a in on_path and b not in on_path and z[b] > 1:
            first_shell.add(b)
        if b in on_path and a not in on_path and z[a] > 1:
            first_shell.add(a)
    return np.asarray(sorted(on_path | first_shell), np.int64)


def nearest_site_mapping(
    frames: np.ndarray, site_idx: np.ndarray
) -> np.ndarray:
    """Assign every atom to its nearest CG site, averaged over frames.

    The 'minimal' and 'alpha' protocols (datasets.py:252-312) pick explicit
    site atoms (mdtraj selections: heavy backbone markers resp. C-alphas)
    and map the remaining atoms to the nearest site. Sites here come in as
    atom indices, so the protocol works without mdtraj.
    """
    frames = np.asarray(frames, np.float32)
    site_idx = np.asarray(site_idx, np.int64)
    d = np.linalg.norm(
        frames[:, :, None, :] - frames[:, site_idx][:, None, :, :], axis=-1
    ).mean(axis=0)                          # (N, K) frame-averaged distance
    mapping = d.argmin(axis=1).astype(np.int32)
    mapping[site_idx] = np.arange(site_idx.shape[0], dtype=np.int32)
    return mapping


def repair_mapping(
    mapping: np.ndarray, frames: np.ndarray, n_cgs: int
) -> np.ndarray:
    """Fill empty CG beads by splitting the largest populated beads.

    learn_map rarely populates every bead once n_cgs is large (many
    assignment columns never win an argmax), where the original code's
    unbounded retry (run_ala.py:170-174) never ends. For each empty bead,
    take the currently largest bead, find its atom farthest from the bead
    centroid (on the first frame), and move that atom plus every bead-mate
    closer to it than to the centroid into the empty bead: a farthest-point
    bipartition that populates the bead and lowers the worst-case
    atoms-per-bead. Deterministic; O(n_empty * N).
    """
    mapping = np.asarray(mapping).astype(np.int32).copy()
    xyz = np.asarray(frames, np.float32)[0]
    sizes = np.bincount(mapping, minlength=n_cgs)
    for empty in np.where(sizes == 0)[0]:
        donor = int(sizes.argmax())
        members = np.where(mapping == donor)[0]
        if members.size < 2:  # nothing left to split (n_cgs > n_atoms)
            raise RuntimeError(
                f"cannot repair mapping: {n_cgs} beads for {mapping.size} atoms"
            )
        centroid = xyz[members].mean(axis=0)
        d_cen = np.linalg.norm(xyz[members] - centroid, axis=-1)
        far = xyz[members[d_cen.argmax()]]
        d_far = np.linalg.norm(xyz[members] - far, axis=-1)
        moved = members[d_far < d_cen]
        if moved.size == 0:  # degenerate geometry (all members coincide)
            moved = members[d_cen.argmax(): d_cen.argmax() + 1]
        elif moved.size == members.size:  # keep the donor populated
            moved = np.delete(moved, d_cen.argmin())
        mapping[moved] = empty
        sizes[donor] -= moved.size
        sizes[empty] += moved.size
    return mapping


def get_mapping(
    method: str,
    n_cgs: int,
    n_atoms: int,
    bonds: Optional[np.ndarray] = None,
    frames: Optional[np.ndarray] = None,
    backbone_index: Optional[np.ndarray] = None,
    site_index: Optional[np.ndarray] = None,
    mapshuffle: float = 0.0,
    seed: int = 0,
    z: Optional[np.ndarray] = None,
    atom_names: Optional[list] = None,
    device="cuda",
) -> np.ndarray:
    """Dispatch mirroring get_cg_and_xyz (datasets.py:252-342). Only 'cgae',
    which trains a model, reads ``device`` (the card unless the caller
    passes "cpu")."""
    if method == "random":
        return random_mapping(n_cgs, n_atoms, seed)
    if method == "seqpartition":
        return seq_partition(n_cgs, n_atoms, seed)
    if method == "newman":
        assert bonds is not None
        return newman_mapping(bonds, n_atoms, n_cgs, mapshuffle, seed)
    if method == "backbonepartition":
        assert frames is not None and backbone_index is not None
        return backbone_partition_mapping(frames, backbone_index, n_cgs, seed)
    if method == "spectral":
        assert bonds is not None
        return spectral_mapping(bonds, n_atoms, n_cgs, seed)
    if method in ("minimal", "alpha"):
        # explicit site atoms + nearest-site assignment (datasets.py:252-312);
        # 'alpha' sites are C-alphas, 'minimal' a sparse heavy-atom pick --
        # both arrive as site_index so no MD library is required
        assert frames is not None
        if site_index is None:
            if atom_names is not None or (z is not None and bonds is not None):
                # reference protocol: sites come from the topology itself,
                # and the user-specified n_cgs is OVERWRITTEN by the site
                # count (datasets.py:262-264 prints exactly that note)
                site_index = derive_site_index(
                    method, z=z, bonds=bonds, atom_names=atom_names
                )
            else:
                # evenly spaced atom-INDEX fallback -- NOT the reference
                # protocol. Loud by design: results from this path are not
                # comparable to the reference's minimal/alpha runs.
                import warnings

                warnings.warn(
                    f"mapping method {method!r} got neither site_index nor "
                    "topology (z+bonds / atom_names); falling back to "
                    "evenly-spaced atom indices, which is NOT the reference "
                    "protocol.",
                    stacklevel=2,
                )
                site_index = np.linspace(0, n_atoms - 1, n_cgs).astype(np.int64)
        return nearest_site_mapping(frames, np.asarray(site_index))
    if method == "cgae":
        # learned mapping autoencoder; retry with fresh seeds until every bead
        # is populated (the degeneracy retry of run_ala.py:170-174), then repair
        from coarsegrainingvae_tpu_torch.models import cgae

        assert frames is not None
        best, best_empty = None, n_cgs + 1
        for attempt in range(10):
            mapping = cgae.learn_map(frames, n_cgs, seed=seed + attempt, device=device)
            n_empty = n_cgs - np.unique(mapping).size
            if n_empty == 0:
                return mapping
            if n_empty < best_empty:
                best, best_empty = mapping, n_empty
            if attempt >= 2 and best_empty > max(1, n_cgs // 100):
                # hundreds of beads: an argmax assignment essentially never
                # populates every bead, so go straight to the repair
                break
        return repair_mapping(best, frames, n_cgs)
    raise ValueError(f"mapping method {method!r} not handled here")
