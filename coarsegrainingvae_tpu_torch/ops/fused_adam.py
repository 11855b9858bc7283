"""The optimizer step, fused: the skip-batch guard, the global-norm clip,
Adam with both moments in the moment dtype and the apply, as one
hand-written CUDA pass (``csrc/fused_adam.cu``) over device memory, and its
plain twin.

It replaces no TPU kernel: the JAX package's optimizer is plain ``jnp``
that XLA fuses. As PyTorch ops (``fused_adam_reference``) the step is about
25 full-length elementwise passes over the flat parameters; the kernel
reads the gradient twice (its norm, then the update) and the parameters and
moments once, and writes them back in place.

    fused_adam(params, g, loss, count, mu, nu, lr, thresh, max_norm, b1, b2, eps)
        -> (count, mu, nu, ok)

``g`` is the flat gradient of ``params`` in order (float32), ``mu`` and
``nu`` the flat moments (float32 or bfloat16), ``count`` the int32 count
of accepted steps, ``loss`` a 0-d float32 tensor and ``lr`` one too, or a
number (the eager trainers keep it on the host). The batch is
accepted (``ok``) if its loss is finite and below ``thresh`` and the
gradient's norm is finite; then the gradient is clipped to ``max_norm``,
Adam's moments and update are computed in float32 and every parameter
moves by -lr * update. A rejected batch leaves parameters, moments and
count as they were.

CUDA tensors launch the kernel (counted in ``ops.LAUNCHES``) and are
updated in place: the returned count and moments are the ones passed in;
inputs it does not take (float64, say) raise. CPU tensors take
``fused_adam_reference``, which returns new count and moments and leaves
those passed in untouched. There is no other fallback.

``fused_global_norm`` is the kernel's norm alone (counted as
``fused_global_norm``): ZeRO-1 clips its slice with it, so that
its step keeps the bits of the replicated one.

The kernel finds the parameters through a chunk table (``chunk_table``):
per chunk the address of its first parameter element, its flat offset, its
length and flags; a chunk never crosses a parameter. Every update is in
place, so the addresses never change: the table is built once per moments
tensor, on the device, outside any capture.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from coarsegrainingvae_tpu_torch.ops import LAUNCHES, cuda_build

VEC = 8           # elements a thread takes a pass (csrc/fused_adam.cu::kVec)
CHUNK = 8192      # most elements of a chunk: one block's work; a multiple of VEC
BF16, VECTOR = 1, 2   # chunk flags (csrc/fused_adam.cu::ChunkFlags)
MOMENT_DTYPES = (torch.float32, torch.bfloat16)
PARAM_DTYPES = (torch.float32, torch.bfloat16)


# ------------------------------------------------------------ plain version
def global_norm(flat: torch.Tensor) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(torch.sum(flat * flat))


def clip_by_global_norm(flat: torch.Tensor, max_norm: float,
                        g_norm: torch.Tensor) -> torch.Tensor:
    """optax.clip_by_global_norm given the norm: g if norm < max, else
    g / norm * max (no epsilon, unlike torch.nn.utils.clip_grad_norm_)."""
    return torch.where(g_norm < max_norm, flat, (flat / g_norm) * max_norm)


def scale_by_adam(g: torch.Tensor, count: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                  b1: float, b2: float, eps: float, moment_dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adam's scaling with the update math in float32 and both moments
    stored in ``moment_dtype``: (update, count + 1, new mu, new nu)."""
    count = count + 1
    c1 = 1.0 - b1 ** count.to(torch.float32)
    c2 = 1.0 - b2 ** count.to(torch.float32)
    m32 = b1 * mu.to(torch.float32) + (1.0 - b1) * g
    n32 = b2 * nu.to(torch.float32) + (1.0 - b2) * (g * g)
    upd = (m32 / c1) / (torch.sqrt(n32 / c2) + eps)
    return upd, count, m32.to(moment_dtype), n32.to(moment_dtype)


def add_updates_(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]) -> None:
    """params[i] += updates[i], in place. Parameters of the updates' dtype
    take one foreach launch; the others (the compute-dtype filters, which
    the JAX package keeps in bf16 at bf16 compute) one add each, computed
    in float32 and rounded once to the parameter's dtype, as
    ``optax.apply_updates`` does. One foreach over mixed dtypes would fall
    back to a launch per parameter."""
    same = [(p, u) for p, u in zip(params, updates) if p.dtype == u.dtype]
    if same:
        torch._foreach_add_([p for p, _ in same], [u for _, u in same])
    for p, u in zip(params, updates):
        if p.dtype != u.dtype:
            p.add_(u)


def accepted(loss: torch.Tensor, thresh: float, g_norm: torch.Tensor) -> torch.Tensor:
    """The skip-batch guard: loss finite and below ``thresh``, norm finite."""
    return torch.isfinite(loss) & (loss < thresh) & torch.isfinite(g_norm)


def fused_adam_reference(params: Sequence[torch.Tensor], g: torch.Tensor, loss: torch.Tensor,
                         count: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, lr,
                         thresh: float, max_norm: float, b1: float, b2: float, eps: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: the parameters move in place; (count, mu, nu,
    ok) are new tensors, those passed in untouched. A rejected batch's
    update and moments are discarded with torch.where, which passes over
    NaN and inf, so its gradient need not be zeroed first."""
    with torch.no_grad():
        g_norm = global_norm(g)
        ok = accepted(loss, thresh, g_norm)
        upd, new_count, new_mu, new_nu = scale_by_adam(
            clip_by_global_norm(g, max_norm, g_norm), count, mu, nu, b1, b2, eps, mu.dtype)
        upd = torch.where(ok, -lr * upd, 0.0)
        add_updates_(params, [u.view_as(p) for u, p in zip(
            torch.split(upd, [p.numel() for p in params]), params)])
        return (torch.where(ok, new_count, count), torch.where(ok, new_mu, mu),
                torch.where(ok, new_nu, nu), ok)


# -------------------------------------------------------------- the table
def chunk_table(params: Sequence[Tuple[int, int, int]]) -> List[Tuple[int, int, int, int]]:
    """The kernel's chunk table for parameters given as (address, numel,
    element size in bytes; 2 means bfloat16), in flat order: rows
    (address of the chunk's first element, flat offset, length, flags).

    A parameter whose flat offset is not a multiple of VEC starts with a
    head chunk of scalar elements up to the next multiple; the rest is cut
    into chunks of at most CHUNK, each starting at a flat offset that is a
    multiple of VEC. Such a chunk is VECTOR when its parameter address is
    16-byte aligned (then so is every later chunk of the parameter, CHUNK
    elements being a multiple of 16 bytes); the kernel takes its elements
    VEC at a time and its last len % VEC one at a time. The flat gradient
    and moments are 16-byte aligned (the wrapper checks), so a VECTOR chunk
    reads and writes all four in 16-byte accesses."""
    rows = []
    flat = 0
    for addr, numel, size in params:
        kind = BF16 if size == 2 else 0
        head = min(-flat % VEC, numel)
        if head:
            rows.append((addr, flat, head, kind))
        vector = VECTOR if (addr + head * size) % 16 == 0 else 0
        for start in range(head, numel, CHUNK):
            rows.append((addr + start * size, flat + start, min(CHUNK, numel - start),
                         kind | vector))
        flat += numel
    return rows


# ------------------------------------------------------------- the kernel
_SYMBOLS = {
    "fused_adam_layout": ([ctypes.c_void_p], None),
    "fused_adam_step": (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_float] * 7 + [ctypes.c_void_p] * 3,
        ctypes.c_int,
    ),
    "fused_adam_norm": ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p],
                        ctypes.c_int),
}

# per moments tensor: (the parameters' (address, numel, dtype), the table
# on the device); the table lives as long as the moments it serves
_TABLES = WeakIdKeyDictionary()
_LAYOUT: List[int] = []        # scratch floats, the norm's slot, the vector width


def build() -> ctypes.CDLL:
    """Build (first call only) and load ``csrc/fused_adam.cu``."""
    lib = cuda_build.load("fused_adam", _SYMBOLS)
    if not _LAYOUT:
        out = (ctypes.c_int * 3)()
        lib.fused_adam_layout(out)
        if out[2] != VEC:
            raise RuntimeError(f"fused_adam.cu takes {out[2]} elements a pass, the table "
                               f"is cut for {VEC}")
        _LAYOUT[:] = list(out)
    return lib


def _table(params: Sequence[torch.Tensor], mu: torch.Tensor) -> torch.Tensor:
    key = tuple((p.data_ptr(), p.numel(), p.dtype) for p in params)
    hit = _TABLES.get(mu)
    if hit is not None and hit[0] == key:
        return hit[1]
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("fused_adam: the chunk table of these parameters is built outside "
                           "a capture; run one step eagerly first")
    rows = chunk_table([(p.data_ptr(), p.numel(), p.element_size()) for p in params])
    table = torch.tensor(rows, dtype=torch.int64).reshape(-1, 4).to(mu.device)
    _TABLES[mu] = (key, table)
    return table


def _vector(t: torch.Tensor) -> bool:
    """A contiguous, 16-byte aligned 1-D float32 vector."""
    return (t.dim() == 1 and t.dtype == torch.float32 and t.is_contiguous()
            and t.data_ptr() % 16 == 0)


def check_inputs(params, g, loss, count, mu, nu, lr) -> None:
    """Raise on inputs the kernel does not take (module docstring)."""
    device = g.device
    if not _vector(g):
        raise ValueError("fused_adam: g must be a contiguous, 16-byte aligned 1-D float32 "
                         f"vector, got {tuple(g.shape)} {g.dtype}")
    for name, t in (("mu", mu), ("nu", nu)):
        if t.device != device or t.dtype not in MOMENT_DTYPES or t.shape != g.shape \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_adam: {name} must be a contiguous, 16-byte aligned "
                             f"float32 or bfloat16 vector of g's {g.numel()} entries on "
                             f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if nu.dtype != mu.dtype:
        raise TypeError(f"fused_adam: mu is {mu.dtype}, nu {nu.dtype}")
    for name, t, dtype in (("count", count, torch.int32), ("loss", loss, torch.float32),
                           ("lr", lr, torch.float32)):
        if not isinstance(t, torch.Tensor) or t.device != device or t.dtype != dtype \
                or t.numel() != 1:
            raise ValueError(f"fused_adam: {name} must be a one-element {dtype} tensor on "
                             f"{device}")
    for i, p in enumerate(params):
        if p.device != device or p.dtype not in PARAM_DTYPES or not p.is_contiguous():
            raise ValueError(f"fused_adam: parameter {i} must be a contiguous float32 or "
                             f"bfloat16 tensor on {device}, got {p.dtype} on {p.device}")
    if sum(p.numel() for p in params) != g.numel():
        raise ValueError(f"fused_adam: the parameters hold {sum(p.numel() for p in params)} "
                         f"entries, g {g.numel()}")


def lr_tensor(lr, device: torch.device):
    """A learning rate given as a number, as the 0-d float32 tensor on
    ``device`` that the kernel reads; a tensor as it is."""
    if isinstance(lr, torch.Tensor):
        return lr
    return torch.full((), lr, dtype=torch.float32, device=device)


def fused_adam(params: Sequence[torch.Tensor], g: torch.Tensor, loss: torch.Tensor,
               count: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, lr, thresh: float,
               max_norm: float, b1: float, b2: float, eps: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One guarded, clipped Adam step (module docstring): (count, mu, nu,
    ok). CUDA tensors launch the kernel and are updated in place; CPU
    tensors take ``fused_adam_reference``."""
    if not g.is_cuda:
        return fused_adam_reference(params, g, loss, count, mu, nu, lr, thresh, max_norm,
                                    b1, b2, eps)
    params = list(params)
    lr = lr_tensor(lr, g.device)
    check_inputs(params, g, loss, count, mu, nu, lr)
    lib = build()
    table = _table(params, mu)
    scratch = torch.empty(_LAYOUT[0], dtype=torch.float32, device=g.device)
    ok = torch.empty((), dtype=torch.bool, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.fused_adam_step(
            g.data_ptr(), g.numel(), table.data_ptr(), table.shape[0], mu.data_ptr(),
            nu.data_ptr(), int(mu.dtype == torch.bfloat16), count.data_ptr(), loss.data_ptr(),
            lr.data_ptr(), thresh, max_norm, b1, 1.0 - b1, b2, 1.0 - b2, eps,
            scratch.data_ptr(), ok.data_ptr(), torch.cuda.current_stream(g.device).cuda_stream)
    cuda_build.check(err, "fused_adam_step")
    LAUNCHES["fused_adam"] += 1
    return count, mu, nu, ok


def fused_global_norm(g: torch.Tensor) -> torch.Tensor:
    """The kernel's norm of a float32 vector on the card, as a 0-d tensor:
    the bits ``fused_adam`` clips with."""
    if not _vector(g):
        raise ValueError("fused_global_norm: g must be a contiguous, 16-byte aligned 1-D "
                         f"float32 vector, got {tuple(g.shape)} {g.dtype}")
    lib = build()
    scratch = torch.empty(_LAYOUT[0], dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.fused_adam_norm(g.data_ptr(), g.numel(), scratch.data_ptr(),
                                  torch.cuda.current_stream(g.device).cuda_stream)
    cuda_build.check(err, "fused_adam_norm")
    LAUNCHES["fused_global_norm"] += 1
    return scratch[_LAYOUT[1]]


def kernel_bytes(params: Sequence[torch.Tensor], moment_dtype: torch.dtype,
                 flat_gradient: bool = True) -> int:
    """The bytes the step must move: the gradient read for its norm and
    again for the update, parameters and moments read and written once;
    with ``flat_gradient`` also the concatenation that makes the flat
    gradient (each gradient read, the flat vector written)."""
    p_bytes = sum(p.numel() * p.element_size() for p in params)
    n = sum(p.numel() for p in params)
    moment = torch.empty((), dtype=moment_dtype).element_size()
    total = 2 * 4 * n + 2 * p_bytes + 4 * moment * n
    if flat_gradient:
        total += p_bytes + 4 * n
    return total
