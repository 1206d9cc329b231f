"""Attention forward and backward: CUDA kernels and their plain versions.

Whole-sequence path (square T <= ``VMEM_PATH_MAX_T``), the JAX package's
``ops/flash_attention.py:152-242``:

* ``fused_attention`` ports the forward (``:177 _fused_fwd_impl``, kernel
  ``_vmem_fwd_kernel`` at ``:60``): on a CUDA tensor it launches
  ``csrc/flash_attention_fwd.cu`` or raises; on a CPU tensor it runs
  ``fused_attention_reference``. Its bfloat16 kernel is
  ``flash_fwd_wgmma_kernel`` of ``csrc/flash_fwd_sm90.cuh`` (wgmma, two
  producer warps feeding an mbarrier ring of cp.async K/V tiles), its
  float32 kernel ``flash_fwd_kernel`` of ``csrc/flash_fwd.cuh`` on the CUDA
  cores. Both
  return ``(o, lse)``: o [B, T, H, D] in q's dtype and the float32
  log-sum-exp in the JAX layout [B*H, 1, T].
* ``fused_attention_bwd`` ports the backward (``:215 _fused_bwd``, kernel
  ``_vmem_bwd_kernel`` at ``:86``): ``csrc/flash_attention_bwd.cu`` on a CUDA
  tensor, ``fused_attention_bwd_reference`` on a CPU tensor. Its bfloat16
  dK/dV and dQ passes are the wgmma kernels of ``csrc/flash_bwd_sm90.cuh``
  that the blocked backward runs, with Tq = Tk = T.
* ``FusedAttention`` wires the two as a ``torch.autograd.Function`` that
  keeps exactly the JAX custom VJP's residuals (q, k, v, o, lse).

Blocked path (any Tq, Tk; keys at or past ``kv_len`` masked), the JAX
package's ``:245-517``:

* ``blocked_fused_attention`` ports ``_blocked_fwd_impl`` (``:410``, kernel
  ``_blocked_fwd_kernel`` at ``:256``): ``csrc/flash_attention_blocked_fwd.cu``
  on a CUDA tensor (the same two kernels as ``fused_attention``),
  ``blocked_attention_reference`` on a CPU tensor; returns
  ``(o, lse)`` with o [B, Tq, H, D] and lse float32 [B*H, 1, Tq] (the JAX
  residual is padded to its block size; this one is not).
* ``blocked_attention_dkv`` (kernel ``_blocked_dkv_kernel``, ``:292``) and
  ``blocked_attention_dq`` (``_blocked_dq_kernel``, ``:342``) port the two
  backward passes of ``_blocked_bwd`` (``:455``); both are entries of
  ``csrc/flash_attention_blocked_bwd.cu``, whose bfloat16 kernels (wgmma, an
  mbarrier ring of cp.async tiles) are in ``csrc/flash_bwd_sm90.cuh``.
* ``BlockedFusedAttention`` wires them as a ``torch.autograd.Function`` with
  the JAX custom VJP's residuals; its backward computes delta = rowsum(dO * O)
  once from the stored O with one torch reduction (``attention_delta``), as
  ``_blocked_bwd`` does at ``:462``, then runs the two passes.
* ``flash_attention`` (``:520``) sends square T <= ``VMEM_PATH_MAX_T`` to
  ``FusedAttention`` and everything else to ``BlockedFusedAttention``.

The JAX package's block sizes (``_blocked_block_sizes``, ``BLOCK_Q`` and
``BLOCK_K``) are TPU tuning and no spec for the port: the CUDA kernels use
their own tiles: 128 query rows per block and 64-key tiles in the bfloat16
forward, 64 rows elsewhere (32-row walked tiles in B4 at head dims above 64).
On the CPU every backward is the plain backward, so the CPU tests exercise
the kernels' contract rather than autograd through matmuls. The blocked plain versions walk the sequence in chunks of
``_REF_CHUNK`` rows, so no [T, T] tensor of a long sequence is made whole.

Each wrapper counts its CUDA launches in ``<wrapper>.launches``; the plain
versions are not counted.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from headct_foundation_tpu_torch.ops import _build

# Square sequences up to this length take the whole-sequence kernels (the JAX
# package's VMEM_PATH_MAX_T); longer or rectangular ones the blocked kernels.
# Read at call time, so a test can lower it.
VMEM_PATH_MAX_T = 1024
# Rows of q (or keys, for dK/dV) that a blocked plain version takes at once.
_REF_CHUNK = 512

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# C entry -> (library, pointer arguments, stride/shape arguments)
_C_ENTRIES = {
    "flash_attention_fwd": ("flash_attention_fwd", 5, 13),
    "flash_attention_bwd": ("flash_attention_bwd", 10, 19),
    "flash_attention_blocked_fwd": ("flash_attention_blocked_fwd", 5, 15),
    "flash_attention_blocked_dkv": ("flash_attention_blocked_bwd", 8, 18),
    "flash_attention_blocked_dq": ("flash_attention_blocked_bwd", 7, 18),
    # the token-major pair of tools/experimental_tm_attention.py (B7, B8)
    "tm_attention_fwd": ("tm_attention", 5, 4),
    "tm_attention_bwd": ("tm_attention", 10, 4),
}


@functools.lru_cache(maxsize=None)
def _c_entry(name: str):
    """A kernel's C entry point, its library built and loaded at first use."""
    library, n_ptr, n_int = _C_ENTRIES[name]
    fn = getattr(_build.load(library), f"headct_{name}")
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * n_int
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, q: torch.Tensor, *args) -> None:
    """Call a C entry with the trailing (dtype, current stream) and raise on
    a failed launch."""
    rc = _c_entry(name)(*args, _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc} at q "
                           f"{tuple(q.shape)} {q.dtype}")


def _scale(d: int, scale: Optional[float]) -> float:
    return float(d) ** -0.5 if scale is None else float(scale)


def _bhtd(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> float32 [B, H, T, D]."""
    return x.permute(0, 2, 1, 3).float()


def _bthd(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 [B, H, T, D] -> [B, T, H, D] in ``dtype``."""
    return x.permute(0, 2, 1, 3).to(dtype)


def fused_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: scores in float32 from operand-dtype inputs,
    P rounded to the operand dtype before P.V, the TPU kernel's guards."""
    B, T, H, D = q.shape
    s = _scale(D, scale)
    qh, kh, vh = (_bhtd(x) for x in (q, k, v))  # [B, H, T, D]
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * s
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), vh) / l
    lse = (m + torch.log(l)).reshape(B * H, 1, T)
    return _bthd(o, q.dtype), lse


def fused_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel, at its rounding points:
    P = exp(scale QK^T - LSE) in float32, rounded to the operand dtype for
    dV = P^T dO only; delta = rowsum(dO * O) from the stored O;
    dS = P (dO V^T - delta) rounded to the operand dtype before both of its
    products; dQ = scale dS K, dK = scale dS^T Q. Returns (dq, dk, dv)
    [B, T, H, D] in q's dtype."""
    B, T, H, D = q.shape
    s = _scale(D, scale)
    qh, kh, vh, oh, gh = (_bhtd(x) for x in (q, k, v, o, do))
    p = torch.exp(s * torch.matmul(qh, kh.transpose(-1, -2)) - lse.reshape(B, H, T, 1))
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    delta = (gh * oh).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = s * torch.matmul(ds, kh)
    dk = s * torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(_bthd(x, q.dtype) for x in (dq, dk, dv))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str = "fused_attention",
           kv_len: Optional[int] = None, square: bool = True) -> int:
    """Raise on what the kernels do not take; returns kv_len (default Tk).
    ``square``: the whole-sequence kernels' equal shapes, T <= VMEM_PATH_MAX_T."""
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 q/k/v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or q.shape[0] != k.shape[0] \
            or q.shape[2:] != k.shape[2:] or (square and q.shape != k.shape):
        raise ValueError(f"{name} takes {'equal ' if square else ''}[B, T, H, D] shapes, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    tk = k.shape[1]
    max_t = VMEM_PATH_MAX_T if square else 2**31 - 65
    if not (1 <= T <= max_t and 1 <= tk <= max_t) or D % 4 or not (4 <= D <= 128) \
            or B * H > 65535:
        raise ValueError(f"{name} kernel takes T <= {max_t}, D a multiple of 4 up to 128 and "
                         f"B*H <= 65535; got {tuple(q.shape)}, {tuple(k.shape)}")
    kv_len = tk if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= tk:  # the JAX package asserts the same (:416)
        raise ValueError(f"{name} needs 1 <= kv_len <= Tk = {tk}, got kv_len {kv_len}")
    for n, x in (("q", q), ("k", k), ("v", v)):
        if not _kernel_layout(x):
            raise ValueError(
                f"{name} kernel needs {n} with a unit head-dim stride, "
                f"(batch, token, head) strides that are multiples of 4 and a "
                f"{4 * x.element_size()}-byte aligned start; got strides {x.stride()}")
    return kv_len


def _kernel_layout(x: torch.Tensor) -> bool:
    """True where the kernels can read x through its strides: a unit
    head-dim stride, other strides multiples of 4 and a start aligned to
    one 4-element vector load."""
    return (x.stride(3) == 1 and not any(st % 4 for st in x.stride()[:3])
            and x.data_ptr() % (4 * x.element_size()) == 0)


def _on(q: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises elsewhere."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    return q.device.type == "cuda"


def _strides(*xs: torch.Tensor) -> list:
    return [st for x in xs for st in x.stride()[:3]]


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over [B, T, H, D] (square, T <= 1024) -> (o, lse [B*H, 1, T]).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    _check(q, k, v)
    if not _on(q, "fused_attention"):
        return fused_attention_reference(q, k, v, scale)
    B, T, H, D = q.shape
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, 1, T), dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, T, H, D, *_strides(q, k, v), _scale(D, scale))
    fused_attention.launches += 1
    return o, lse


# Launches of the CUDA kernel in this process (the plain version is not counted).
fused_attention.launches = 0


def fused_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) [B, T, H, D] of ``fused_attention``'s o from
    q, k, v, the stored o and lse [B*H, 1, T], and the incoming do.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises. q, k, v and o are read through their
    strides; a do that the kernel cannot read so (autograd may hand over any
    layout) is copied contiguous first."""
    _check(q, k, v)
    B, T, H, D = q.shape
    _check_grad_inputs("fused_attention_bwd", q, o, do, lse)
    if not _on(q, "fused_attention_bwd"):
        return fused_attention_bwd_reference(q, k, v, o, do, lse, scale)
    if not _kernel_layout(o):
        raise ValueError(f"fused_attention_bwd kernel cannot read o with strides {o.stride()}")
    do = do if _kernel_layout(do) else do.contiguous()
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty((B, T, H, D), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    _launch("flash_attention_bwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, T, H, D, *_strides(q, k, v, o, do), _scale(D, scale))
    fused_attention_bwd.launches += 1
    return dq, dk, dv


# Launches of the CUDA kernel in this process (the plain version is not counted).
fused_attention_bwd.launches = 0


def _check_grad_inputs(name: str, q: torch.Tensor, o: Optional[torch.Tensor], do: torch.Tensor,
                       *rows: torch.Tensor) -> None:
    """o (if given) and do like q; each of ``rows`` (lse, delta) float32
    [B*H, 1, Tq]."""
    B, T, H, _ = q.shape
    for n, x in (("o", o), ("do", do)):
        if x is not None and (x.shape != q.shape or x.dtype != q.dtype):
            raise ValueError(f"{name} needs {n} like q {tuple(q.shape)} {q.dtype}; got "
                             f"{tuple(x.shape)} {x.dtype}")
    for x in rows:
        if x.shape != (B * H, 1, T) or x.dtype != torch.float32:
            raise ValueError(f"{name} needs float32 lse and delta [{B * H}, 1, {T}], got "
                             f"{tuple(x.shape)} {x.dtype}")


class FusedAttention(torch.autograd.Function):
    """Differentiable whole-sequence attention: ``fused_attention`` forward,
    ``fused_attention_bwd`` backward (the kernels on CUDA tensors, their
    plain versions on CPU tensors). ``apply(q, k, v, scale)`` returns
    (o, lse); lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale=None):
        o, lse = fused_attention(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, o, do, lse, ctx.scale)
        return dq, dk, dv, None


# ---------------------------------------------------------------------------
# Blocked path: any Tq, Tk, keys at or past kv_len masked.
# ---------------------------------------------------------------------------

def blocked_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the blocked forward: ``fused_attention_reference``
    over the keys < kv_len (a masked key carries exactly no weight), taken
    _REF_CHUNK query rows at a time. Returns (o [B, Tq, H, D], lse [B*H, 1, Tq])."""
    B, Tq, H, _ = q.shape
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    k, v = k[:, :kv_len], v[:, :kv_len]
    outs = [fused_attention_reference(q[:, i:i + _REF_CHUNK], k, v, scale)
            for i in range(0, Tq, _REF_CHUNK)]
    o = torch.cat([x[0] for x in outs], dim=1)
    lse = torch.cat([x[1].reshape(B, H, -1) for x in outs], dim=2).reshape(B * H, 1, Tq)
    return o, lse


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32 from the stored O, [B*H, 1, Tq]
    (the JAX ``_blocked_bwd`` at ``:462``); one torch reduction, not a kernel
    of the port."""
    B, T, H, _ = o.shape
    d = (do.float() * o.float()).sum(dim=-1)  # [B, T, H]
    return d.transpose(1, 2).reshape(B * H, 1, T)


def blocked_attention_dkv_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, scale: Optional[float] = None, kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``_blocked_dkv_kernel``, _REF_CHUNK keys at a
    time: P^T = exp(scale K Q^T - LSE), dV = P_op^T dO (P rounded to the
    operand dtype), dS^T = P^T (V dO^T - delta) rounded to the operand dtype,
    dK = scale dS^T Q; keys at or past kv_len get dK = dV = 0. Returns
    (dk, dv) [B, Tk, H, D] in q's dtype."""
    B, Tq, H, D = q.shape
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    s = _scale(D, scale)
    qh, gh = _bhtd(q), _bhtd(do)
    lse_r, delta_r = lse.reshape(B, H, 1, Tq), delta.reshape(B, H, 1, Tq)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for j in range(0, kv_len, _REF_CHUNK):
        kh, vh = (_bhtd(x[:, j:min(j + _REF_CHUNK, kv_len)]) for x in (k, v))
        p_t = torch.exp(s * torch.matmul(kh, qh.transpose(-1, -2)) - lse_r)  # [B, H, c, Tq]
        dv_c = torch.matmul(p_t.to(q.dtype).float(), gh)
        ds_t = (p_t * (torch.matmul(vh, gh.transpose(-1, -2)) - delta_r)).to(q.dtype).float()
        dk_c = s * torch.matmul(ds_t, qh)
        dk[:, j:j + kh.shape[2]] = _bthd(dk_c, q.dtype)
        dv[:, j:j + kh.shape[2]] = _bthd(dv_c, q.dtype)
    return dk, dv


def blocked_attention_dq_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, scale: Optional[float] = None, kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of ``_blocked_dq_kernel``, _REF_CHUNK query rows
    at a time: dS = exp(scale Q K^T - LSE) (dO V^T - delta) over the keys <
    kv_len, rounded to the operand dtype, dQ = scale dS K. Returns dq
    [B, Tq, H, D] in q's dtype."""
    B, Tq, H, D = q.shape
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    s = _scale(D, scale)
    kh, vh = _bhtd(k[:, :kv_len]), _bhtd(v[:, :kv_len])
    lse_r, delta_r = lse.reshape(B, H, Tq, 1), delta.reshape(B, H, Tq, 1)
    parts = []
    for i in range(0, Tq, _REF_CHUNK):
        qh, gh = _bhtd(q[:, i:i + _REF_CHUNK]), _bhtd(do[:, i:i + _REF_CHUNK])
        n = qh.shape[2]
        p = torch.exp(s * torch.matmul(qh, kh.transpose(-1, -2)) - lse_r[:, :, i:i + n])
        ds = (p * (torch.matmul(gh, vh.transpose(-1, -2)) - delta_r[:, :, i:i + n]))
        parts.append(s * torch.matmul(ds.to(q.dtype).float(), kh))
    return _bthd(torch.cat(parts, dim=2), q.dtype)


def blocked_fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of q [B, Tq, H, D] over the first kv_len (default Tk) keys of
    k, v [B, Tk, H, D] -> (o [B, Tq, H, D], lse float32 [B*H, 1, Tq]).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    kv_len = _check(q, k, v, "blocked_fused_attention", kv_len, square=False)
    if not _on(q, "blocked_fused_attention"):
        return blocked_attention_reference(q, k, v, scale, kv_len)
    B, Tq, H, D = q.shape
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, 1, Tq), dtype=torch.float32, device=q.device)
    _launch("flash_attention_blocked_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, Tq, k.shape[1], kv_len, H, D,
            *_strides(q, k, v), _scale(D, scale))
    blocked_fused_attention.launches += 1
    return o, lse


# Launches of the CUDA kernel in this process (the plain version is not counted).
blocked_fused_attention.launches = 0


def _blocked_grad_args(name, q, k, v, do, lse, delta, kv_len):
    """Checks shared by the two blocked backward passes; returns (kv_len, do,
    lse, delta) with do, lse and delta in a layout the kernels read."""
    kv_len = _check(q, k, v, name, kv_len, square=False)
    _check_grad_inputs(name, q, None, do, lse, delta)
    if q.device.type == "cuda":
        do = do if _kernel_layout(do) else do.contiguous()
        lse, delta = lse.contiguous(), delta.contiguous()
    return kv_len, do, lse, delta


def blocked_attention_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, scale: Optional[float] = None, kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV [B, Tk, H, D] of ``blocked_fused_attention``'s o, from the
    incoming do, the forward's lse and delta = ``attention_delta(o, do)``
    (both float32 [B*H, 1, Tq]); 0 at keys at or past kv_len.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    kv_len, do, lse, delta = _blocked_grad_args("blocked_attention_dkv", q, k, v, do, lse,
                                                delta, kv_len)
    if not _on(q, "blocked_attention_dkv"):
        return blocked_attention_dkv_reference(q, k, v, do, lse, delta, scale, kv_len)
    B, Tq, H, D = q.shape
    dk, dv = (torch.empty(k.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    _launch("flash_attention_blocked_dkv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Tq, k.shape[1], kv_len, H, D, *_strides(q, k, v, do), _scale(D, scale))
    blocked_attention_dkv.launches += 1
    return dk, dv


# Launches of the CUDA kernel in this process (the plain version is not counted).
blocked_attention_dkv.launches = 0


def blocked_attention_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, scale: Optional[float] = None, kv_len: Optional[int] = None,
) -> torch.Tensor:
    """dQ [B, Tq, H, D] of ``blocked_fused_attention``'s o; arguments as for
    ``blocked_attention_dkv``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream or raises."""
    kv_len, do, lse, delta = _blocked_grad_args("blocked_attention_dq", q, k, v, do, lse,
                                                delta, kv_len)
    if not _on(q, "blocked_attention_dq"):
        return blocked_attention_dq_reference(q, k, v, do, lse, delta, scale, kv_len)
    B, Tq, H, D = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("flash_attention_blocked_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            B, Tq, k.shape[1], kv_len, H, D, *_strides(q, k, v, do), _scale(D, scale))
    blocked_attention_dq.launches += 1
    return dq


# Launches of the CUDA kernel in this process (the plain version is not counted).
blocked_attention_dq.launches = 0


class BlockedFusedAttention(torch.autograd.Function):
    """Differentiable blocked attention: ``blocked_fused_attention`` forward;
    backward delta = ``attention_delta`` of the stored o, then
    ``blocked_attention_dkv`` and ``blocked_attention_dq`` (the kernels on
    CUDA tensors, their plain versions on CPU tensors).
    ``apply(q, k, v, scale=None, kv_len=None)`` returns (o, lse); lse is not
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale=None, kv_len=None):
        o, lse = blocked_fused_attention(q, k, v, scale, kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.kv_len = scale, kv_len
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = do if _kernel_layout(do) else do.contiguous()
        delta = attention_delta(o, do)
        dk, dv = blocked_attention_dkv(q, k, v, do, lse, delta, ctx.scale, ctx.kv_len)
        dq = blocked_attention_dq(q, k, v, do, lse, delta, ctx.scale, ctx.kv_len)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    """Differentiable attention over [B, T, H, D] (the JAX package's ``:520``):
    square T <= VMEM_PATH_MAX_T takes ``FusedAttention``, anything else
    (longer or rectangular) ``BlockedFusedAttention``."""
    if q.shape[1] == k.shape[1] and q.shape[1] <= VMEM_PATH_MAX_T:
        return FusedAttention.apply(q, k, v, scale)[0]
    return BlockedFusedAttention.apply(q, k, v, scale)[0]
