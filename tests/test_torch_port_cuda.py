"""PyTorch port on the GPU: each CUDA kernel against its plain version.

These tests need an NVIDIA GPU and nvcc; they skip without one. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import math

import pytest
import torch

from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.ops.flash_attention import (
    BlockedFusedAttention,
    FusedAttention,
    attention_delta,
    blocked_attention_dkv,
    blocked_attention_dkv_reference,
    blocked_attention_dq,
    blocked_attention_dq_reference,
    blocked_attention_reference,
    blocked_fused_attention,
    fused_attention,
    fused_attention_bwd,
    fused_attention_bwd_reference,
    fused_attention_reference,
)
from headct_foundation_tpu_torch.ops.lion_kernel import (
    lion_update_leaf,
    lion_update_leaf_reference,
)
from headct_foundation_tpu_torch.tools import experimental_tm_attention as tm


# A bfloat16 output is also held normwise, ||a - b|| / ||b|| <= _BF16_REL_L2:
# the elementwise 2e-2 + 2e-2|x| is as large as a typical value at thousands
# of keys and would pass a kernel that skipped one 64-token tile.
_BF16_REL_L2 = 1e-2


def assert_matches(a, b, atol, rtol, name=""):
    """a kernel's output a against its plain version b."""
    torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol,
                               msg=lambda m: f"{name}: {m}")
    if a.dtype == torch.bfloat16:
        rel = ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
        assert rel <= _BF16_REL_L2, f"{name}: ||a - b|| / ||b|| = {rel:.3e}"


def _randn(shape, offset, g, dtype):
    """A [shape] tensor starting `offset` elements into its storage."""
    n = math.prod(shape)
    return torch.randn(n + offset, device="cuda", generator=g).to(dtype)[offset:].view(shape)


_CUDA_CASES = [
    ((8, 513, 12, 64), torch.float32, 2e-5, 1e-4),   # serving
    ((8, 513, 16, 48), torch.bfloat16, 2e-2, 2e-2),  # MAE decoder
    ((2, 129, 3, 32), torch.float32, 2e-5, 1e-4),
    ((2, 9, 3, 12), torch.float32, 2e-5, 1e-4),
    ((2, 129, 3, 32), torch.bfloat16, 2e-2, 2e-2),   # tensor-core path, head dim padded
    ((2, 9, 3, 12), torch.bfloat16, 2e-2, 2e-2),     # to 32, 16, 64 and 128
    ((2, 200, 2, 64), torch.bfloat16, 2e-2, 2e-2),
    ((2, 70, 2, 128), torch.bfloat16, 2e-2, 2e-2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,atol,rtol", _CUDA_CASES)
def test_cuda_kernel_matches_plain_version(shape, dtype, atol, rtol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    B, T, H, D = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(B, T, 3, H, D, device="cuda", generator=g).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = fused_attention.launches
    o, lse = fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    o_ref, lse_ref = fused_attention_reference(q, k, v)
    assert_matches(o, o_ref, atol, rtol, "o")
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)
    # beyond the whole-sequence kernel the dispatch launches the blocked one
    x = torch.zeros(1, 1100, 1, 16, device="cuda")
    prev = port_attn.set_attention_backend(None)
    launches = (fused_attention.launches, blocked_fused_attention.launches)
    try:
        port_attn.dot_product_attention(x, x, x)
    finally:
        port_attn.set_attention_backend(prev)
    assert (fused_attention.launches, blocked_fused_attention.launches) == \
        (launches[0], launches[1] + 1)


# Backward kernel B2: (shape, dtype, atol, rtol, storage offset) for dq, dk, dv;
# q, k, v are strided views of one [B, T, 3, H, D]. The bfloat16 cases from the
# block edges on hold the wgmma passes of csrc/flash_bwd_sm90.cuh at
# whole-sequence shapes: T one below, at and one above their 64-row tiles and
# the decoder's 513, head dims 12 (8-byte copies) to 128, and a view 4
# elements into its storage (no operand 16-byte aligned).
_BWD_CASES = [
    ((8, 513, 16, 48), torch.bfloat16, 2e-2, 2e-2, 0),  # MAE decoder
    ((8, 513, 16, 48), torch.float32, 1e-4, 1e-3, 0),
    ((2, 129, 3, 32), torch.float32, 1e-4, 1e-3, 0),
    ((2, 9, 3, 12), torch.float32, 1e-4, 1e-3, 0),
    ((2, 129, 3, 32), torch.bfloat16, 2e-2, 2e-2, 0),   # head dim padded to 32, 16,
    ((2, 9, 3, 12), torch.bfloat16, 2e-2, 2e-2, 0),     # 64 and 128
    ((2, 200, 2, 64), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 70, 2, 128), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 63, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),    # block edges
    ((2, 64, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 65, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 127, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 128, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 513, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 200, 2, 12), torch.bfloat16, 2e-2, 2e-2, 0),   # head dims 12 to 128
    ((2, 129, 2, 16), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 200, 2, 32), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 130, 2, 64), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 130, 2, 128), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 3, 64), torch.bfloat16, 2e-2, 2e-2, 4),   # misaligned view
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,atol,rtol,offset", _BWD_CASES)
def test_cuda_bwd_kernel_matches_plain_version(shape, dtype, atol, rtol, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    B, T, H, D = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = _randn((B, T, 3, H, D), offset, g, dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, lse = fused_attention(q, k, v)
    do = _randn((B, T, H, D), offset, g, dtype)
    before = fused_attention_bwd.launches
    got = fused_attention_bwd(q, k, v, o, do, lse)
    again = fused_attention_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert fused_attention_bwd.launches == before + 2
    want = fused_attention_bwd_reference(q, k, v, o, do, lse)
    for name, a, b, c in zip("qkv", got, want, again):
        assert_matches(a, b, atol, rtol, f"d{name}")
        assert torch.equal(a, c), f"d{name} differs between two runs"


@pytest.mark.cuda
def test_cuda_autograd_function_matches_plain_autograd():
    """The kernel pair as an autograd.Function, with a non-contiguous incoming
    gradient, against autograd through the plain forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    B, T, H, D = 2, 200, 4, 32
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(B, T, 3, H, D, device="cuda", generator=g).requires_grad_()
    w = torch.randn(B, T, D, H, device="cuda", generator=g).transpose(2, 3)  # strided
    grads = []
    for fn in (lambda q, k, v: FusedAttention.apply(q, k, v, None)[0],
               lambda q, k, v: fused_attention_reference(q, k, v)[0]):
        qkv.grad = None
        (fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]) * w).sum().backward()
        grads.append(qkv.grad.clone())
    torch.testing.assert_close(grads[0], grads[1], atol=1e-4, rtol=1e-3)


# Blocked kernels B3 (forward), B4 (dK, dV) and B5 (dQ): (q shape, Tk, kv_len,
# dtype, forward atol/rtol, backward atol/rtol, storage offset in elements).
# Square q, k, v are strided views of one [B, T, 3, H, D] tensor, as the model
# passes them. kv_len 70 of 700 leaves ten whole 64-key tiles masked. The
# bfloat16 cases after the 192^3 ones hold B4/B5's edges: Tq and kv_len one
# below, at and one above a multiple of their 64-row blocks, head dims 16 to
# 128, and the 8-byte copy route (D = 12, and an offset of 4 elements, which
# breaks the 16-byte alignment of every operand).
_BLOCKED_CASES = [
    ((2, 4097, 16, 48), 4097, None, torch.bfloat16, 2e-2, 2e-2, 0),   # 192^3 MAE decoder
    ((2, 1025, 12, 64), 1025, None, torch.bfloat16, 2e-2, 2e-2, 0),   # 192^3 MAE encoder
    ((2, 1025, 12, 64), 1025, None, torch.float32, 2e-5, 1e-4, 0),
    ((2, 300, 3, 32), 700, 650, torch.float32, 2e-5, 1e-4, 0),
    ((2, 300, 3, 32), 700, 70, torch.float32, 2e-5, 1e-4, 0),
    ((2, 300, 3, 32), 700, 650, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 300, 3, 32), 700, 70, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 1100, 2, 12), 1100, None, torch.bfloat16, 2e-2, 2e-2, 0),    # head dims 12, 128
    ((2, 200, 2, 128), 1500, 1300, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 200, 2, 128), 1500, 1300, torch.float32, 2e-5, 1e-4, 0),
    ((2, 127, 2, 64), 257, 128, torch.bfloat16, 2e-2, 2e-2, 0),       # block edges
    ((2, 128, 2, 64), 257, 129, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 2, 64), 257, 127, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 2, 16), 129, None, torch.bfloat16, 2e-2, 2e-2, 0),      # head dims 16 to 128
    ((2, 200, 2, 32), 200, None, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 300, 2, 48), 300, None, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 130, 2, 128), 130, None, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 3, 64), 129, None, torch.bfloat16, 2e-2, 2e-2, 4),      # misaligned views
    ((2, 100, 2, 64), 300, 250, torch.bfloat16, 2e-2, 2e-2, 4),
]
_BWD_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}


def blocked_inputs(shape, tk, dtype, seed, offset=0):
    """q, k, v (strided views of one [B, T, 3, H, D] tensor when square, as
    the model passes them) and an incoming gradient, on the card, each
    starting ``offset`` elements into its storage."""
    B, T, H, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    if tk == T:
        qkv = _randn((B, T, 3, H, D), offset, g, dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = _randn((B, T, H, D), offset, g, dtype)
        k, v = (_randn((B, tk, H, D), offset, g, dtype) for _ in range(2))
    do = _randn((B, T, H, D), offset, g, dtype)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tk,kv_len,dtype,atol,rtol,offset", _BLOCKED_CASES)
def test_cuda_blocked_kernels_match_plain_versions(shape, tk, kv_len, dtype, atol, rtol, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    q, k, v, do = blocked_inputs(shape, tk, dtype, seed=3, offset=offset)
    before = (blocked_fused_attention.launches, blocked_attention_dkv.launches,
              blocked_attention_dq.launches)
    o, lse = blocked_fused_attention(q, k, v, kv_len=kv_len)
    delta = attention_delta(o, do)
    dk, dv = blocked_attention_dkv(q, k, v, do, lse, delta, kv_len=kv_len)
    dq = blocked_attention_dq(q, k, v, do, lse, delta, kv_len=kv_len)
    again = (*blocked_attention_dkv(q, k, v, do, lse, delta, kv_len=kv_len),
             blocked_attention_dq(q, k, v, do, lse, delta, kv_len=kv_len))
    torch.cuda.synchronize()
    assert (blocked_fused_attention.launches, blocked_attention_dkv.launches,
            blocked_attention_dq.launches) == (before[0] + 1, before[1] + 2, before[2] + 2)
    o_ref, lse_ref = blocked_attention_reference(q, k, v, kv_len=kv_len)
    assert_matches(o, o_ref, atol, rtol, "o")
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)
    # the backward passes against their plain versions on the kernel's o and lse
    dk_ref, dv_ref = blocked_attention_dkv_reference(q, k, v, do, lse, delta, kv_len=kv_len)
    dq_ref = blocked_attention_dq_reference(q, k, v, do, lse, delta, kv_len=kv_len)
    batol, brtol = _BWD_TOL[dtype]
    for name, a, b, c in zip(("dk", "dv", "dq"), (dk, dv, dq), (dk_ref, dv_ref, dq_ref), again):
        assert_matches(a, b, batol, brtol, name)
        assert torch.equal(a, c), f"{name} differs between two runs"
    if kv_len is not None and kv_len < tk:  # masked keys: exactly zero, written by the kernel
        assert not dk[:, kv_len:].any() and not dv[:, kv_len:].any()


# The bfloat16 forward (flash_fwd_sm90.cuh) at its edges: (q shape, Tk, kv_len,
# storage offset), B1 where Tk is None, else B3. T and kv_len one below, at
# and one above its 64-key tiles and 128-row blocks, head dims 12 (8-byte
# copies) and 128, and views 4 elements into their storage (no operand
# 16-byte aligned).
_FWD_EDGE_CASES = [
    ((2, 63, 2, 48), None, None, 0),
    ((2, 64, 2, 48), None, None, 0),
    ((2, 65, 2, 48), None, None, 0),
    ((2, 127, 2, 64), None, None, 0),
    ((2, 128, 2, 64), None, None, 0),
    ((2, 129, 2, 64), None, None, 0),
    ((2, 200, 2, 12), None, None, 0),
    ((2, 130, 2, 128), None, None, 0),
    ((2, 129, 3, 64), None, None, 4),
    ((2, 63, 2, 48), 130, 65, 0),
    ((2, 64, 2, 48), 130, 63, 0),
    ((2, 65, 2, 48), 130, 64, 0),
    ((2, 127, 2, 12), 300, 129, 0),
    ((2, 129, 2, 128), 300, 127, 0),
    ((2, 100, 2, 64), 300, 250, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tk,kv_len,offset", _FWD_EDGE_CASES)
def test_cuda_bf16_forward_edges_and_reruns(shape, tk, kv_len, offset):
    """The bfloat16 forward against its plain version at its tile and block
    edges; two runs give bit-identical O and LSE."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    q, k, v, _ = blocked_inputs(shape, tk or shape[1], torch.bfloat16, seed=8, offset=offset)
    if tk is None:
        def run():
            return fused_attention(q, k, v)

        want = fused_attention_reference(q, k, v)
    else:
        def run():
            return blocked_fused_attention(q, k, v, kv_len=kv_len)

        want = blocked_attention_reference(q, k, v, kv_len=kv_len)
    (o, lse), (o2, lse2) = run(), run()
    torch.cuda.synchronize()
    assert_matches(o, want[0], 2e-2, 2e-2, "o")
    torch.testing.assert_close(lse, want[1], atol=1e-4, rtol=1e-4)
    assert torch.equal(o, o2) and torch.equal(lse, lse2), "two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-0.3, 0.0, 1.5])
def test_cuda_bf16_forward_any_scale(scale):
    """The bfloat16 forward walks in the log2 domain with a positive factor;
    a negative scale negates Q (exactly) instead, a zero one gives uniform
    weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    q, k, v, _ = blocked_inputs((2, 200, 2, 48), 200, torch.bfloat16, seed=9)
    o, lse = fused_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    o_ref, lse_ref = fused_attention_reference(q, k, v, scale=scale)
    assert_matches(o, o_ref, 2e-2, 2e-2, "o")
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_blocked_autograd_function_matches_plain_autograd():
    """BlockedFusedAttention with a non-contiguous incoming gradient against
    autograd through the plain forward, rectangular with kv_len."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn(2, 150, 4, 32, device="cuda", generator=g).requires_grad_()
    kv = torch.randn(2, 330, 2, 4, 32, device="cuda", generator=g).requires_grad_()
    w = torch.randn(2, 150, 32, 4, device="cuda", generator=g).transpose(2, 3)  # strided
    grads = []
    for fn in (lambda q, k, v: BlockedFusedAttention.apply(q, k, v, None, 300)[0],
               lambda q, k, v: fused_attention_reference(q, k[:, :300], v[:, :300])[0]):
        q.grad = kv.grad = None
        (fn(q, kv[:, :, 0], kv[:, :, 1]) * w).sum().backward()
        grads.append((q.grad.clone(), kv.grad.clone()))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


# Fused Lion kernel B6: (shape, p dtype, g dtype, storage offset). Offset 1
# misaligns every pointer, so the kernel takes its scalar loop throughout;
# 2359299 leaves a scalar tail of 3 after the vector loop.
_LION_CASES = [
    ((3072, 768), torch.float32, torch.float32, 0),
    ((768,), torch.float32, torch.float32, 0),
    ((700,), torch.float32, torch.float32, 0),
    ((1,), torch.float32, torch.float32, 0),
    ((2359299,), torch.float32, torch.float32, 0),
    ((3072, 768), torch.bfloat16, torch.bfloat16, 0),
    ((701,), torch.float32, torch.bfloat16, 0),
    ((701,), torch.bfloat16, torch.float32, 0),
    ((700,), torch.float32, torch.float32, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,p_dtype,g_dtype,offset", _LION_CASES)
def test_cuda_lion_kernel_matches_plain_version(shape, p_dtype, g_dtype, offset):
    """Every operation rounds as in the plain version, so delta and m_new are
    bit-identical to it, with m_new in a new tensor or over m in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(5)
    n = int(torch.tensor(shape).prod())

    def make(dtype, scale):
        return (scale * torch.randn(n + offset, device="cuda", generator=g))[offset:].to(
            dtype).reshape(shape)

    p, grad, m = make(p_dtype, 1.0), make(g_dtype, 1e-2), make(torch.float32, 1e-3)
    args = (1.5e-4, 0.05, 0.9, 0.95)
    before = lion_update_leaf.launches
    delta, m_new = lion_update_leaf(p, grad, m, *args)
    m_in_place = m.clone()
    delta2, out = lion_update_leaf(p, grad, m_in_place, *args, m_out=m_in_place)
    torch.cuda.synchronize()
    assert lion_update_leaf.launches == before + 2 and out is m_in_place
    want_delta, want_m = lion_update_leaf_reference(p, grad, m, *args)
    assert delta.dtype == p_dtype and m_new.dtype == torch.float32
    assert torch.equal(delta, want_delta), (delta.float() - want_delta.float()).abs().max()
    assert torch.equal(m_new, want_m), (m_new - want_m).abs().max()
    assert torch.equal(delta2, delta) and torch.equal(m_in_place, m_new)


# Token-major kernels B7, B8: (shape, dtype, forward atol/rtol, backward atol/rtol)
_TM_CASES = [
    ((8, 513, 16, 48), torch.bfloat16, (2e-2, 2e-2), (2e-2, 2e-2)),  # MAE decoder, batch 8
    ((8, 513, 12, 64), torch.float32, (2e-5, 1e-4), (1e-4, 1e-3)),
    ((2, 70, 4, 32), torch.float32, (2e-5, 1e-4), (1e-4, 1e-3)),
    ((2, 129, 2, 128), torch.bfloat16, (2e-2, 2e-2), (2e-2, 2e-2)),
    ((2, 9, 3, 12), torch.bfloat16, (2e-2, 2e-2), (2e-2, 2e-2)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,ftol,btol", _TM_CASES)
def test_cuda_tm_kernels_match_plain_versions(shape, dtype, ftol, btol):
    """B7 and B8 against their plain versions, and bit for bit against B1
    and B2 on the same contiguous inputs (the same tile code); B8 reruns
    bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    B, T, H, D = shape
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, do = (torch.randn(shape, device="cuda", generator=g).to(dtype) for _ in range(4))
    before = (tm.tm_attention_fwd.launches, tm.tm_attention_bwd.launches)
    o, lse = tm.tm_attention_fwd(q, k, v)
    grads = tm.tm_attention_bwd(q, k, v, o, do, lse)
    again = tm.tm_attention_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert (tm.tm_attention_fwd.launches, tm.tm_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 2)
    assert o.is_contiguous() and lse.shape == (B, H, T)
    o_ref, lse_ref = tm.tm_attention_fwd_reference(q, k, v)
    assert_matches(o, o_ref, *ftol, "o")
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)
    want = tm.tm_attention_bwd_reference(q, k, v, o, do, lse)
    o_b1, lse_b1 = fused_attention(q, k, v)
    for name, a, b, c, d in zip(("dq", "dk", "dv"), grads, want, again,
                                fused_attention_bwd(q, k, v, o_b1, do, lse_b1)):
        assert_matches(a, b, *btol, name)
        assert torch.equal(a, c), f"{name} differs between two runs"
        assert torch.equal(a, d), f"{name} differs from B2's"
    assert torch.equal(o, o_b1) and torch.equal(lse.flatten(), lse_b1.flatten())


@pytest.mark.cuda
def test_cuda_tm_autograd_function_matches_fused_attention():
    """FusedAttentionTM with a non-contiguous incoming gradient against
    FusedAttention on the same inputs: equal out and gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(7)
    w = torch.randn(2, 200, 32, 4, device="cuda", generator=g).transpose(2, 3)  # strided
    qkv0 = [torch.randn(2, 200, 4, 32, device="cuda", generator=g) for _ in range(3)]
    outs = []
    for apply in (tm.FusedAttentionTM.apply, FusedAttention.apply):
        qkv = [x.clone().requires_grad_() for x in qkv0]
        o = apply(*qkv, None)[0]
        (o * w).sum().backward()
        outs.append((o.detach(), *(x.grad for x in qkv)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
