"""PyTorch port on the GPU: each CUDA kernel against its plain version.

These tests need an NVIDIA GPU and nvcc; they skip without one. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

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


# Backward kernel: (shape, dtype, atol, rtol) for dq, dk, dv.
_BWD_CASES = [
    ((8, 513, 16, 48), torch.bfloat16, 2e-2, 2e-2),  # MAE decoder
    ((8, 513, 16, 48), torch.float32, 1e-4, 1e-3),
    ((2, 129, 3, 32), torch.float32, 1e-4, 1e-3),
    ((2, 9, 3, 12), torch.float32, 1e-4, 1e-3),
    ((2, 129, 3, 32), torch.bfloat16, 2e-2, 2e-2),   # tensor-core path, head dim padded
    ((2, 9, 3, 12), torch.bfloat16, 2e-2, 2e-2),     # to 32, 16, 64 and 128
    ((2, 200, 2, 64), torch.bfloat16, 2e-2, 2e-2),
    ((2, 70, 2, 128), torch.bfloat16, 2e-2, 2e-2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,atol,rtol", _BWD_CASES)
def test_cuda_bwd_kernel_matches_plain_version(shape, dtype, atol, rtol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    B, T, H, D = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(B, T, 3, H, D, device="cuda", generator=g).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, lse = fused_attention(q, k, v)
    do = torch.randn(B, T, H, D, device="cuda", generator=g).to(dtype)
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
# dtype, forward atol/rtol, backward atol/rtol). kv_len 70 of 700 leaves ten
# whole 64-key tiles masked.
_BLOCKED_CASES = [
    ((2, 4097, 16, 48), 4097, None, torch.bfloat16, 2e-2, 2e-2),   # 192^3 MAE decoder
    ((2, 1025, 12, 64), 1025, None, torch.bfloat16, 2e-2, 2e-2),   # 192^3 MAE encoder
    ((2, 1025, 12, 64), 1025, None, torch.float32, 2e-5, 1e-4),
    ((2, 300, 3, 32), 700, 650, torch.float32, 2e-5, 1e-4),
    ((2, 300, 3, 32), 700, 70, torch.float32, 2e-5, 1e-4),
    ((2, 300, 3, 32), 700, 650, torch.bfloat16, 2e-2, 2e-2),
    ((2, 300, 3, 32), 700, 70, torch.bfloat16, 2e-2, 2e-2),
    ((2, 1100, 2, 12), 1100, None, torch.bfloat16, 2e-2, 2e-2),    # head dims 12, 128
    ((2, 200, 2, 128), 1500, 1300, torch.bfloat16, 2e-2, 2e-2),
    ((2, 200, 2, 128), 1500, 1300, torch.float32, 2e-5, 1e-4),
]
_BWD_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}


def blocked_inputs(shape, tk, dtype, seed):
    """q, k, v (strided views of one [B, T, 3, H, D] tensor when square, as
    the model passes them) and an incoming gradient, on the card."""
    B, T, H, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    if tk == T:
        qkv = torch.randn(B, T, 3, H, D, device="cuda", generator=g).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = torch.randn(B, T, H, D, device="cuda", generator=g).to(dtype)
        k, v = (torch.randn(B, tk, H, D, device="cuda", generator=g).to(dtype) for _ in range(2))
    do = torch.randn(B, T, H, D, device="cuda", generator=g).to(dtype)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tk,kv_len,dtype,atol,rtol", _BLOCKED_CASES)
def test_cuda_blocked_kernels_match_plain_versions(shape, tk, kv_len, dtype, atol, rtol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    q, k, v, do = blocked_inputs(shape, tk, dtype, seed=3)
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
