"""PyTorch port on the GPU: each CUDA kernel against its plain version.

These tests need an NVIDIA GPU and nvcc; they skip without one. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import pytest
import torch

from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.ops.flash_attention import (
    FusedAttention,
    fused_attention,
    fused_attention_bwd,
    fused_attention_bwd_reference,
    fused_attention_reference,
)


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
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)
    with pytest.raises(NotImplementedError):
        x = torch.zeros(1, 1100, 1, 16, device="cuda")
        prev = port_attn.set_attention_backend(None)
        try:
            port_attn.dot_product_attention(x, x, x)
        finally:
            port_attn.set_attention_backend(prev)


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
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol,
                                   msg=lambda m, n=name: f"d{n}: {m}")
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
