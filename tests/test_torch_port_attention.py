"""PyTorch port: the forward-attention kernel's plain version and the
attention dispatch, held against the JAX package's Pallas kernel.

On the CPU the port's ``fused_attention`` runs its plain version; the JAX
side runs ``_fused_fwd_impl``, whose ``pallas_call`` is interpreted on the
CPU. The CUDA kernel itself is compared with the plain version in
tests/test_torch_port_cuda.py, which runs only where there is a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.ops.flash_attention import _fused_fwd_impl
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.ops.flash_attention import (
    fused_attention,
    fused_attention_reference,
)

ATOL, RTOL = 2e-5, 1e-4  # float32, the tolerance of tests/test_kernels.py


def _qkv(B, T, H, D, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t,d", [(9, 16), (129, 32)])
def test_fused_attention_matches_jax_kernel(t, d):
    B, H = 2, 3
    q, k, v = _qkv(B, t, H, d)
    o_j, (_, _, _, _, lse_j) = _fused_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None)
    before = fused_attention.launches
    o_t, lse_t = fused_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert fused_attention.launches == before  # CPU tensors never launch
    assert o_t.shape == (B, t, H, d) and o_t.dtype == torch.float32
    assert lse_t.shape == (B * H, 1, t) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL, rtol=RTOL)


def test_fused_attention_strided_views_and_scale():
    """q/k/v sliced from a fused [B, T, 3, H, D] projection (the model's
    layout) with a custom scale, against the JAX kernel."""
    B, T, H, D = 2, 33, 3, 8
    qkv = np.random.RandomState(1).randn(B, T, 3, H, D).astype(np.float32)
    o_j, (_, _, _, _, lse_j) = _fused_fwd_impl(
        *(jnp.asarray(qkv[:, :, i]) for i in range(3)), 0.5)
    t = torch.from_numpy(qkv)
    o_t, lse_t = fused_attention(t[:, :, 0], t[:, :, 1], t[:, :, 2], 0.5)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL, rtol=RTOL)


def test_fused_attention_bfloat16_matches_jax_kernel():
    """bf16 operands: P is rounded to bf16 before P.V in both; O is bf16
    (1 bf16 ulp is 2^-8 relative), LSE float32. With the same rounding the
    two agree bit for bit almost everywhere (without rounding P, only about
    two thirds of O would)."""
    q, k, v = _qkv(2, 33, 3, 16, seed=2)
    o_j, (_, _, _, _, lse_j) = _fused_fwd_impl(
        *(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)), None)
    o_t, lse_t = fused_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert o_t.dtype == torch.bfloat16
    o_t, o_j = o_t.float().numpy(), np.asarray(o_j, dtype=np.float32)
    np.testing.assert_allclose(o_t, o_j, atol=1e-2, rtol=1e-2)
    assert (o_t == o_j).mean() >= 0.98
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "length", "stride"])
def test_fused_attention_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 9, 2, 16)
    if bad == "dtype":
        q, err = q.double(), TypeError
    elif bad == "head_dim":
        q, err = torch.zeros(1, 9, 2, 10), ValueError
    elif bad == "length":
        q, err = torch.zeros(1, 1025, 1, 16), ValueError
    else:  # token stride 18 is not a multiple of 4
        q, err = torch.zeros(1, 9, 1, 18)[..., 2:], ValueError
    with pytest.raises(err):
        fused_attention(q, q, q)


def test_dispatch_on_cpu(monkeypatch):
    """Auto backend on the CPU is plain; the kernel backend sends
    pallas_min_t() <= T <= 1024 through fused_attention, with
    HEADCT_PALLAS_MIN_T read at call time; no CUDA launch happens."""
    calls = []

    def spy(q, k, v, scale=None):
        calls.append(q.shape[1])
        return fused_attention(q, k, v, scale)

    monkeypatch.setattr(port_attn, "fused_attention", spy)
    monkeypatch.delenv("HEADCT_PALLAS_MIN_T", raising=False)
    prev_backend = port_attn.set_attention_backend(None)
    prev_min_t = port_attn.set_pallas_min_t(None)
    launches = fused_attention.launches
    try:
        x9 = torch.from_numpy(_qkv(1, 9, 2, 8)[0])
        x200 = torch.from_numpy(_qkv(1, 200, 2, 8)[0])
        x1100 = torch.from_numpy(_qkv(1, 1100, 1, 8)[0])
        assert port_attn.get_attention_backend(x9.device) == "plain"
        port_attn.dot_product_attention(x200, x200, x200)
        assert calls == []

        port_attn.set_attention_backend("kernel")
        assert port_attn.pallas_min_t() == 192
        port_attn.dot_product_attention(x9, x9, x9)
        assert calls == []                      # below the threshold
        y = port_attn.dot_product_attention(x200, x200, x200)
        assert calls == [200]
        torch.testing.assert_close(y, fused_attention_reference(x200, x200, x200)[0])

        monkeypatch.setenv("HEADCT_PALLAS_MIN_T", "8")  # read at call time
        port_attn.dot_product_attention(x9, x9, x9)
        assert calls == [200, 9]
        assert port_attn.set_pallas_min_t(300) is None
        port_attn.dot_product_attention(x200, x200, x200)
        assert calls == [200, 9]                # explicit value beats the env
        # beyond the whole-sequence kernel the CPU stays on the plain version
        port_attn.dot_product_attention(x1100, x1100, x1100)
        assert calls == [200, 9]
        assert fused_attention.launches == launches
    finally:
        port_attn.set_attention_backend(prev_backend)
        port_attn.set_pallas_min_t(prev_min_t)
    with pytest.raises(ValueError):
        port_attn.set_attention_backend("pallas")
