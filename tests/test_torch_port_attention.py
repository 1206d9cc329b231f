"""PyTorch port: the attention kernels' plain versions, their autograd
wiring and the attention dispatch, held against the JAX package's Pallas
kernels.

On the CPU the port's ``fused_attention`` / ``fused_attention_bwd`` run
their plain versions; the JAX side runs ``_fused_fwd_impl`` / ``_fused_bwd``,
whose ``pallas_call`` is interpreted on the CPU. The CUDA kernels themselves
are compared with the plain versions in tests/test_torch_port_cuda.py, which
runs only where there is a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.ops.flash_attention import _fused_bwd, _fused_fwd_impl
from headct_foundation_tpu.ops.flash_attention import fused_attention as jax_fused_attention
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.ops import flash_attention as port_fa
from headct_foundation_tpu_torch.ops.flash_attention import (
    FusedAttention,
    fused_attention,
    fused_attention_bwd,
    fused_attention_bwd_reference,
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
    pallas_min_t() <= T <= 1024 through FusedAttention, with
    HEADCT_PALLAS_MIN_T read at call time; no CUDA launch happens."""
    calls = []

    class Spy:
        @staticmethod
        def apply(q, k, v, scale=None):
            calls.append(q.shape[1])
            return FusedAttention.apply(q, k, v, scale)

    monkeypatch.setattr(port_fa, "FusedAttention", Spy)
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
        # beyond the whole-sequence kernel: the blocked path, not FusedAttention
        port_attn.dot_product_attention(x1100, x1100, x1100)
        assert calls == [200, 9]
        assert fused_attention.launches == launches
    finally:
        port_attn.set_attention_backend(prev_backend)
        port_attn.set_pallas_min_t(prev_min_t)
    with pytest.raises(ValueError):
        port_attn.set_attention_backend("pallas")


def _bthd(x, B, H, T, D):
    """The JAX kernels' [B*H, T, D] layout -> [B, T, H, D]."""
    return np.asarray(x, np.float32).reshape(B, H, T, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype,atol,rtol", [("float32", 2e-5, 1e-4), ("bfloat16", 2e-2, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 9, 3, 16), (2, 129, 3, 32), (1, 513, 2, 48)])
def test_fused_attention_bwd_reference_matches_jax_kernel(shape, dtype, atol, rtol):
    """The backward's plain version against the interpreted Pallas backward,
    on the JAX forward's own residuals (o, lse), up to the 96^3 MAE decoder's
    T = 513 and head dim 48. In bf16 both round P and dS at the same points,
    so nearly every gradient agrees bit for bit."""
    B, T, H, D = shape
    q, k, v = _qkv(B, T, H, D, seed=3)
    g = np.random.RandomState(4).randn(B, T, H, D).astype(np.float32)
    jdt = getattr(jnp, dtype)
    qj, kj, vj, gj = (jnp.asarray(x, dtype=jdt) for x in (q, k, v, g))
    _, (qp, kp, vp, o_j, lse_j) = _fused_fwd_impl(qj, kj, vj, None)
    want = _fused_bwd(None, ((qp, kp, vp, o_j, lse_j), (B, T, H, D)), gj)

    tdt = getattr(torch, dtype)
    o = torch.from_numpy(_bthd(o_j, B, H, T, D)).to(tdt)
    before = fused_attention_bwd.launches
    got = fused_attention_bwd(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), o,
                              torch.from_numpy(g).to(tdt), torch.tensor(np.asarray(lse_j)))
    assert fused_attention_bwd.launches == before  # CPU tensors never launch
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == tdt and a.shape == (B, T, H, D)
        a, w = a.float().numpy(), np.asarray(w, np.float32)
        np.testing.assert_allclose(a, w, atol=atol, rtol=rtol, err_msg=f"d{name}")
        if dtype == "bfloat16":
            assert (a == w).mean() >= 0.98, f"d{name}"


def test_fused_attention_function_grads_match_jax_vjp():
    """FusedAttention (forward + backward) against jax.vjp of the JAX
    package's custom-VJP fused_attention, with a custom scale, on q/k/v that
    are strided views of one [B, T, 3, H, D] tensor."""
    B, T, H, D = 2, 33, 3, 8
    qkv = np.random.RandomState(5).randn(B, T, 3, H, D).astype(np.float32)
    g = np.random.RandomState(6).randn(B, T, H, D).astype(np.float32)
    o_j, vjp = jax.vjp(lambda q, k, v: jax_fused_attention(q, k, v, 0.3),
                       *(jnp.asarray(qkv[:, :, i]) for i in range(3)))
    want = vjp(jnp.asarray(g))
    t = torch.from_numpy(qkv).requires_grad_()
    o, lse = FusedAttention.apply(t[:, :, 0], t[:, :, 1], t[:, :, 2], 0.3)
    assert not lse.requires_grad
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), atol=ATOL, rtol=RTOL)
    o.backward(torch.from_numpy(g))
    for i, w in enumerate(want):
        np.testing.assert_allclose(t.grad[:, :, i].numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_kernel_backend_gradients_equal_plain_backend():
    """The kernel backend's attention must stay in the autograd graph: its
    input gradients equal the plain backend's (autograd through the plain
    forward). A kernel that wrote into a fresh tensor outside the graph
    would give no gradient through attention at all."""
    qkv0 = torch.from_numpy(np.random.RandomState(7).randn(2, 40, 3, 2, 8).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(8).randn(2, 40, 2, 8).astype(np.float32))
    grads = {}
    prev = (port_attn.set_attention_backend(None), port_attn.set_pallas_min_t(16))
    try:
        for backend in ("kernel", "plain"):
            port_attn.set_attention_backend(backend)
            qkv = qkv0.clone().requires_grad_()
            y = port_attn.dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
            assert y.grad_fn is not None
            (y * w).sum().backward()
            grads[backend] = qkv.grad
    finally:
        port_attn.set_attention_backend(prev[0])
        port_attn.set_pallas_min_t(prev[1])
    assert grads["kernel"].abs().sum() > 0
    torch.testing.assert_close(grads["kernel"], grads["plain"], atol=1e-5, rtol=1e-4)


def test_fused_attention_bwd_reference_equals_autograd_of_plain_forward():
    """The plain backward is the derivative of the plain forward (float32)."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(1, 17, 2, 8, seed=9))
    g = torch.from_numpy(np.random.RandomState(10).randn(1, 17, 2, 8).astype(np.float32))
    o, lse = fused_attention_reference(q, k, v)
    o.backward(g)
    got = fused_attention_bwd_reference(q.detach(), k.detach(), v.detach(), o.detach(), g,
                                        lse.detach())
    for a, b in zip(got, (q.grad, k.grad, v.grad)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
