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
from headct_foundation_tpu_torch.config import default_config
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


def test_float64_takes_the_plain_attention_and_every_kernel_entry_refuses_it(monkeypatch):
    """The downstream main's float64 reference mode: the dispatch sends
    float64 to the plain attention explicitly, under the kernel backend, at
    every length and on a ``seq`` shard (no kernel entry reached, the result
    float64 and equal to a float64 numpy softmax attention within 1e-12),
    and each kernel entry point raises on float64 rather than taking its
    plain version."""
    q, k, v = (torch.from_numpy(x).double() for x in _qkv(2, 9, 2, 8))
    reached = []
    for name in ("flash_attention", "FusedAttention", "BlockedFusedAttention"):
        monkeypatch.setattr(port_fa, name, lambda *a, _n=name, **kw: reached.append(_n))
    prev = port_attn.set_attention_backend("kernel"), port_attn.set_pallas_min_t(1)
    try:
        y = port_attn.dot_product_attention(q, k, v)
        y_shard = port_attn.attend_shard(q[:, :5], k, v, 9)
    finally:
        port_attn.set_attention_backend(prev[0])
        port_attn.set_pallas_min_t(prev[1])
    monkeypatch.undo()
    assert reached == [] and y.dtype == y_shard.dtype == torch.float64
    qn, kn, vn = (x.numpy().transpose(0, 2, 1, 3) for x in (q, k, v))
    s = qn @ kn.transpose(0, 1, 3, 2) / np.sqrt(8)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = ((p / p.sum(-1, keepdims=True)) @ vn).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y_shard.numpy(), want[:, :5], rtol=1e-12, atol=1e-12)

    lse = torch.zeros(4, 1, 9)
    delta = torch.zeros(4, 1, 9)
    for call in (lambda: fused_attention(q, k, v),
                 lambda: fused_attention_bwd(q, k, v, q, q, lse),
                 lambda: port_fa.blocked_fused_attention(q, k, v),
                 lambda: port_fa.blocked_attention_dkv(q, k, v, q, lse, delta),
                 lambda: port_fa.blocked_attention_dq(q, k, v, q, lse, delta),
                 lambda: port_fa.flash_attention(q, k, v),
                 lambda: FusedAttention.apply(q, k, v),
                 lambda: port_fa.BlockedFusedAttention.apply(q, k, v)):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            call()


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
        assert port_attn.pallas_min_t() == port_attn.DEFAULT_PALLAS_MIN_T
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


def test_default_threshold_sends_the_96_encoder_to_the_kernels(monkeypatch):
    """Under the kernel backend at the default threshold (no override, no
    HEADCT_PALLAS_MIN_T), the 96^3 MAE encoder's T = 129 reaches
    FusedAttention, and a ``seq`` rank's 65-row shard of it the blocked
    path with kv_len 129; the attentive classifier's Tq = 1 query and the
    DINO semantics configuration's T = 11 stay plain. The config's
    PARALLEL.PALLAS_MIN_T reads the same default."""
    calls = []

    class Spy:
        def __init__(self, name):
            self.name, self.real = name, getattr(port_fa, name)

        def apply(self, q, k, v, *args):
            calls.append((self.name, q.shape[1], k.shape[1]))
            return self.real.apply(q, k, v, *args)

    for name in ("FusedAttention", "BlockedFusedAttention"):
        monkeypatch.setattr(port_fa, name, Spy(name))
    monkeypatch.delenv("HEADCT_PALLAS_MIN_T", raising=False)
    assert default_config().PARALLEL.PALLAS_MIN_T == port_attn.DEFAULT_PALLAS_MIN_T
    prev = port_attn.set_attention_backend("kernel"), port_attn.set_pallas_min_t(None)
    try:
        assert port_attn.pallas_min_t() == port_attn.DEFAULT_PALLAS_MIN_T <= 129
        x129 = torch.from_numpy(_qkv(2, 129, 2, 8)[0])
        x11 = torch.from_numpy(_qkv(2, 11, 2, 8)[0])
        y = port_attn.dot_product_attention(x129, x129, x129)
        assert calls == [("FusedAttention", 129, 129)]
        torch.testing.assert_close(y, fused_attention_reference(x129, x129, x129)[0])
        y = port_attn.attend_shard(x129[:, :65], x129, x129, 129)
        assert calls[1:] == [("BlockedFusedAttention", 65, 129)]
        torch.testing.assert_close(y, fused_attention_reference(x129, x129, x129)[0][:, :65])
        port_attn.dot_product_attention(x129[:, :1], x129, x129)  # one query
        port_attn.dot_product_attention(x11, x11, x11)
        assert len(calls) == 2
    finally:
        port_attn.set_attention_backend(prev[0])
        port_attn.set_pallas_min_t(prev[1])


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


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: cvt.rna.tf32.f32."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """float32 as a TF32 operand of the tensor cores reads it: its 13 low
    mantissa bits dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b from TF32 operands, as the tensor cores take them: three
    products a_lo b_hi + a_hi b_lo + a_hi b_hi with hi = tf32(x) and lo = x -
    hi, stored unrounded and read truncated by the tensor cores (the split
    of the float32 forward kernel), or one, a_hi b_hi. A product of two TF32
    values is exact in float32, so a float32 matmul of them sums as the
    tensor cores do, up to the order."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if products == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32_truncated(a - a_hi), _tf32_truncated(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


@pytest.mark.parametrize("products", [3, 1])
def test_tf32_split_arithmetic_holds_the_float32_limits(products):
    """The float32 forward on the card (csrc/flash_fwd_f32_sm90.cuh) runs
    S = scale Q K^T and O = P V on the tensor cores as three TF32 products
    each. Its arithmetic, emulated here, holds the float32 kernel limits (O
    within 2e-5 + 1e-4 |O|, LSE within 1e-4 + 1e-4 |LSE|) against the
    interpreted JAX kernel at the serving length; one TF32 product, plain
    TF32, does not hold them for O."""
    B, T, H, D = 1, 513, 2, 64
    q, k, v = _qkv(B, T, H, D, seed=11)
    o_j, (_, _, _, _, lse_j) = _fused_fwd_impl(*(jnp.asarray(x) for x in (q, k, v)), None)
    qh, kh, vh = (torch.from_numpy(x).permute(0, 2, 1, 3) for x in (q, k, v))
    s = _tf32_matmul(qh, kh.transpose(-1, -2), products) * D ** -0.5
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (_tf32_matmul(p, vh, products) / l).permute(0, 2, 1, 3).numpy()
    lse = (m + torch.log(l)).reshape(B * H, 1, T).numpy()
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    o_ok = bool((np.abs(o - o_j) <= ATOL + RTOL * np.abs(o_j)).all())
    assert o_ok == (products == 3)
    if products == 3:
        np.testing.assert_allclose(lse, lse_j, atol=1e-4, rtol=1e-4)
