"""PyTorch port: the blocked attention path (kernels B3, B4, B5), its autograd
wiring and dispatch, the 192^3 MAE geometry, and ``PARALLEL.REMAT``, held
against the JAX package.

On the CPU the port's ``blocked_fused_attention``, ``blocked_attention_dkv``
and ``blocked_attention_dq`` run their plain versions; the JAX side runs
``blocked_fused_attention`` with its ``pallas_call`` interpreted on the CPU,
as tests/test_kernels.py does. The CUDA kernels themselves are compared with
the plain versions in tests/test_torch_port_cuda.py, which runs only where
there is a GPU. Inputs are made with numpy from a seed.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.models.mae import MaskedAutoencoderViT as JaxMAE
from headct_foundation_tpu.ops import attention as jax_attn
from headct_foundation_tpu.ops import flash_attention as jax_fa
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.data.transforms import hu16_encode
from headct_foundation_tpu_torch.engines import mae_engine
from headct_foundation_tpu_torch.models.mae import MaskedAutoencoderViT
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.ops import flash_attention as port_fa
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
    flash_attention,
)
from headct_foundation_tpu_torch.utils.torch_interop import state_dict_from_jax

ROOT = Path(__file__).resolve().parent.parent
# (B, Tq, Tk, H, D, kv_len): square beyond one JAX block, rectangular with a
# kv_len inside the last 64-key tile and one that masks whole tiles; then the
# main path's head dims, 48 (the 192^3 decoder) and 64 (its encoder), each
# rectangular with kv_len inside a tile and square over several tiles
CASES = [(2, 300, 300, 3, 32, None), (2, 100, 300, 3, 32, 250), (2, 100, 300, 3, 32, 40),
         (2, 100, 300, 2, 48, 250), (1, 200, 200, 2, 48, None),
         (2, 100, 300, 2, 64, 250), (1, 200, 200, 2, 64, None)]
IDS = ["square300", "rect_kv250", "rect_kv40", "d48_rect_kv250", "d48_square200",
       "d64_rect_kv250", "d64_square200"]
TOL = {"float32": dict(atol=2e-5, rtol=1e-4), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
LSE_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


def _inputs(B, Tq, Tk, H, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Tq, H, D).astype(np.float32), rng.randn(B, Tk, H, D).astype(np.float32),
            rng.randn(B, Tk, H, D).astype(np.float32), rng.randn(B, Tq, H, D).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blocked_forward_matches_jax_kernel(case, dtype):
    B, Tq, Tk, H, D, kv_len = case
    q, k, v, _ = _inputs(B, Tq, Tk, H, D)
    o_j, res = jax_fa._blocked_fwd_impl(*(jnp.asarray(x, dtype=getattr(jnp, dtype))
                                          for x in (q, k, v)), None, kv_len)
    lse_j = np.asarray(res[4])[:, 0, :Tq]  # the JAX residual is padded to its block
    tdt = getattr(torch, dtype)
    before = blocked_fused_attention.launches
    o, lse = blocked_fused_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                     kv_len=kv_len)
    assert blocked_fused_attention.launches == before  # CPU tensors never launch
    assert o.shape == (B, Tq, H, D) and o.dtype == tdt
    assert lse.shape == (B * H, 1, Tq) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), np.asarray(o_j, np.float32), **TOL[dtype])
    np.testing.assert_allclose(lse[:, 0].numpy(), lse_j, **LSE_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blocked_function_grads_match_jax_vjp(case):
    """BlockedFusedAttention (forward + backward) against jax.vjp of the JAX
    custom-VJP blocked_fused_attention, with a custom scale; dK and dV are
    exactly 0 at the masked keys."""
    B, Tq, Tk, H, D, kv_len = case
    q, k, v, g = _inputs(B, Tq, Tk, H, D, seed=1)
    o_j, vjp = jax.vjp(lambda q, k, v: jax_fa.blocked_fused_attention(q, k, v, 0.2, kv_len),
                       *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = BlockedFusedAttention.apply(qt, kt, vt, 0.2, kv_len)
    assert not lse.requires_grad
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), **TOL["float32"])
    o.backward(torch.from_numpy(g))
    for name, got, w in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL, err_msg=f"d{name}")
    if kv_len is not None:
        assert not kt.grad[:, kv_len:].any() and not vt.grad[:, kv_len:].any()
        assert not np.asarray(want[1])[:, kv_len:].any()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blocked_backward_passes_equal_autograd_of_plain_forward(case):
    """The plain dK/dV and dQ passes (on CPU tensors, what the wrappers run)
    are the derivative of the plain blocked forward (float32)."""
    B, Tq, Tk, H, D, kv_len = case
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(B, Tq, Tk, H, D, seed=2))
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    o, lse = blocked_attention_reference(qr, kr, vr, kv_len=kv_len)
    o.backward(g)
    delta = attention_delta(o.detach(), g)
    launches = (blocked_attention_dkv.launches, blocked_attention_dq.launches)
    dk, dv = blocked_attention_dkv(q, k, v, g, lse.detach(), delta, kv_len=kv_len)
    dq = blocked_attention_dq(q, k, v, g, lse.detach(), delta, kv_len=kv_len)
    assert (blocked_attention_dkv.launches, blocked_attention_dq.launches) == launches
    for a, b in zip((dq, dk, dv), (qr.grad, kr.grad, vr.grad)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    # the plain versions walk the sequence in chunks; smaller chunks give the same
    prev = port_fa._REF_CHUNK
    port_fa._REF_CHUNK = 64
    try:
        torch.testing.assert_close(
            blocked_attention_dkv_reference(q, k, v, g, lse.detach(), delta, kv_len=kv_len)[0],
            dk, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(
            blocked_attention_dq_reference(q, k, v, g, lse.detach(), delta, kv_len=kv_len),
            dq, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(blocked_attention_reference(q, k, v, kv_len=kv_len)[0],
                                   o.detach(), atol=1e-6, rtol=1e-5)
    finally:
        port_fa._REF_CHUNK = prev


def test_dispatch_sends_long_and_rectangular_to_blocked(monkeypatch):
    """Kernel backend: square T <= VMEM_PATH_MAX_T (read at call time) takes
    FusedAttention, longer or rectangular sequences BlockedFusedAttention,
    shorter than pallas_min_t the plain attention; ``flash_attention`` picks
    the same way."""
    calls = []

    def spy(name, fn):
        class Spy:
            @staticmethod
            def apply(q, k, v, scale=None):
                calls.append((name, q.shape[1], k.shape[1]))
                return fn.apply(q, k, v, scale)
        return Spy

    monkeypatch.setattr(port_fa, "FusedAttention", spy("fused", FusedAttention))
    monkeypatch.setattr(port_fa, "BlockedFusedAttention", spy("blocked", BlockedFusedAttention))
    rng = np.random.RandomState(3)
    x = {t: torch.from_numpy(rng.randn(1, t, 2, 8).astype(np.float32)) for t in (9, 40, 1100)}
    prev = (port_attn.set_attention_backend("kernel"), port_attn.set_pallas_min_t(16))
    try:
        port_attn.dot_product_attention(x[9], x[9], x[9])
        port_attn.dot_product_attention(x[40], x[40], x[40])
        port_attn.dot_product_attention(x[1100], x[1100], x[1100])
        y = port_attn.dot_product_attention(x[40], x[1100], x[1100])
        monkeypatch.setattr(port_fa, "VMEM_PATH_MAX_T", 32)
        port_attn.dot_product_attention(x[40], x[40], x[40])
    finally:
        port_attn.set_attention_backend(prev[0])
        port_attn.set_pallas_min_t(prev[1])
    assert calls == [("fused", 40, 40), ("blocked", 1100, 1100), ("blocked", 40, 1100),
                     ("blocked", 40, 40)]
    torch.testing.assert_close(y, blocked_attention_reference(x[40], x[1100], x[1100])[0])

    calls.clear()  # flash_attention, with VMEM_PATH_MAX_T still 32
    flash_attention(x[9], x[9], x[9])
    flash_attention(x[40], x[40], x[40])
    flash_attention(x[9], x[40], x[40])
    assert calls == [("fused", 9, 9), ("blocked", 40, 40), ("blocked", 9, 40)]
    for bad in (0, 41):
        with pytest.raises(ValueError, match="kv_len"):
            blocked_fused_attention(x[9], x[40], x[40], kv_len=bad)


# The whole slice at a tiny size: 48^3 input, patch 12 (64 patches), width 48,
# 2 + 2 blocks; the decoder runs T = 65, the encoder T = 17 (16 kept + CLS).
TINY48 = dict(input_size=48, patch_size=12, mask_ratio=0.75, in_chans=3,
              pos_embed="sincos", encoder_depth=2, encoder_embed_dim=48, encoder_mlp_dim=96,
              encoder_num_heads=4, decoder_depth=2, decoder_embed_dim=48, decoder_mlp_dim=96,
              decoder_num_heads=4, use_bias=True)
FROZEN = ("patch_embedding.position_embeddings", "decoder_pos_embed")


@pytest.fixture
def blocked_everywhere(monkeypatch):
    """Both sides on their kernels from T = 1, with VMEM_PATH_MAX_T lowered to
    16 so that T = 17 and 65 take the blocked path; JAX blocks of 16 queries
    and 32 keys, so several blocks and ragged tails are exercised."""
    monkeypatch.setattr(jax_fa, "VMEM_PATH_MAX_T", 16)
    monkeypatch.setattr(port_fa, "VMEM_PATH_MAX_T", 16)
    monkeypatch.setattr(jax_fa, "BLOCK_Q", 16)
    monkeypatch.setattr(jax_fa, "BLOCK_K", 32)
    prev = (jax_attn.set_attention_backend("pallas"), jax_attn.set_pallas_min_t(1),
            port_attn.set_attention_backend("kernel"), port_attn.set_pallas_min_t(1))
    yield
    jax_attn.set_attention_backend(prev[0])
    jax_attn.set_pallas_min_t(prev[1])
    port_attn.set_attention_backend(prev[2])
    port_attn.set_pallas_min_t(prev[3])


@functools.lru_cache(maxsize=None)
def _jax_params48():
    init = jax.jit(JaxMAE(**TINY48).init)
    params = init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                  jnp.zeros((1, 3, 48, 48, 48)))["params"]
    rng = np.random.RandomState(6)  # perturb every leaf: the default init zeroes biases
    return jax.tree.map(lambda p: (np.asarray(p) + 0.05 * rng.randn(*p.shape)).astype(np.float32),
                        params)


def test_tiny_mae_on_blocked_path_matches_jax_grad(blocked_everywhere, monkeypatch):
    params = _jax_params48()
    model = JaxMAE(**TINY48)
    x = np.random.RandomState(7).rand(2, 3, 48, 48, 48).astype(np.float32)
    rng = jax.random.PRNGKey(8)
    noise = torch.tensor(np.asarray(jax.random.uniform(rng, (2, 64))))

    def jax_pred(p):
        latent, _, ids = model.apply({"params": p}, jnp.asarray(x), rng, True,
                                     method=JaxMAE.forward_encoder)
        return model.apply({"params": p}, latent, ids, True, method=JaxMAE.forward_decoder)

    def jax_loss(p):
        return model.apply({"params": p}, jnp.asarray(x), deterministic=True, mask_rng=rng)[0]

    pred_j = jax_pred(params)
    loss_j, grads_j = jax.value_and_grad(jax_loss)(params)

    seen = []

    class Spy(BlockedFusedAttention):
        @staticmethod
        def forward(ctx, q, k, v, scale=None, kv_len=None):
            seen.append(q.shape[1])
            return BlockedFusedAttention.forward(ctx, q, k, v, scale, kv_len)

    monkeypatch.setattr(port_fa, "BlockedFusedAttention", Spy)
    port = MaskedAutoencoderViT(**TINY48)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    loss, pred, _ = port(torch.from_numpy(x), noise=noise)
    assert seen == [17, 17, 65, 65]
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(pred_j), atol=5e-4, rtol=1e-3)
    loss.backward()
    want = state_dict_from_jax(jax.tree.map(np.asarray, grads_j))
    compared = 0
    for name, p in port.named_parameters():
        if name in FROZEN:
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-4, rtol=1e-3,
                                   err_msg=name)
        compared += 1
    assert compared == len(want) - len(FROZEN)


def _config_192(width: int = 48):
    """configs/mae/mae_HeadCT_192.yaml at width 48 (the geometry that decides
    the dispatch, INPUT_SIZE / PATCH_SIZE / MASK_RATIO, is the recipe's own)."""
    cfg = default_config()
    cfg.merge_from_file(str(ROOT / "configs/mae/mae_HeadCT_192.yaml"))
    cfg.merge_from_list(["MAE.ENCODER_DEPTH", 2, "MAE.DECODER_DEPTH", 1,
                         "MAE.ENCODER_EMBED_DIM", width, "MAE.DECODER_EMBED_DIM", width,
                         "MAE.ENCODER_MLP_DIM", 2 * width, "MAE.DECODER_MLP_DIM", 2 * width,
                         "MAE.ENCODER_NUM_HEADS", 4, "MAE.DECODER_NUM_HEADS", 4,
                         "DATA.WIRE_FORMAT", "hu16"])
    return cfg


def test_192_geometry_takes_blocked_path_on_cpu(monkeypatch):
    """The 192^3 recipe's attention shapes, the 1025-token masked encoder and
    the 4097-token decoder, go through BlockedFusedAttention and never
    FusedAttention in a real train step (tests/test_kernels.py:210 holds the
    JAX package to the same)."""
    seen = {"fused": [], "blocked": []}

    def spy(name, fn):
        class Spy(fn):
            @staticmethod
            def forward(ctx, q, k, v, *args):
                seen[name].append(q.shape[1])
                return fn.forward(ctx, q, k, v, *args)
        return Spy

    monkeypatch.setattr(port_fa, "FusedAttention", spy("fused", FusedAttention))
    monkeypatch.setattr(port_fa, "BlockedFusedAttention", spy("blocked", BlockedFusedAttention))
    cfg = _config_192()
    prev = port_attn.set_attention_backend("kernel")
    try:
        state, _ = mae_engine.create_train_state(cfg, 4, 1, seed=0, device="cpu")
        step = mae_engine.make_train_step(augment=True, config=cfg)
        wire = hu16_encode(np.random.RandomState(0).uniform(-1000, 1500, (1, 1, 192, 192, 192)))
        state, metrics = step(state, torch.from_numpy(wire), seed=0)
    finally:
        port_attn.set_attention_backend(prev)
    assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))
    assert seen == {"fused": [], "blocked": [1025, 1025, 4097]}


def test_remat_gives_the_same_gradients():
    """PARALLEL.REMAT recomputes each block's MLP in the backward (its forward
    runs twice per block) and leaves the loss and every gradient unchanged."""
    grads, losses, mlp_calls = [], [], []
    x = torch.from_numpy(np.random.RandomState(9).rand(2, 3, 24, 24, 24).astype(np.float32))
    noise = torch.from_numpy(np.random.RandomState(10).rand(2, 8).astype(np.float32))
    for remat in (False, True):
        cfg = default_config()
        cfg.merge_from_list(["MAE.INPUT_SIZE", 24, "MAE.PATCH_SIZE", 12, "MAE.ENCODER_DEPTH", 2,
                             "MAE.ENCODER_EMBED_DIM", 48, "MAE.ENCODER_MLP_DIM", 96,
                             "MAE.ENCODER_NUM_HEADS", 4, "MAE.DECODER_DEPTH", 2,
                             "MAE.DECODER_EMBED_DIM", 48, "MAE.DECODER_MLP_DIM", 96,
                             "MAE.DECODER_NUM_HEADS", 4, "PARALLEL.REMAT", remat])
        model = mae_engine.build_mae_model(cfg, dtype=torch.float32)
        model.init_weights(torch.Generator().manual_seed(0))
        assert all(b.remat_mlp == remat for b in [*model.blocks, *model.decoder_blocks])
        calls = [0]
        for b in [*model.blocks, *model.decoder_blocks]:  # count the MLP forwards
            def counted(h, fwd=b.mlp.forward):
                calls[0] += 1
                return fwd(h)
            b.mlp.forward = counted
        loss, _, _ = model(x, noise=noise)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
        mlp_calls.append(calls[0])
    assert mlp_calls == [4, 8]
    assert losses[0] == losses[1]
    assert sorted(grads[0]) == sorted(grads[1])
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], atol=0, rtol=0, msg=n)
