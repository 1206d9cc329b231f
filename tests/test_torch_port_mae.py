"""PyTorch port: the MAE pieces of the training slice, held against the JAX
package on the same weights, inputs and injected randomness.

Masking gets the noise ``jax.random`` drew, the augmentation the decisions
it drew. The JAX MAE runs with the Pallas attention backend and
``pallas_min_t`` 1, so every block goes through the interpreted Pallas
forward and backward kernels; the port's kernel backend runs
``FusedAttention``, whose CPU forward and backward are the kernels' plain
versions. Both setters' previous values are restored afterwards.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.data import augment as jax_augment
from headct_foundation_tpu.data import device_preprocess as jax_dp
from headct_foundation_tpu.data import transforms as jax_transforms
from headct_foundation_tpu.models.mae import MaskedAutoencoderViT as JaxMAE
from headct_foundation_tpu.ops import attention as jax_attn
from headct_foundation_tpu.ops.masking import random_masking as jax_random_masking
from headct_foundation_tpu.utils.torch_interop import tree_to_torch
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.data import transforms
from headct_foundation_tpu_torch.data.augment import apply_mae_augment, mae_augment
from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
from headct_foundation_tpu_torch.models.mae import MaskedAutoencoderViT
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.ops.masking import random_masking
from headct_foundation_tpu_torch.utils.torch_interop import state_dict_from_jax

TINY = dict(input_size=24, patch_size=12, mask_ratio=0.75, in_chans=3,
            pos_embed="sincos", encoder_depth=2, encoder_embed_dim=48, encoder_mlp_dim=96,
            encoder_num_heads=4, decoder_depth=2, decoder_embed_dim=48, decoder_mlp_dim=96,
            decoder_num_heads=4, use_bias=True)
FROZEN = ("patch_embedding.position_embeddings", "decoder_pos_embed")


def jax_augment_decisions(rng, batch: int) -> dict:
    """The decisions ``data/augment.py:246 mae_augment`` draws from rng,
    as the port's ``apply_mae_augment`` takes them."""
    shape = (batch, 1, 1, 1, 1)
    keys = jax.random.split(rng, 5)
    flip = [np.asarray(jax.random.bernoulli(keys[i], 0.1, shape)).reshape(batch)
            for i in range(3)]
    k1, k2 = jax.random.split(keys[3])
    shift = jax.random.uniform(k1, shape, minval=-0.1, maxval=0.1)
    on = jax.random.bernoulli(k2, 0.5, shape)
    return {"flip": torch.from_numpy(np.stack(flip)),
            "shift": torch.from_numpy(np.asarray(shift).reshape(batch)),
            "shift_on": torch.from_numpy(np.asarray(on).reshape(batch))}


@pytest.fixture
def pallas_backends():
    """JAX on the Pallas kernels, the port on its kernel backend, both from T=1."""
    prev = (jax_attn.set_attention_backend("pallas"), jax_attn.set_pallas_min_t(1),
            port_attn.set_attention_backend("kernel"), port_attn.set_pallas_min_t(1))
    yield
    jax_attn.set_attention_backend(prev[0])
    jax_attn.set_pallas_min_t(prev[1])
    port_attn.set_attention_backend(prev[2])
    port_attn.set_pallas_min_t(prev[3])


def test_random_masking_with_injected_noise():
    x = np.random.RandomState(0).randn(3, 8, 5).astype(np.float32)
    rng = jax.random.PRNGKey(4)
    want = jax_random_masking(rng, jnp.asarray(x), 0.75)
    noise = torch.tensor(np.asarray(jax.random.uniform(rng, (3, 8))))
    got = random_masking(torch.from_numpy(x), 0.75, noise=noise)
    assert got[0].shape == (3, 2, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mae_augment_with_injected_decisions(dtype):
    x = np.random.RandomState(1).rand(32, 2, 4, 5, 6).astype(np.float32)
    rng = jax.random.PRNGKey(2)
    want = jax_augment.mae_augment(rng, jnp.asarray(x, dtype=dtype))
    decisions = jax_augment_decisions(rng, 32)
    assert decisions["flip"].any() and decisions["shift_on"].any()
    got = apply_mae_augment(torch.from_numpy(x).to(getattr(torch, dtype)), decisions)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    with pytest.raises(NotImplementedError):
        mae_augment(torch.from_numpy(x), torch.Generator().manual_seed(0), reshape=False)


@pytest.mark.parametrize("wire", ["hu16", "hu8", "windowed"])
@pytest.mark.parametrize("in_chans", [1, 3])
def test_wire_to_compute_matches_jax(wire, in_chans):
    hu = np.random.RandomState(3).uniform(-1100, 2200, (2, 1, 6, 5, 4)).astype(np.float32)
    if wire == "hu16":
        batch = transforms.hu16_encode(hu)
        np.testing.assert_array_equal(batch, jax_transforms.hu16_encode(hu))
    elif wire == "hu8":
        batch = transforms.hu8_encode(hu)
        np.testing.assert_array_equal(batch, jax_transforms.hu8_encode(hu))
    else:
        batch = np.clip(hu / 1000.0, 0, 1).repeat(in_chans, axis=1)
    cfg = default_config()
    cfg.DATA.WIRE_FORMAT = wire
    for dtype in ("bfloat16", "float32"):
        want = jax_dp.wire_to_compute(jnp.asarray(batch), cfg, in_chans, getattr(jnp, dtype))
        got = wire_to_compute(torch.from_numpy(batch), cfg, in_chans, getattr(torch, dtype))
        assert got.dtype == getattr(torch, dtype) and got.shape[1] == in_chans
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@functools.lru_cache(maxsize=None)
def _jax_init_params():
    init = jax.jit(JaxMAE(**TINY).init)
    return init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                jnp.zeros((1, 3, 24, 24, 24)))["params"]


def _jax_mae(norm_pix: bool, seed: int = 0):
    """A tiny JAX MAE and its parameters as numpy, every leaf perturbed by a
    seeded numpy draw (the default init zeroes biases)."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda p: (np.asarray(p) + 0.05 * rng.randn(*p.shape)).astype(np.float32),
        _jax_init_params())
    return JaxMAE(norm_pix_loss=norm_pix, **TINY), params


def _port_mae(params, norm_pix: bool) -> MaskedAutoencoderViT:
    m = MaskedAutoencoderViT(norm_pix_loss=norm_pix, **TINY)
    m.load_state_dict(state_dict_from_jax(params), strict=True)
    return m


def test_state_dict_from_jax_maps_the_whole_mae_tree():
    _, params = _jax_mae(False)
    got = state_dict_from_jax(params)
    want = tree_to_torch(params)
    port = MaskedAutoencoderViT(**TINY).state_dict()
    assert sorted(got) == sorted(want) == sorted(port)
    for name in ("cls_token", "mask_token", "decoder_cls_token", "decoder_pos_embed",
                 "decoder_embed.weight", "decoder_pred.weight", "decoder_blocks.1.attn.qkv.bias",
                 "norm.weight", "decoder_norm.bias"):
        assert name in got, name
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert got[k].shape == port[k].shape, k
    frozen = {n for n, p in MaskedAutoencoderViT(**TINY).named_parameters()
              if not p.requires_grad}
    assert frozen == set(FROZEN)


@pytest.mark.parametrize("norm_pix", [False, True])
def test_mae_forward_and_gradients_match_jax(pallas_backends, norm_pix):
    model, params = _jax_mae(norm_pix)
    x = np.random.RandomState(5).rand(2, 3, 24, 24, 24).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    noise = torch.tensor(np.asarray(jax.random.uniform(rng, (2, 8))))

    @jax.jit
    def jax_run(p):
        latent, mask, ids = model.apply({"params": p}, jnp.asarray(x), rng, True,
                                        method=JaxMAE.forward_encoder)
        pred = model.apply({"params": p}, latent, ids, True, method=JaxMAE.forward_decoder)
        return latent, mask, ids, pred

    def jax_loss(p):
        return model.apply({"params": p}, jnp.asarray(x), deterministic=True, mask_rng=rng)[0]

    latent_j, mask_j, ids_j, pred_j = jax_run(params)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss))(params)

    port = _port_mae(params, norm_pix)
    xt = torch.from_numpy(x)
    latent, mask, ids = port.forward_encoder(xt, noise=noise)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(latent.detach().numpy(), np.asarray(latent_j),
                               atol=3e-4, rtol=1e-3)
    pred = port.forward_decoder(latent, ids)
    p1, p2 = pred.detach().numpy(), np.asarray(pred_j)
    assert np.sum(p1 * p2) / (np.linalg.norm(p1) * np.linalg.norm(p2)) > 0.9999
    np.testing.assert_allclose(p1, p2, atol=1e-3, rtol=1e-3)

    loss, _, _ = port(xt, noise=noise)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-4, atol=2e-5)
    loss.backward()
    want = state_dict_from_jax(jax.tree.map(np.asarray, grads_j))
    compared = 0
    for name, p in port.named_parameters():
        if name in FROZEN:
            assert p.grad is None, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-4, rtol=1e-3,
                                   err_msg=name)
        compared += 1
    assert compared == len(want) - len(FROZEN)


def test_mae_bfloat16_compute_keeps_float32_params():
    """dtype=bfloat16: float32 parameters, a bfloat16 residual stream and
    prediction, a float32 loss; gradients land on the float32 parameters."""
    port = MaskedAutoencoderViT(dtype=torch.bfloat16, **TINY).init_weights(
        torch.Generator().manual_seed(0))
    x = torch.rand(2, 3, 24, 24, 24, generator=torch.Generator().manual_seed(1))
    latent, _, ids = port.forward_encoder(x.bfloat16(), generator=torch.Generator().manual_seed(2))
    assert latent.dtype == torch.bfloat16
    loss, pred, mask = port(x.bfloat16(), generator=torch.Generator().manual_seed(2))
    assert pred.dtype == torch.bfloat16 and loss.dtype == torch.float32
    assert mask.shape == (2, 8) and int(mask.sum()) == 12
    loss.backward()
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert port.blocks[0].attn.qkv.weight.grad.dtype == torch.float32
    with pytest.raises(NotImplementedError):
        MaskedAutoencoderViT(dropout_rate=0.1, **TINY)
