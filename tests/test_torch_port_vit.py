"""PyTorch port: weights bridge, patch/position embeddings and the ViT,
held against the JAX package on the same weights and inputs.

The JAX ViT runs with the Pallas attention backend and ``pallas_min_t`` 1,
so its T=9 blocks go through ``fused_attention`` (interpreted on the CPU),
as tests/test_kernels.py runs it; the port runs its kernel path, which on
the CPU is the kernel's plain version. Both setters' previous values are
restored afterwards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.models.patch_embed import patchify3d as jax_patchify3d
from headct_foundation_tpu.models.pos_embed import (
    build_sincos_position_embedding as jax_sincos,
)
from headct_foundation_tpu.models.vit import ViT as JaxViT
from headct_foundation_tpu.ops import attention as jax_attn
from headct_foundation_tpu.utils.torch_interop import tree_to_torch
from headct_foundation_tpu_torch.models.patch_embed import patchify3d
from headct_foundation_tpu_torch.models.pos_embed import build_sincos_position_embedding
from headct_foundation_tpu_torch.models.vit import ViT
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.utils.torch_interop import state_dict_from_jax, strip_prefixes

TINY = dict(in_chans=3, img_size=24, patch_size=12, hidden_size=48, mlp_dim=96,
            num_layers=2, num_heads=4, pos_embed="sincos", qkv_bias=True)


def _jax_params(num_register_tokens: int, seed: int = 0):
    """A tiny JAX ViT's parameters as numpy, every leaf perturbed by a seeded
    numpy draw (the default init zeroes biases, CLS and registers)."""
    model = JaxViT(num_register_tokens=num_register_tokens, **TINY)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 24, 24, 24)))["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda p: (np.asarray(p) + 0.05 * rng.randn(*p.shape)).astype(np.float32), params)
    return model, params


def _port_vit(params, num_register_tokens: int) -> ViT:
    vit = ViT(num_register_tokens=num_register_tokens, **TINY)
    vit.load_state_dict(state_dict_from_jax(params), strict=True)
    return vit.eval()


@pytest.mark.parametrize("regs", [0, 2])
def test_state_dict_from_jax_equals_tree_to_torch(regs):
    _, params = _jax_params(regs)
    want = tree_to_torch(params)
    got = state_dict_from_jax(params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["patch_embedding.patch_embeddings.weight"].shape == (48, 3, 12, 12, 12)
    assert ("register_tokens" in got) == bool(regs)
    vit = ViT(num_register_tokens=regs, **TINY)
    assert sorted(vit.state_dict()) == sorted(got)
    vit.load_state_dict(got, strict=True)


def test_strip_prefixes():
    sd = {"module.backbone.blocks.0.attn.qkv.weight": 1, "_orig_mod.cls_token": 2, "norm.bias": 3}
    assert strip_prefixes(sd) == {"blocks.0.attn.qkv.weight": 1, "cls_token": 2, "norm.bias": 3}


@pytest.mark.parametrize("grid", [(2, 2, 2), (2, 3, 4)])
def test_sincos_and_patchify_match_jax(grid):
    np.testing.assert_array_equal(build_sincos_position_embedding(grid, 48),
                                  jax_sincos(grid, 48))
    x = np.random.RandomState(3).randn(2, 3, *(g * 4 for g in grid)).astype(np.float32)
    np.testing.assert_array_equal(patchify3d(torch.from_numpy(x), (4, 4, 4)).numpy(),
                                  np.asarray(jax_patchify3d(jnp.asarray(x), (4, 4, 4))))


@pytest.mark.parametrize("regs", [0, 2])
@pytest.mark.parametrize("exact_gelu", ["0", "1"])
def test_vit_matches_jax(monkeypatch, exact_gelu, regs):
    monkeypatch.setenv("HEADCT_EXACT_GELU", exact_gelu)
    model, params = _jax_params(regs, seed=1 + regs)
    x = np.random.RandomState(4).rand(2, 3, 24, 24, 24).astype(np.float32)
    vit = _port_vit(params, regs)

    prev_j = (jax_attn.set_attention_backend("pallas"), jax_attn.set_pallas_min_t(1))
    prev_p = (port_attn.set_attention_backend("kernel"), port_attn.set_pallas_min_t(1))
    try:
        last_j, hidden_j = model.apply({"params": params}, jnp.asarray(x))
        with torch.no_grad():
            last_t, hidden_t = vit(torch.from_numpy(x))
    finally:
        jax_attn.set_attention_backend(prev_j[0])
        jax_attn.set_pallas_min_t(prev_j[1])
        port_attn.set_attention_backend(prev_p[0])
        port_attn.set_pallas_min_t(prev_p[1])

    assert last_t.shape == (2, 1 + regs + 8, 48)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), atol=1e-5, rtol=1e-4)
    assert len(hidden_t) == len(hidden_j) == 2
    for a, b in zip(hidden_t, hidden_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-4)


def test_feature_extractor_loads_a_reference_checkpoint(tmp_path):
    """A reference .pt with DDP/compile prefixes under 'state_dict' loads by
    name, as the notebook loads it (prefixes stripped, strict=False)."""
    from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor

    _, params = _jax_params(0, seed=5)
    sd = {f"module._orig_mod.{k}": v for k, v in state_dict_from_jax(params).items()}
    path = tmp_path / "ref.pt"
    torch.save({"state_dict": sd, "epoch": 3}, path)
    fe = FeatureExtractor(checkpoint_path=str(path), device="cpu", **TINY)
    got = fe.model.state_dict()
    for k, v in state_dict_from_jax(params).items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_vit_rejects_other_input_sizes():
    """A size the patch does not divide still raises; a non-cubic one (once
    refused) runs on its own grid, its position embedding interpolated."""
    vit = ViT(**TINY).eval()
    with pytest.raises(ValueError, match="not divisible by the patch size"):
        vit(torch.zeros(1, 3, 30, 24, 24))
    with torch.no_grad():
        out, hidden = vit(torch.rand(1, 3, 36, 24, 24))
    assert out.shape == (1, 1 + 3 * 2 * 2, 48) and len(hidden) == 2
    assert bool(torch.isfinite(out).all())
