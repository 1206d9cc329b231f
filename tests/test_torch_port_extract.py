"""PyTorch port: feature extraction beyond the CLS embedding and retrieval,
against the JAX package on the CPU, at the oracle size (24^3 input, patch
12, width 48, 2 layers; ``tests/test_parity_oracle.py:35``).

* ``interpolate_pos_embed`` against JAX's, which resizes with
  ``jax.image.resize(method="linear")`` and so antialiases when an axis
  shrinks: up (4 -> 8), down (8 -> 6, 8 -> 4, 16 -> 8) and to a non-cubic
  grid (8 -> (6, 8, 10)) within 1e-5; the identity returns its input; JAX's
  two errors raise.
* The ViT at a non-cubic and at a larger input, and ``merge_params`` of a
  grid-8 tree into a grid-4 and a grid-16 model, against JAX on the same
  weights: cosine >= 0.999 and max abs <= 1e-4 (``tests/test_parity_oracle.py:239``).
* ``attention_maps``, ``cls_attention_grid`` (with register tokens) and
  ``cls_attention_volume`` against the JAX extractor's within 1e-5, with
  LoRA off (the extractors) and on (the ViTs with ``save_attn``); the
  ``save_attn`` forward equals the kernel forward, rows sum to 1.
* ``retrieval_map``, ``retrieval_map_per_class`` and ``average_precision``
  equal JAX's exactly (the same numpy); ``tools.eval_retrieval`` runs end
  to end on the CPU on 6 generated heads and prints the JAX tool's keys.
* The extractor loads a pickle of either package (an MAE-like tree and a
  DINO ``{backbone, head}`` one) as the JAX extractor does: CLS within 1e-5.
"""

import json
import pickle
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.eval import retrieval as jax_retrieval
from headct_foundation_tpu.feature_extraction import FeatureExtractor as JaxExtractor
from headct_foundation_tpu.feature_extraction import cls_attention_grid as jax_cls_grid
from headct_foundation_tpu.models.pos_embed import interpolate_pos_embed as jax_interpolate
from headct_foundation_tpu.models.vit import ViT as JaxViT
from headct_foundation_tpu.utils.torch_interop import merge_params as jax_merge
from headct_foundation_tpu_torch.eval import retrieval
from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor, cls_attention_grid
from headct_foundation_tpu_torch.models.pos_embed import interpolate_pos_embed
from headct_foundation_tpu_torch.models.vit import ViT
from headct_foundation_tpu_torch.utils.torch_interop import merge_params, state_dict_from_jax

TINY = dict(in_chans=3, patch_size=12, hidden_size=48, mlp_dim=96, num_layers=2, num_heads=4,
            pos_embed="sincos", qkv_bias=True)
EXTRACT = dict(img_size=24, patch_size=12, in_chans=3, hidden_size=48, mlp_dim=96,
               num_layers=2, num_heads=4)
COS, MAX_ABS, ATOL = 0.999, 1e-4, 1e-5


def _perturbed(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: (np.asarray(p) + 0.05 * rng.randn(*p.shape)).astype(np.float32), params)


def _jax_vit(img_size, seed=0, **kw):
    model = JaxViT(img_size=img_size, **{**TINY, **kw})
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3) + (img_size,) * 3))["params"]
    return model, _perturbed(params, seed)


def _port_vit(img_size, sd, **kw):
    vit = ViT(img_size=img_size, **{**TINY, **kw})
    vit.load_state_dict(sd, strict=True)
    return vit.eval()


def _hold(got: torch.Tensor, want) -> None:
    a, b = got.detach().numpy().ravel(), np.asarray(want).ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos >= COS and np.abs(a - b).max() <= MAX_ABS, (cos, np.abs(a - b).max())


@pytest.mark.parametrize("src,dst", [(4, 8), (8, 6), (8, 4), (16, 8), (8, (6, 8, 10))],
                         ids=["up-4-8", "down-8-6", "down-8-4", "down-16-8", "noncubic"])
def test_interpolate_pos_embed_matches_jax(src, dst):
    pe = np.random.RandomState(0).randn(1, 2 + src ** 3, 5).astype(np.float32)
    kw = dict(new_grid=dst) if isinstance(dst, tuple) else dict(new_num_patches=dst ** 3)
    want = np.asarray(jax_interpolate(jnp.asarray(pe), 2, **kw))
    got = interpolate_pos_embed(torch.from_numpy(pe), 2, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[:, :2].numpy(), pe[:, :2])  # CLS, registers


def test_interpolate_pos_embed_identity_and_errors():
    pe = torch.from_numpy(np.random.RandomState(1).randn(1, 1 + 64, 6).astype(np.float32))
    assert interpolate_pos_embed(pe, 1, new_num_patches=64) is pe
    assert interpolate_pos_embed(pe, 1, new_grid=(4, 4, 4)) is pe
    bad = np.zeros((1, 9, 6), np.float32)  # 9 patches: not a cube
    for fn, x in ((jax_interpolate, jnp.asarray(bad)), (interpolate_pos_embed,
                                                         torch.from_numpy(bad))):
        with pytest.raises(ValueError, match="cubic source grid"):
            fn(x, 0, new_num_patches=8)
    for fn, x in ((jax_interpolate, jnp.asarray(pe.numpy())), (interpolate_pos_embed, pe)):
        with pytest.raises(ValueError, match="not a perfect"):
            fn(x, 1, new_num_patches=100)
        with pytest.raises(ValueError, match="new_num_patches or new_grid"):
            fn(x, 1)


@pytest.mark.parametrize("shape", [(24, 36, 48), (48, 48, 48)], ids=["noncubic", "larger"])
def test_vit_at_another_input_size_matches_jax(shape):
    model, params = _jax_vit(24, seed=2)
    vit = _port_vit(24, state_dict_from_jax(params))
    x = np.random.RandomState(3).rand(2, 3, *shape).astype(np.float32)
    want, hidden_j = model.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got, hidden = vit(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 1 + int(np.prod(shape)) // 12 ** 3, 48)
    _hold(got, want)
    for a, b in zip(hidden, hidden_j):
        _hold(a, b)


@pytest.mark.parametrize("img_size", [48, 192], ids=["grid-4", "grid-16"])
def test_merge_params_across_grids_matches_jax(img_size):
    """A grid-8 (96^3) tree merged into a model of another grid: the same
    merged weights (the position embedding interpolated) and outputs."""
    _, source = _jax_vit(96, seed=4)
    model, target = _jax_vit(img_size, seed=5)
    merged_j, missing_j, unexpected_j = jax_merge(target, source)
    vit = _port_vit(img_size, state_dict_from_jax(target))
    merged, missing, unexpected = merge_params(vit.state_dict(), state_dict_from_jax(source))
    assert missing == missing_j == [] and unexpected == unexpected_j == []
    want_sd = state_dict_from_jax(jax.tree.map(np.asarray, merged_j))
    assert set(merged) == set(want_sd)
    pe = "patch_embedding.position_embeddings"
    assert merged[pe].shape == (1, (img_size // 12) ** 3, 48)
    np.testing.assert_allclose(merged[pe].numpy(), want_sd[pe].numpy(), rtol=0, atol=ATOL)
    for k in merged:
        if k != pe:
            np.testing.assert_array_equal(merged[k].numpy(), want_sd[k].numpy(), err_msg=k)
    vit.load_state_dict(merged)
    x = np.random.RandomState(6).rand(1, 3, img_size, img_size, img_size).astype(np.float32)
    want, _ = model.apply({"params": merged_j}, jnp.asarray(x))
    with torch.no_grad():
        got, _ = vit(torch.from_numpy(x))
    _hold(got, want)


def test_merge_params_reports_other_mismatches_as_unexpected():
    """A shape mismatch that is not a cube-to-cube position embedding is
    reported, as JAX reports it, not raised."""
    target = {"a.weight": torch.zeros(3, 4),
              "patch_embedding.position_embeddings": torch.zeros(1, 8, 6)}
    source = {"a.weight": np.zeros((4, 4), np.float32),
              "patch_embedding.position_embeddings": np.zeros((1, 9, 6), np.float32)}
    merged, missing, unexpected = merge_params(target, source)
    assert missing == [] and len(unexpected) == 2
    assert all(torch.equal(merged[k], target[k]) for k in target)


@pytest.fixture(scope="module")
def extractors():
    """(JAX extractor, port extractor) with 2 register tokens on the same
    perturbed weights."""
    jfe = JaxExtractor(num_register_tokens=2, **EXTRACT)
    params = _perturbed(jfe.params, 7)
    jfe.params = jax.tree.map(jnp.asarray, params)
    pfe = FeatureExtractor(device="cpu", num_register_tokens=2, **EXTRACT)
    pfe.model.load_state_dict(state_dict_from_jax(params), strict=True)
    return jfe, pfe


def _volumes(b=2, seed=8):
    return np.random.RandomState(seed).rand(b, 3, 24, 24, 24).astype(np.float32)


def test_attention_maps_and_cls_attention_match_jax(extractors):
    jfe, pfe = extractors
    x = _volumes()
    want, got = jfe.attention_maps(x), pfe.attention_maps(x)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.shape == b.shape == (2, 4, 11, 11) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
        np.testing.assert_allclose(a.sum(-1), 1.0, rtol=0, atol=1e-5)
    for layer, head in ((-1, None), (0, 1)):
        grid = cls_attention_grid(got, (2, 2, 2), num_register_tokens=2, layer=layer, head=head)
        want_grid = jax_cls_grid(want, (2, 2, 2), num_register_tokens=2, layer=layer, head=head)
        np.testing.assert_allclose(grid, want_grid, rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            pfe.cls_attention_volume(x, layer=layer, head=head),
            jfe.cls_attention_volume(x, layer=layer, head=head), rtol=0, atol=ATOL)
    assert pfe.cls_attention_volume(x[0]).shape == (1, 24, 24, 24)
    # save_attn is off again, and its forward is the kernel forward's
    assert not pfe.model.blocks[0].attn.save_attn
    with pytest.raises(ValueError, match="do not fill the grid"):
        cls_attention_grid(got, (2, 2, 2), num_register_tokens=0)


def test_attention_maps_with_lora_match_jax():
    model, params = _jax_vit(24, seed=9, lora=True, num_register_tokens=2)
    vit = _port_vit(24, state_dict_from_jax(params), lora=True, num_register_tokens=2)
    x = _volumes(seed=10)
    (out_j, _), inter = model.clone(save_attn=True).apply({"params": params}, jnp.asarray(x),
                                                          mutable=["intermediates"])
    want = [np.asarray(inter["intermediates"][f"blocks_{i}"]["attn"]["att_mat"][0])
            for i in range(2)]
    with torch.no_grad():
        out_plain, _ = vit(torch.from_numpy(x))
        assert vit.set_save_attn(True) is False
        out, _ = vit(torch.from_numpy(x))
    got = [blk.attn.att_mat.numpy() for blk in vit.blocks]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    np.testing.assert_allclose(cls_attention_grid(got, (2, 2, 2), 2),
                               jax_cls_grid(want, (2, 2, 2), 2), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0, atol=MAX_ABS)
    np.testing.assert_allclose(out.numpy(), out_plain.numpy(), rtol=0, atol=ATOL)
    assert vit.set_save_attn(False) is True and vit.blocks[1].attn.att_mat is None


def test_retrieval_equals_jax():
    rng = np.random.RandomState(11)
    emb = rng.randn(20, 16).astype(np.float32)
    labels = {"a": rng.randint(0, 2, 20), "b": (rng.rand(20) < 0.2).astype(int),
              "none": np.zeros(20, int)}
    np.testing.assert_array_equal(retrieval.cosine_similarity_matrix(emb),
                                  jax_retrieval.cosine_similarity_matrix(emb))
    for rel in ([1, 0, 1, 1, 0], [0, 0, 0], rng.randint(0, 2, 30)):
        a, b = retrieval.average_precision(rel), jax_retrieval.average_precision(rel)
        assert a == b or (np.isnan(a) and np.isnan(b))
    mask = rng.rand(20) < 0.5
    for y in labels.values():
        for m in (None, mask):
            a, b = retrieval.retrieval_map(emb, y, m), jax_retrieval.retrieval_map(emb, y, m)
            assert a == b or (np.isnan(a) and np.isnan(b))
    a = retrieval.retrieval_map_per_class(emb, labels)
    b = jax_retrieval.retrieval_map_per_class(emb, labels)
    assert a.keys() == b.keys() and all(a[k] == b[k] or np.isnan(a[k]) for k in a)


def _write_tree(path, payload):
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


@pytest.mark.parametrize("kind", ["mae", "dino"])
def test_extractor_loads_a_pickle_of_either_package(tmp_path, kind):
    """An MAE-like ``{"state_dict": tree}`` pickle and a DINO ``{"params":
    {"backbone", "head"}}`` one (the backbone is taken): the same CLS as the
    JAX extractor loading the same file."""
    jfe = JaxExtractor(**EXTRACT)
    tree = _perturbed(jfe.params, 12)
    path = str(tmp_path / f"{kind}.ckpt")
    if kind == "mae":
        _write_tree(path, {"state_dict": tree, "epoch": 1})
    else:
        head = {"mlp_0": {"kernel": np.ones((48, 8), np.float32),
                          "bias": np.zeros(8, np.float32)}}
        _write_tree(path, {"params": {"backbone": tree, "head": head}, "epoch": 1, "step": 3})
    want = JaxExtractor(checkpoint_path=path, **EXTRACT)
    got = FeatureExtractor(checkpoint_path=path, device="cpu", **EXTRACT)
    assert got.missing == [] and got.unexpected == []
    x = _volumes(seed=13)
    np.testing.assert_allclose(got.cls_embedding(x), want.cls_embedding(x), rtol=0, atol=ATOL)
    for k, v in state_dict_from_jax(tree).items():
        assert torch.equal(got.model.state_dict()[k], v), k


def test_extractor_warm_starts_another_grid_from_an_mae_file(tmp_path):
    """A port MAE checkpoint into extractors at 24^3 and at 48^3: 0
    missing, the same unexpected decoder names at both sizes (none a shape
    mismatch), the 48^3 position embedding interpolated from the file's."""
    from headct_foundation_tpu_torch.engines import mae_engine
    from headct_foundation_tpu_torch.utils import checkpoint as ckpt
    from tests.test_torch_port_train import _configs

    state, _ = mae_engine.create_train_state(_configs()[1], 4, 1, seed=0, device="cpu")
    path = ckpt.save_checkpoint(state, 0, 1.0, str(tmp_path), "mae.ckpt")
    small = FeatureExtractor(checkpoint_path=path, device="cpu", **EXTRACT)
    big = FeatureExtractor(checkpoint_path=path, device="cpu", **{**EXTRACT, "img_size": 48})
    assert small.missing == big.missing == []
    assert small.unexpected == big.unexpected and small.unexpected
    assert not any("shape" in u for u in big.unexpected)
    pe = state.model.state_dict()["patch_embedding.position_embeddings"]
    np.testing.assert_allclose(
        big.model.state_dict()["patch_embedding.position_embeddings"].numpy(),
        interpolate_pos_embed(pe, 0, new_num_patches=64).numpy(), rtol=0, atol=0)


def test_eval_retrieval_tool_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    from headct_foundation_tpu_torch.tools import eval_retrieval
    from headct_foundation_tpu_torch.tools.cli_runs import CQ500_COLUMNS, write_label_manifest, \
        write_scans

    paths = write_scans(tmp_path, range(6))
    write_label_manifest(tmp_path / "labels.csv", paths, seed=0)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("VIT:\n  INPUT_SIZE: 24\n  PATCH_SIZE: 12\n  IN_CHANS: 3\n  HIDDEN_SIZE: 48\n"
                   "  MLP_DIM: 96\n  NUM_LAYERS: 2\n  NUM_HEADS: 4\n  USE_BIAS: True\n"
                   "  POS_EMBED: sincos\n")
    jfe = JaxExtractor(**EXTRACT)
    ckpt = str(tmp_path / "enc.ckpt")
    _write_tree(ckpt, {"params": _perturbed(jfe.params, 14), "epoch": 0})
    args = ["--cfg", str(cfg), "--csv", str(tmp_path / "labels.csv"), "--checkpoint", ckpt,
            "--batch-size", "4"]
    out = eval_retrieval.main(args + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    info = json.loads(lines[-2])["retrieval"]
    assert info["scans"] == 6 and info["device"] == "cpu" and info["embed_seconds"] > 0
    assert set(info["launches"].values()) == {0}  # the CPU runs the plain versions
    # the JAX tool on the same manifest and file prints the same keys
    monkeypatch.setattr(sys, "argv", ["eval_retrieval.py"] + args)
    runpy.run_path("tools/eval_retrieval.py", run_name="__main__")
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out) == list(want) == [f"mAP_{c}" for c in CQ500_COLUMNS]
    assert all(isinstance(v, float) for v in out.values())
