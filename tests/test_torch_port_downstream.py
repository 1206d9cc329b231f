"""PyTorch port: the downstream modules against the JAX package on the CPU.

Same inputs (numpy from a seed) and the JAX init carried across with
``state_dict_from_jax`` (its ``batch_stats`` as the BatchNorm buffers).
Tolerances:

* BatchNorm in both classifiers, float32, train mode three times then eval:
  logits within 1e-5 relative (of the largest); running mean and variance
  within 1e-6; one value per channel in train mode raises, as in JAX;
* ``SelfAttention(lora=True)`` at T = 9 on the kernel paths (JAX's
  interpreted Pallas B1/B2, the port's ``FusedAttention`` with its plain
  versions on the CPU): the output and the gradients of the input and of
  every weight, LoRA's among them, float32 within 1e-5 relative (of each
  tensor's largest element);
* dropout, which cannot match JAX's masks: rate 0 and eval mode leave a
  forward unchanged; in train mode each site keeps a share within 6
  binomial standard deviations of 1 - p and scales what it keeps by
  1 / (1 - p), from the generator it is given;
* ``multiclass_metrics`` (the port's rank statistic against JAX's
  scikit-learn): 1e-12, NaN where one class is absent; the ROC and PR
  curves and the average precision against scikit-learn: 1e-12;
* ``weighted_indices``, the few-shot rows and the loaders' files, labels
  and indices: equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.config import default_config as jax_default_config
from headct_foundation_tpu.data import datasets as jax_datasets
from headct_foundation_tpu.models import attention as jax_attention_mod
from headct_foundation_tpu.models import classifier as jax_classifier
from headct_foundation_tpu.ops import attention as jax_attn
from headct_foundation_tpu.utils import metrics as jax_metrics
from headct_foundation_tpu.utils.torch_interop import tree_to_torch
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.data import datasets
from headct_foundation_tpu_torch.models.attention import SelfAttention
from headct_foundation_tpu_torch.models.classifier import AttentionClassifier, LinearClassifier
from headct_foundation_tpu_torch.models.layers import TorchBatchNorm, dropout
from headct_foundation_tpu_torch.models.vit import ViT
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.utils import metrics, plots
from headct_foundation_tpu_torch.utils.torch_interop import state_dict_from_jax

C, H, N, B = 48, 4, 9, 6


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("kind", ["linear", "attentive"])
def test_classifiers_and_batchnorm_match_jax(kind):
    rng = np.random.RandomState(0)
    shape = (B, C) if kind == "linear" else (B, N, C)
    xs = [rng.randn(*shape).astype(np.float32) * 2 + 0.5 for _ in range(4)]
    if kind == "linear":
        jmod, port = jax_classifier.LinearClassifier(C, 2), LinearClassifier(C, 2)
    else:
        jmod = jax_classifier.AttentionClassifier(C, 2, num_heads=H, qkv_bias=True)
        port = AttentionClassifier(C, 2, num_heads=H, qkv_bias=True)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    params, stats = variables["params"], variables["batch_stats"]
    sd = state_dict_from_jax(_np(params), batch_stats=_np(stats))
    assert set(sd) == set(tree_to_torch(_np(params), batch_stats=_np(stats)))  # JAX's names
    port.load_state_dict(sd)
    port.train()
    for x in xs[:3]:  # three train-mode updates of the running statistics
        want, upd = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                               use_running_average=False, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        got = port(torch.from_numpy(x))
        assert _rel(got.detach().numpy(), want) <= 1e-5
    for name, buf in state_dict_from_jax({}, batch_stats=_np(stats)).items():
        np.testing.assert_allclose(port.state_dict()[name].numpy(), buf.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    port.eval()
    want = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(xs[3]))
    assert _rel(port(torch.from_numpy(xs[3])).detach().numpy(), want) <= 1e-5


def test_batchnorm_raises_on_one_value_per_channel():
    bn = TorchBatchNorm(C, eps=1e-6).train()
    with pytest.raises(ValueError, match="more than|>1 value"):
        bn(torch.zeros(1, C))
    jmod = jax_classifier.LinearClassifier(C, 2)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.zeros((2, C)))
    with pytest.raises(ValueError):
        jmod.apply(variables, jnp.zeros((1, C)), use_running_average=False,
                   mutable=["batch_stats"])
    bn.eval()
    assert bn(torch.zeros(1, C)).shape == (1, C)  # eval reads the running statistics


@pytest.fixture
def kernel_paths():
    prev = (jax_attn.set_attention_backend("pallas"), jax_attn.set_pallas_min_t(N),
            port_attn.set_attention_backend("kernel"), port_attn.set_pallas_min_t(N))
    yield
    jax_attn.set_attention_backend(prev[0])
    jax_attn.set_pallas_min_t(prev[1])
    port_attn.set_attention_backend(prev[2])
    port_attn.set_pallas_min_t(prev[3])


def test_lora_attention_forward_and_gradients_match_jax(kernel_paths, monkeypatch):
    """Every weight random (LoRA's B too, which starts at 0), so each path
    carries signal; q and v leave the fused projection as fresh tensors and
    k as a strided view, on both sides through the whole-sequence kernels."""
    from headct_foundation_tpu_torch.ops import flash_attention

    rng = np.random.RandomState(1)
    x = rng.randn(2, N, C).astype(np.float32)
    dy = rng.randn(2, N, C).astype(np.float32)
    jmod = jax_attention_mod.SelfAttention(hidden_size=C, num_heads=H, qkv_bias=True, lora=True)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 0.05),
                          params)

    def f(p, xx):
        return jnp.sum(jmod.apply({"params": p}, xx) * dy)

    y_j = jmod.apply({"params": params}, jnp.asarray(x))
    g_p, g_x = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))

    port = SelfAttention(C, H, qkv_bias=True, lora=True)
    port.load_state_dict(state_dict_from_jax(_np(params)))
    seen = []
    fused = flash_attention.FusedAttention

    class Spy(fused):
        @staticmethod
        def forward(ctx, q, k, v, scale=None):
            seen.append((q.is_contiguous(), k.is_contiguous(), v.is_contiguous()))
            return fused.forward(ctx, q, k, v, scale)

    monkeypatch.setattr(flash_attention, "FusedAttention", Spy)
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt)
    (y * torch.from_numpy(dy)).sum().backward()
    assert seen == [(True, False, True)], seen
    assert _rel(y.detach().numpy(), y_j) <= 1e-5
    assert _rel(xt.grad.numpy(), g_x) <= 1e-5
    want = state_dict_from_jax(_np(g_p))
    assert {n for n, _ in port.named_parameters()} == set(want)
    assert {"lora_q.lora_matrix_A", "lora_q.lora_matrix_B", "lora_v.lora_matrix_A",
            "lora_v.lora_matrix_B"} <= set(want)
    for name, p in port.named_parameters():
        assert _rel(p.grad.numpy(), want[name].numpy()) <= 1e-5, name


def _tiny_vit(rate: float, lora: bool = False) -> ViT:
    return ViT(in_chans=3, img_size=24, patch_size=12, hidden_size=C, mlp_dim=96, num_layers=2,
               num_heads=H, pos_embed="sincos", qkv_bias=True, dropout_rate=rate,
               lora=lora).init_weights(torch.Generator().manual_seed(0))


def test_dropout_at_rate_zero_and_in_eval_changes_nothing():
    x = torch.rand(2, 3, 24, 24, 24, generator=torch.Generator().manual_seed(3))
    zero, half = _tiny_vit(0.0), _tiny_vit(0.5)
    half.load_state_dict(zero.state_dict())
    want = zero.eval()(x)[0]
    assert torch.equal(zero.train()(x)[0], want)  # rate 0: train mode is eval mode
    assert torch.equal(half.eval()(x)[0], want)   # eval: no dropout at any rate
    g = lambda s: torch.Generator().manual_seed(s)
    a, b, c = (half.train()(x, g(s))[0] for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)  # the generator decides the masks
    with pytest.raises(ValueError, match="Generator"):
        half.train()(x)  # no mask from the global RNG


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_a_binomial_share_and_rescales(rate):
    x = torch.full((200, 500), 3.0)
    y = dropout(x, rate, torch.Generator().manual_seed(0))
    kept = y != 0
    n = x.numel()
    sd = (n * rate * (1 - rate)) ** 0.5
    assert abs(kept.sum().item() - n * (1 - rate)) <= 6 * sd
    assert torch.allclose(y[kept], torch.full_like(y[kept], 3.0 / (1 - rate)))


def test_multiclass_metrics_match_jax():
    rng = np.random.RandomState(5)
    for n, k in ((64, 2), (50, 3)):
        logits = np.round(rng.randn(n, k), 1)  # ties
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        targets = rng.randint(0, k, n)
        for t in (targets, np.zeros(n, np.int64)):  # the second: one class only
            got = metrics.multiclass_metrics(t, probs, k)
            want = jax_metrics.multiclass_metrics(t, probs, k)
            assert got.keys() == want.keys()
            for key in want:
                if np.isnan(want[key]):
                    assert np.isnan(got[key]), key
                else:
                    assert abs(got[key] - want[key]) <= 1e-12, (key, got[key], want[key])


def test_curves_match_scikit_learn():
    from sklearn import metrics as skm

    rng = np.random.RandomState(6)
    t, p = rng.randint(0, 2, 80), np.round(rng.rand(80), 1)
    fpr, tpr = plots.roc_curve(t, p)
    want_fpr, want_tpr, _ = skm.roc_curve(t, p, drop_intermediate=False)
    np.testing.assert_allclose(fpr, want_fpr, atol=1e-12)
    np.testing.assert_allclose(tpr, want_tpr, atol=1e-12)
    prec, rec = plots.precision_recall_curve(t, p)
    want_prec, want_rec, _ = skm.precision_recall_curve(t, p)
    np.testing.assert_allclose(prec, want_prec, atol=1e-12)
    np.testing.assert_allclose(rec, want_rec, atol=1e-12)
    assert abs(plots.average_precision(t, p) - skm.average_precision_score(t, p)) <= 1e-12


def test_weighted_indices_match_jax():
    w = np.array([1.0, 5.0, 5.0, 0.5, 2.0, 9.0])
    for seed, epoch, rank in ((42, 0, 0), (42, 3, 1), (7, 1, 2)):
        np.testing.assert_array_equal(datasets.weighted_indices(w, 500, rank, seed, epoch),
                                      jax_datasets.weighted_indices(w, 500, rank, seed, epoch))


def write_label_manifests(tmp_path, n_train: int = 23, seed: int = 0) -> dict:
    """cq500 manifests in the full column order (``img_path`` then its 14
    labels), uneven classes in every column; returns the paths and the train
    labels of each column."""
    rng = np.random.RandomState(seed)
    names = sorted(datasets.CLASS_MAPPINGS["cq500"], key=datasets.CLASS_MAPPINGS["cq500"].get)
    out = {}
    for split, n in (("train", n_train), ("val", 7), ("test", 5)):
        labels = (rng.rand(n, len(names)) < 0.3).astype(int)
        rows = [f"/data/{split}_{i}.nii.gz," + ",".join(map(str, r)) for i, r in enumerate(labels)]
        path = tmp_path / f"{split}.csv"
        path.write_text("img_path," + ",".join(names) + "\n" + "\n".join(rows) + "\n")
        out[split] = (str(path), labels)
    return out


def _configs(tmp_path, manifests, extra=()):
    cfgs = []
    for cfg in (jax_default_config(), default_config()):
        cfg.merge_from_list(["DATA.DATASET", "cq500", "TRAIN.LABEL_NAME", "SDH",
                             "DATA.TRAIN_CSV_PATH", manifests["train"][0],
                             "DATA.VAL_CSV_PATH", manifests["val"][0],
                             "DATA.TEST_CSV_PATH", manifests["test"][0],
                             "DATA.CACHE_DIR", str(tmp_path / "cache"), "DATA.BATCH_SIZE", 4,
                             "MODEL.ROI", [24, 24, 24], *extra])
        cfgs.append(cfg)
    return cfgs


def _files_labels(loader):
    ds = loader.dataset
    return list(ds.files), [int(ds.label_dict[f]) for f in ds.files]


@pytest.mark.parametrize("few_shots", [-1, 3])
def test_label_loaders_match_jax(tmp_path, few_shots):
    """The fine-tune loaders (weighted draws, class weights) and the
    few-shot ones (JAX's pandas groupby sample, by column name; the labels
    by column position) give JAX's files, labels and indices."""
    manifests = write_label_manifests(tmp_path)
    cfg_j, cfg_p = _configs(tmp_path, manifests, ["DATA.FEW_SHOTS", few_shots])
    if few_shots > 0:
        want = jax_datasets.get_fewshots_dataloaders(cfg_j)
        got = datasets.get_fewshots_dataloaders(cfg_p)
    else:
        want = jax_datasets.get_finetune_dataloaders(cfg_j)
        got = datasets.get_finetune_dataloaders(cfg_p)
        np.testing.assert_array_equal(got[3], want[3])
    try:
        for g, w in zip(got[:3], want[:3]):
            assert _files_labels(g) == _files_labels(w)
            for epoch in (0, 1):
                np.testing.assert_array_equal(g.indices_fn(epoch), w.indices_fn(epoch))
        files, labels = _files_labels(got[0])
        if few_shots > 0:
            assert len(files) == 2 * few_shots and sorted(set(labels)) == [0, 1]
        sdh = datasets.CLASS_MAPPINGS["cq500"]["SDH"] - 1
        assert _files_labels(got[2])[1] == list(manifests["test"][1][:, sdh])
    finally:
        for loader in got[:3] + want[:3]:
            loader.close()


def test_remat_applies_the_same_dropout_masks():
    """With ``remat`` the MLP's masks are drawn before the checkpoint, in the
    order the plain forward draws them: the same generator gives the same
    loss and gradients, and the recomputation reuses the masks."""
    x = torch.rand(2, 3, 24, 24, 24, generator=torch.Generator().manual_seed(3))
    out = []
    for remat in (False, True):
        vit = ViT(in_chans=3, img_size=24, patch_size=12, hidden_size=C, mlp_dim=96,
                  num_layers=2, num_heads=H, pos_embed="sincos", qkv_bias=True,
                  dropout_rate=0.3, remat=remat).init_weights(torch.Generator().manual_seed(0))
        loss = vit.train()(x, torch.Generator().manual_seed(5))[0].square().mean()
        loss.backward()
        out.append((loss.item(), {n: p.grad.clone() for n, p in vit.named_parameters()
                                  if p.grad is not None}))
    assert out[0][0] == out[1][0]
    for name, g in out[0][1].items():
        assert torch.equal(g, out[1][1][name]), name
