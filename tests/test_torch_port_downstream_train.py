"""PyTorch port: the downstream train and eval steps and the downstream
checkpoint, against the JAX package on the CPU.

The tiny configuration of the JAX oracle tests (24^3, patch 12, width 48,
2 blocks, 4 heads, sincos position embeddings, 3 channels, hu16 wire
batches of 4, AdamW with GRAD_CLIP 1.0) with ``PALLAS_MIN_T`` 9, so both
sides take their whole-sequence attention at T = 9 (8 patches and CLS): the
interpreted Pallas kernels in JAX, ``FusedAttention`` (its plain versions
on the CPU) in the port. Both start from the JAX init carried across with
``state_dict_from_jax`` and the port is handed the augmentation decisions
that the JAX step draws from its keys; dropout is at rate 0 (the shipped
configs'). Limits:

* float32, {linear, attentive} x {fine-tune, lock, lora}, 3 steps: the loss
  within 1e-5 relative at every step (measured: at most 4.0e-6); each
  tensor's update normwise, ||du - du_jax|| / ||du_jax||, within 2e-3
  (measured: at most 9.8e-4, LoRA's A, whose gradient is 0 at the first
  step while B is 0), the BatchNorm statistics' change too (measured
  9.6e-5), and under lock the statistics of the BatchNorm the frozen
  backbone alone feeds (``bn``, ``bn1``) within 1e-6 (measured 2.4e-7);
  exactly the JAX
  set of moved tensors, every other one bit-identical (the sincos position
  embeddings always, the backbone under lock, all but LoRA's, the biases,
  the norms and the patch bias under lora). Left out of the update
  comparison, as tensors whose gradient is 0 but for rounding, which AdamW
  scales up to +-lr: the key third of a qkv bias (softmax is invariant to a
  shift of a query row's scores), the attentive head's ``wkv`` bias (the
  same for its key half; ``bn2`` takes out the value half's constant) and
  the backbone's final norm (the classifier's BatchNorm is invariant to a
  per-channel scale and shift of its input; the scale reaches the loss
  through the BatchNorm's eps only), and with the ``wkv`` bias ``bn2``'s
  running mean, which tracks it. A limit of 1e-4 of each tensor's largest
  element is not met: AdamW's moments
  amplify the frameworks' summation orders in elements of small gradient
  (measured: 2.8e-3 in the patch kernel, 5.4e-2 in LoRA's A). Inputs are
  volumes of different HU ranges: on noise volumes of one range the CLS
  features of the 4 samples nearly coincide, the BatchNorm over them
  amplifies float32 roundings, and JAX's own loss differed by 1.5e-5
  between two compilations of the same step (lock and fine-tune). The
  batch is 8 and the LR the shipped cq500 config's 1.5e-4 (the classifier
  at 100 x);
* bfloat16, the same six cases on both sides (bf16 compute on float32
  parameters), held against JAX's bf16 run and JAX's float32 run (below);
* the eval step on the port's trained weights and statistics: loss and
  probabilities within 1e-5;
* checkpoints: a ``best_`` file the port writes reads in JAX with the
  tree of JAX's own state (params, batch_stats, the multi_transform
  opt_state) and the port's values bit for bit, and restores in JAX
  ``restore_state``; a file JAX's trainer writes restores in the port bit
  for bit.

The bf16 step does not meet the DINO step test's limit on the updates
(``tests/test_torch_port_dino_train.py``: 0.05 of all updates together
against JAX's bf16 run), and the JAX package's own bf16
run is as far from its float32 run: the BatchNorm over 8 CLS features and
the classifier's 100 x LR carry bf16 roundings into AdamW's moments, which
the two frameworks take at other points (XLA rounds a Dense's product
before its bias add and normalises P before P.V in the head's attention;
torch rounds once and divides after). Measured on the CPU (all updates
normwise; the loss at its worst step): the port's bf16 against JAX's bf16
0.025-0.058 and loss 4.4e-3-1.2e-2; JAX's bf16 against JAX's float32
0.019-0.041 and loss up to 9.1e-3; the port's bf16 against JAX's float32
0.021-0.048 and loss up to 1.1e-2. Held:

* against JAX's bf16 run, each case: the loss within 2e-2 relative at every
  step (the DINO step test's limit); all updates together within twice JAX's own bf16
  distance from its float32 run (the triangle bound of two runs each that
  far from the float32 one);
* no farther from JAX's float32 run than JAX's own bf16 run, times 1.5,
  over the six cases together (root mean square over cases and steps for
  the loss, over cases for the updates): one case's three steps are too
  few a sample (the attentive cases alone measure 1.53 x on the updates,
  the linear 0.88 x; over the six 1.25 x, the loss 1.35 x).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from headct_foundation_tpu.config import default_config as jax_default_config
from headct_foundation_tpu.engines import downstream_engine as jax_engine
from headct_foundation_tpu.engines.mae_engine import _to_device_batch
from headct_foundation_tpu.ops import attention as jax_attn
from headct_foundation_tpu.parallel.mesh import make_mesh
from headct_foundation_tpu.utils import checkpoint as jax_ckpt
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.data.transforms import hu16_encode
from headct_foundation_tpu_torch.engines import downstream_engine
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.optim.optimizers import without_key_bias
from headct_foundation_tpu_torch.utils import checkpoint as ckpt
from headct_foundation_tpu_torch.utils.torch_interop import (
    downstream_opt_state_to_jax,
    downstream_params_to_jax,
    downstream_state_dicts_from_jax,
)
from tests.test_torch_port_mae import jax_augment_decisions

TINY = ["MODEL.ROI", [24, 24, 24], "MODEL.IN_CHANS", 3, "VIT.INPUT_SIZE", 24,
        "VIT.PATCH_SIZE", 12, "VIT.IN_CHANS", 3, "VIT.HIDDEN_SIZE", 48, "VIT.MLP_DIM", 96,
        "VIT.NUM_LAYERS", 2, "VIT.NUM_HEADS", 4, "VIT.USE_BIAS", True, "VIT.POS_EMBED", "sincos",
        "TRAIN.OPTIMIZER", "AdamW", "TRAIN.BASE_LR", 1.5e-4, "TRAIN.WEIGHT_DECAY", 0.01,
        "TRAIN.GRAD_CLIP", 1.0, "TRAIN.SCHEDULER", "cosine", "DATA.WIRE_FORMAT", "hu16",
        "PARALLEL.PALLAS_MIN_T", 9]
TOTAL_STEPS, WARMUP, STEPS, BATCH = 20, 1, 3, 8
F32 = (jnp.float32, torch.float32)
BF16 = (jnp.bfloat16, torch.bfloat16)
MODES = {"fine-tune": [], "lock": ["TRAIN.LOCK", True], "lora": ["TRAIN.LORA", True]}
LOSS_REL, UPDATE_REL, STATS_ATOL = 1e-5, 2e-3, 1e-6
BF16_LOSS_REL, BF16_UPDATE_VS_JAX, BF16_NO_WORSE_THAN_JAX = 2e-2, 2.0, 1.5
CASES = [(kind, mode) for kind in ("linear", "attentive") for mode in MODES]
# gradients 0 but for rounding (see above): held as moved or not, not compared
NOISE_ONLY = downstream_engine.ROUNDING_ONLY


def _configs(kind: str, mode: str):
    extra = ["TRAIN.CLASSIFIER", kind] + MODES[mode]
    cfg_j, cfg_p = jax_default_config(), default_config()
    cfg_j.merge_from_list(TINY + extra)
    cfg_p.merge_from_list(TINY + extra)
    return cfg_j, cfg_p


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _wires(k: int, seed: int = 11) -> list:
    """hu16 batches whose volumes differ in their HU range, sample to sample."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(k):
        lo = rng.uniform(-1000, 200, (BATCH, 1, 1, 1, 1))
        out.append(hu16_encode(lo + rng.uniform(0, 1, (BATCH, 1, 24, 24, 24))
                               * rng.uniform(100, 1500, (BATCH, 1, 1, 1, 1))))
    return out


TARGETS = [np.random.RandomState(s).permutation(BATCH) % 2 for s in range(STEPS)]


def _kernel_backends():
    prev = (jax_attn.set_attention_backend("pallas"), jax_attn.set_pallas_min_t(None),
            port_attn.set_attention_backend("kernel"), port_attn.set_pallas_min_t(None))

    def restore():
        jax_attn.set_attention_backend(prev[0])
        jax_attn.set_pallas_min_t(prev[1])
        port_attn.set_attention_backend(prev[2])
        port_attn.set_pallas_min_t(prev[3])

    return restore


def _port_state(cfg_p, state_j, dtype):
    state = downstream_engine.create_train_state(cfg_p, TOTAL_STEPS, WARMUP, seed=3,
                                                 dtype=dtype, device="cpu")
    model_sd, clf_sd = downstream_state_dicts_from_jax(_np(state_j.params),
                                                       _np(state_j.batch_stats))
    state.model.load_state_dict(model_sd)
    state.classifier.load_state_dict(clf_sd)
    return state


def _flat(model_sd, clf_sd) -> dict:
    return {**{f"model.{k}": v for k, v in model_sd.items()},
            **{f"classifier.{k}": v for k, v in clf_sd.items()}}


def _port_flat(state) -> dict:
    return _flat(*(
        {k: v.detach().clone() for k, v in m.state_dict().items()}
        for m in (state.model, state.classifier)))


def _jax_flat(state_j) -> dict:
    return _flat(*downstream_state_dicts_from_jax(_np(state_j.params), _np(state_j.batch_stats)))


def _trajectory(kind: str, mode: str, dtype):
    """3 steps on both sides from the JAX init; returns (configs, JAX states
    before and after, the port's before and after, both losses)."""
    restore = _kernel_backends()
    try:
        cfg_j, cfg_p = _configs(kind, mode)
        mesh = make_mesh(data=1, devices=jax.devices()[:1])
        state_j = jax_engine.create_train_state(cfg_j, mesh, jax.random.PRNGKey(0), TOTAL_STEPS,
                                                WARMUP, dtype=dtype[0])[0]
        state = _port_state(cfg_p, state_j, dtype[1])
        init_j, init = _jax_flat(state_j), _port_flat(state)
        step_j = jax_engine.make_train_step(cfg_j, mesh, compute_dtype=dtype[0])
        step = downstream_engine.make_train_step(cfg_p, compute_dtype=dtype[1])
        rng = jax.random.PRNGKey(1)
        losses_j, losses = [], []
        for s, (wire, tgt) in enumerate(zip(_wires(STEPS), TARGETS)):
            draws = {"augment": jax_augment_decisions(jax.random.fold_in(rng, s), BATCH)}
            state_j, m_j = step_j(state_j, _to_device_batch(wire, mesh),
                                  jax_engine._to_device(tgt, mesh, np.int32), rng)
            state, m = step(state, torch.from_numpy(wire), torch.from_numpy(tgt), 0, draws=draws)
            losses_j.append(float(m_j["loss"]))
            losses.append(m["loss"].item())
        assert state.step == STEPS == int(state_j.step)
        return (cfg_j, cfg_p, mesh), (init_j, state_j), (init, state), losses_j, losses
    finally:
        restore()


@pytest.fixture(scope="module")
def runs():
    done = {}

    def get(kind="linear", mode="fine-tune", dtype=F32):
        key = (kind, mode, dtype)
        if key not in done:
            done[key] = _trajectory(kind, mode, dtype)
        return done[key]

    return get


def _moved(after: dict, before: dict) -> set:
    return {k for k in before if not torch.equal(after[k], before[k])}


def test_f64_train_steps_run_in_float64_on_the_plain_attention(runs, monkeypatch):
    """The float64 reference mode (``tools/check_data_parallel.py --float64``)
    from the same JAX init, the attentive head fine-tuned for 3 steps: every
    loss within LOSS_REL of the port's float32 steps and of JAX's; every
    parameter, AdamW moment and BatchNorm statistic float64 after them; and
    under the kernel backend at T = 9 >= PALLAS_MIN_T the attention is the
    plain one, dispatched so (no kernel entry is reached)."""
    losses32 = runs("attentive", "fine-tune")[4]
    reached = []
    kernel = port_attn._fa.flash_attention
    monkeypatch.setattr(port_attn._fa, "flash_attention",
                        lambda *a, **k: reached.append(a[0].dtype) or kernel(*a, **k))
    _, _, (_, state), losses_j, losses = _trajectory("attentive", "fine-tune",
                                                     (jnp.float32, torch.float64))
    assert reached == []
    np.testing.assert_allclose(losses, losses32, rtol=LOSS_REL)
    np.testing.assert_allclose(losses, losses_j, rtol=LOSS_REL)
    assert losses != losses32  # computed apart, not the float32 run again
    moments = [v for opt in state.optimizers.values() if opt is not None
               for st in opt.state.values() for k, v in st.items() if k != "step"]
    tensors = [*state.model.state_dict().values(), *state.classifier.state_dict().values(),
               *moments]
    assert moments and all(t.dtype == torch.float64 for t in tensors if t.is_floating_point())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["linear", "attentive"])
def test_f32_train_steps_match_jax(runs, kind, mode):
    _, (init_j, state_j), (init, state), losses_j, losses = runs(kind, mode)
    assert init.keys() == init_j.keys()
    assert all(torch.equal(init[k], init_j[k]) for k in init)
    np.testing.assert_allclose(losses, losses_j, rtol=LOSS_REL)
    after, after_j = _port_flat(state), _jax_flat(state_j)
    assert after.keys() == after_j.keys()
    moved, moved_j = _moved(after, init), _moved(after_j, init_j)
    assert moved == moved_j, sorted(moved ^ moved_j)
    for name in after:
        if name in NOISE_ONLY or name not in moved:
            continue
        if name.startswith(("classifier.bn.", "classifier.bn1.")) and mode == "lock":
            # fed by the frozen backbone alone
            np.testing.assert_allclose(after[name], after_j[name], rtol=0, atol=STATS_ATOL,
                                       err_msg=name)
        u = without_key_bias(name, after[name] - init[name])
        u_j = without_key_bias(name, after_j[name] - init_j[name])
        assert (u - u_j).norm() <= UPDATE_REL * u_j.norm(), name
    frozen = set(after) - moved
    assert "model.patch_embedding.position_embeddings" in frozen
    backbone = {k for k in after if k.startswith("model.")}
    classifier = set(after) - backbone
    assert classifier <= moved  # the head trains in every mode, its statistics move
    if mode == "lock":
        assert backbone <= frozen
    elif mode == "lora":
        assert moved & backbone <= {k for k in backbone
                                    if any(s in k for s in ("lora", "bias", "norm"))}
        assert "model.blocks.0.mlp.linear1.weight" in frozen
        assert "model.patch_embedding.patch_embeddings.weight" in frozen  # "embedding", not "-s"
        assert "model.patch_embedding.patch_embeddings.bias" in moved
        assert "model.blocks.1.attn.lora_v.lora_matrix_B" in moved
    else:
        assert backbone - frozen == backbone - {"model.patch_embedding.position_embeddings"}


def test_eval_step_matches_jax(runs):
    """On the port's trained weights and BatchNorm statistics, carried into
    the JAX state."""
    (cfg_j, cfg_p, mesh), (_, state_j), (_, state), *_ = runs("attentive", "lora")
    params, stats = downstream_params_to_jax(state.model.state_dict(),
                                             state.classifier.state_dict())
    state_j = jax.tree.map(jnp.copy, state_j).replace(
        params=jax.tree.map(jnp.asarray, params), batch_stats=jax.tree.map(jnp.asarray, stats))
    restore = _kernel_backends()
    try:
        wire, tgt = _wires(1, seed=12)[0], TARGETS[0]
        want = jax_engine.make_eval_step(cfg_j, mesh, compute_dtype=jnp.float32)(
            state_j, _to_device_batch(wire, mesh), jax_engine._to_device(tgt, mesh, np.int32))
        got = downstream_engine.make_eval_step(cfg_p, compute_dtype=torch.float32)(
            state, torch.from_numpy(wire), torch.from_numpy(tgt))
    finally:
        restore()
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), rtol=1e-5,
                               atol=1e-6)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _keys(tree, prefix=""):
    """Every path of a nested dict, empty dicts (masked leaves) included."""
    out = {prefix}
    for k, v in tree.items():
        out |= _keys(v, f"{prefix}/{k}") if isinstance(v, dict) else {f"{prefix}/{k}"}
    return out


def _assert_trees_equal(got, want):
    assert _keys(got) == _keys(want), sorted(_keys(got) ^ _keys(want))[:5]
    got, want = dict(_leaves(got)), dict(_leaves(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _port_trees(state) -> dict:
    params, stats = downstream_params_to_jax(state.model.state_dict(),
                                             state.classifier.state_dict())
    return {"params": params, "batch_stats": stats,
            "opt_state": downstream_opt_state_to_jax(state.optimizers, state.model,
                                                     state.classifier, state.config, state.step)}


@pytest.mark.parametrize("kind,mode", [("linear", "lock"), ("attentive", "lora")])
def test_checkpoints_cross_between_the_port_and_jax(runs, tmp_path, kind, mode):
    (cfg_j, cfg_p, mesh), (_, state_j), (_, state), *_ = runs(kind, mode)
    path = ckpt.save_checkpoint(state, 2, 0.75, str(tmp_path), "best_port.ckpt",
                                async_save=True)
    ckpt.wait_for_saves()
    payload = jax_ckpt.load_checkpoint(path)
    mine = _port_trees(state)
    want_tree = {"params": _np(state_j.params), "batch_stats": _np(state_j.batch_stats),
                 "opt_state": serialization.to_state_dict(_np(state_j.opt_state))}
    for key in mine:
        assert _keys(payload[key]) == _keys(want_tree[key]), key  # JAX's own tree
        _assert_trees_equal(payload[key], mine[key])
    restored, epoch, best = jax_ckpt.restore_state(jax.tree.map(jnp.copy, state_j), payload)
    assert (epoch, best, int(restored.step)) == (2, 0.75, STEPS)
    _assert_trees_equal(_np(restored.params), mine["params"])
    _assert_trees_equal(_np(restored.batch_stats), mine["batch_stats"])

    # the other way: the JAX trainer's file, restored into a fresh port state
    jax_ckpt.save_checkpoint(state_j, 1, 0.5, str(tmp_path), "best_jax.ckpt",
                             extra={"batch_stats": state_j.batch_stats}, fmt="pickle")
    jax_ckpt.wait_for_saves()
    payload = ckpt.load_checkpoint(str(tmp_path / "best_jax.ckpt"))
    fresh = downstream_engine.create_train_state(cfg_p, TOTAL_STEPS, WARMUP, seed=5,
                                                 dtype=torch.float32, device="cpu")
    fresh, epoch, best = ckpt.restore_downstream_state(fresh, payload)
    assert (epoch, best, fresh.step) == (1, 0.5, STEPS)
    got = _port_trees(fresh)
    for key in got:
        _assert_trees_equal(got[key], payload[key])


def test_opt_state_tree_without_the_clip_matches_jax():
    """GRAD_CLIP 0: each branch is the optimizer's chain itself, not nested
    in ``chain(clip_by_global_norm, ...)``; the tree JAX builds, key for key."""
    cfg_j, cfg_p = _configs("attentive", "lora")
    cfg_j.merge_from_list(["TRAIN.GRAD_CLIP", 0.0])
    cfg_p.merge_from_list(["TRAIN.GRAD_CLIP", 0.0])
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    state_j = jax_engine.create_train_state(cfg_j, mesh, jax.random.PRNGKey(0), TOTAL_STEPS,
                                            WARMUP, dtype=jnp.float32)[0]
    state = downstream_engine.create_train_state(cfg_p, TOTAL_STEPS, WARMUP, seed=0,
                                                 dtype=torch.float32, device="cpu")
    want = serialization.to_state_dict(_np(state_j.opt_state))
    got = _port_trees(state)["opt_state"]
    assert _keys(got) == _keys(want)
    assert set(got["inner_states"]["model"]["inner_state"]) == {"0", "1", "2"}


def test_async_checkpoint_holds_the_state_at_the_save(tmp_path, monkeypatch):
    """An async save of a downstream state whose write runs after the next
    updates: the file holds the parameters, statistics and optimizer counts
    of the update it was called at."""
    late = []
    monkeypatch.setattr(ckpt._SAVER, "submit", late.append)  # the writer, held back
    cfg = default_config()
    cfg.merge_from_list(TINY + ["TRAIN.LORA", True])
    state = downstream_engine.create_train_state(cfg, TOTAL_STEPS, WARMUP, seed=0,
                                                 dtype=torch.float32, device="cpu")
    step = downstream_engine.make_train_step(cfg, compute_dtype=torch.float32)
    wire, target = torch.from_numpy(_wires(1)[0]), torch.from_numpy(TARGETS[0])
    state, _ = step(state, wire, target, 0)
    at_save = jax.tree.map(np.array, _port_trees(state))  # copies: CPU leaves alias the state
    path = ckpt.save_checkpoint(state, 0, 0.5, str(tmp_path), "best_x.ckpt", async_save=True)
    for _ in range(2):
        state, _ = step(state, wire, target, 0)
    late.pop()()
    payload = ckpt.load_checkpoint(path)
    assert payload["step"] == 1
    for key in at_save:
        _assert_trees_equal(payload[key], at_save[key])
    fresh = downstream_engine.create_train_state(cfg, TOTAL_STEPS, WARMUP, seed=1,
                                                 dtype=torch.float32, device="cpu")
    fresh, _, _ = ckpt.restore_downstream_state(fresh, payload)
    assert fresh.step == 1


def _update_distance(a: dict, b: dict, ref: dict, init: dict) -> float:
    """||du_a - du_b|| / ||du_ref|| over every trained tensor together."""
    num = den = 0.0
    for name, p0 in init.items():
        if name.endswith(("running_mean", "running_var")) or name in NOISE_ONLY:
            continue
        du = {k: without_key_bias(name, t[name].float() - p0.float())
              for k, t in (("a", a), ("b", b), ("ref", ref))}
        num += ((du["a"] - du["b"]).norm() ** 2).item()
        den += (du["ref"].norm() ** 2).item()
    return (num / den) ** 0.5



@pytest.fixture(scope="module")
def readings(runs):
    """Per case: the three runs' losses and the updates' distances."""
    out = {}
    for kind, mode in CASES:
        _, (_, j32), _, losses_j32, _ = runs(kind, mode)
        _, (_, j16), (init, p16), losses_j16, losses16 = runs(kind, mode, BF16)
        assert all(p.dtype == torch.float32 for p in p16.model.parameters())  # bf16 compute
        w = {"p16": _port_flat(p16), "j16": _jax_flat(j16), "j32": _jax_flat(j32)}
        out[(kind, mode)] = {
            "losses": (np.array(losses16), np.array(losses_j16), np.array(losses_j32)),
            "port_vs_jax16": _update_distance(w["p16"], w["j16"], w["j16"], init),
            "port_vs_f32": _update_distance(w["p16"], w["j32"], w["j32"], init),
            "jax16_vs_f32": _update_distance(w["j16"], w["j32"], w["j32"], init)}
    return out


@pytest.mark.parametrize("kind,mode", CASES)
def test_bf16_train_steps_match_jax_bf16(readings, kind, mode):
    r = readings[(kind, mode)]
    p16, j16, _ = r["losses"]
    np.testing.assert_allclose(p16, j16, rtol=BF16_LOSS_REL)
    assert r["port_vs_jax16"] <= BF16_UPDATE_VS_JAX * r["jax16_vs_f32"], r


def test_bf16_is_no_farther_from_float32_than_jax_bf16(readings):
    rms = lambda xs: float(np.sqrt(np.mean(np.square(np.concatenate(xs)))))
    loss_port = rms([r["losses"][0] / r["losses"][2] - 1 for r in readings.values()])
    loss_jax = rms([r["losses"][1] / r["losses"][2] - 1 for r in readings.values()])
    assert loss_port <= BF16_NO_WORSE_THAN_JAX * loss_jax, (loss_port, loss_jax)
    upd_port = rms([[r["port_vs_f32"]] for r in readings.values()])
    upd_jax = rms([[r["jax16_vs_f32"]] for r in readings.values()])
    assert upd_port <= BF16_NO_WORSE_THAN_JAX * upd_jax, (upd_port, upd_jax)
