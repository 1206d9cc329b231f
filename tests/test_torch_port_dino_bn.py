"""PyTorch port: the BatchNorm DINO head (``DINO.USE_BN``) against the JAX
package on the CPU.

* ``DINOHead(use_bn=True)`` against JAX's on the same weights and inputs,
  in train mode (batch statistics, running statistics updated) and eval
  mode (running statistics), float32 within 1e-5 and bfloat16 normwise
  within ``BF16_REL_L2`` (``tests/test_torch_port_dino.py``'s limits); the
  updated running statistics likewise.
* Its names and values are JAX ``tree_to_torch``'s, and go back bit for bit.
* A 3-step float32 DINO trajectory with ``USE_BN`` against the JAX trainer,
  with ``TRAIN.ACCUM_STEPS`` 1 and 2 (the statistics carry from micro-batch
  to micro-batch): the first loss within 1e-4, then the losses and the
  students' and teachers' updates within ``ULP_FACTOR`` times the distance
  JAX's own run moves when its initial weights move one ulp (see there);
  the running variances at rtol 1e-3, atol 1e-5; each network's statistics
  its own (the EMA walks parameters only).
* The eval loss (running statistics) on the JAX run's trained state within
  1e-5 relative.
* Checkpoints cross both ways with both statistics, bit for bit.
* Two gloo processes at batch 2 against one at batch 4 (the head's global
  batch statistics), at the DINO gloo test's limits, the tensors of
  ``dino_engine.bn_rounding_only`` left out.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.engines import dino_engine as jax_engine
from headct_foundation_tpu.engines.mae_engine import _to_device_batch
from headct_foundation_tpu.models.dino_head import DINOHead as JaxDINOHead
from headct_foundation_tpu.parallel.mesh import make_mesh
from headct_foundation_tpu.utils import checkpoint as jax_ckpt
from headct_foundation_tpu.utils.torch_interop import tree_to_torch
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.engines import dino_engine
from headct_foundation_tpu_torch.models.dino_head import DINOHead
from headct_foundation_tpu_torch.optim.optimizers import without_key_bias
from headct_foundation_tpu_torch.utils import checkpoint as ckpt
from headct_foundation_tpu_torch.utils.torch_interop import (
    batch_stats_from_state_dict,
    jax_tree_from_state_dict,
    state_dict_from_jax,
)
from tests.test_torch_port_cli import _free_port
from tests.test_torch_port_dino import BF16_REL_L2, F32_TOL, _JNP, _close, _t
from tests.test_torch_port_dino_cli import _DP_WORKER
from tests.test_torch_port_dino_train import (
    F32,
    MOMENTUM,
    NITER,
    TEMP,
    TINY,
    TOTAL_STEPS,
    WARMUP,
    _assert_trees_equal,
    _configs,
    _jax_draws,
    _kernel_backends,
    _numpy,
    _wires,
    assert_tensor_close,
)
from tests.test_torch_port_dino import jax_multicrop_decisions

ROOT = Path(__file__).resolve().parent.parent
BN = ["DINO.USE_BN", True]
F32_LOSS_REL, EVAL_LOSS_REL = 1e-4, 1e-5
# A train-mode BatchNorm over the few CLS features of a random-init ViT (8
# teacher rows, 16 student rows; half that at ACCUM_STEPS 2) amplifies
# float32 roundings, and AdamW's first steps take the elements of small
# gradient to +-lr: after the first update the JAX trainer's own run moves
# as far when its initial weights move one ulp. Measured on the CPU (the
# port against JAX, and JAX one ulp up against JAX): the loss at step 2
# 5.1e-5 and 2.1e-4 (3 steps), 3.5e-3 and 1.3e-2 (ACCUM_STEPS 2); all
# updates together 1.9e-3 and 1.6e-3, 4.8e-3 and 7.0e-3; the worst tensor
# 2.8e-2 and 2.1e-2, 7.4e-2 and 1.1e-1. So past the first loss (1e-4) the
# port is held within ULP_FACTOR times JAX's own one-ulp distance, the
# tensors of ``dino_engine.bn_rounding_only`` left out.
ULP_FACTOR = 2.0


def _jax_bn_head(dtype):
    head = JaxDINOHead(in_dim=48, out_dim=128, use_bn=True, hidden_dim=64, bottleneck_dim=16,
                       dtype=dtype)
    v = head.init(jax.random.PRNGKey(3), jnp.zeros((2, 48), dtype))
    rng = np.random.RandomState(5)  # away from the init's unit scales and zero biases
    params = jax.tree.map(lambda p: (np.asarray(p) + 0.1 * rng.randn(*p.shape)).astype(
        np.float32), v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    return head, params, stats


def _assert_stats_close(got, want, dtype):
    for name in ("mean", "var"):
        for layer in want:
            _close(torch.from_numpy(np.asarray(got[layer][name])), want[layer][name], dtype)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_dino_head_matches_jax(dtype, train):
    head_j, params, stats = _jax_bn_head(_JNP[dtype])
    head = DINOHead(48, 128, use_bn=True, hidden_dim=64, bottleneck_dim=16, dtype=dtype)
    head.load_state_dict(state_dict_from_jax(params, batch_stats=stats))
    x = np.random.RandomState(4).randn(10, 48).astype(np.float32)
    xj = jnp.asarray(x, _JNP[dtype])
    if not train:  # running statistics that are not the init's
        _, upd = head_j.apply({"params": params, "batch_stats": stats}, xj + 0.5,
                              use_running_average=False, mutable=["batch_stats"])
        stats = jax.tree.map(np.asarray, upd["batch_stats"])
        head.load_state_dict(state_dict_from_jax(params, batch_stats=stats))
    want, upd = head_j.apply({"params": params, "batch_stats": stats}, xj,
                             use_running_average=not train, mutable=["batch_stats"])
    head.train(train)
    got = head(_t(x).to(dtype))
    assert got.dtype == dtype and tuple(got.shape) == (10, 128)
    _close(got, want, dtype)
    got_stats = batch_stats_from_state_dict(head.state_dict())
    _assert_stats_close(got_stats, jax.tree.map(np.asarray, upd["batch_stats"]), dtype)
    if not train:
        jax.tree.map(np.testing.assert_array_equal, got_stats, stats)


def test_bn_head_state_dict_equals_tree_to_torch():
    """The JAX BN head (``tests/test_torch_interop.py:251`` builds one) as a
    state_dict: ``tree_to_torch``'s names and values, and back bit for bit."""
    _, params, stats = _jax_bn_head(jnp.float32)
    want = tree_to_torch(params, batch_stats=stats)
    got = state_dict_from_jax(params, batch_stats=stats)
    head = DINOHead(48, 128, use_bn=True, hidden_dim=64, bottleneck_dim=16)
    assert sorted(got) == sorted(want) == sorted(head.state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    head.load_state_dict(got)
    jax.tree.map(np.testing.assert_array_equal, jax_tree_from_state_dict(head.state_dict()),
                 params)
    jax.tree.map(np.testing.assert_array_equal, batch_stats_from_state_dict(head.state_dict()),
                 stats)


def _one_ulp_up(state_j):
    """The JAX state with every parameter of the student and the teacher
    moved one float32 ulp up."""
    up = lambda t: jax.tree.map(
        lambda p: jnp.asarray(np.nextafter(np.asarray(p), np.float32(np.inf))), t)
    return state_j.replace(params=up(state_j.params), teacher_params=up(state_j.teacher_params))


@pytest.fixture(scope="module")
def bn_runs():
    """``get(extra)``: 3 float32 steps with the BatchNorm head, run once:
    (JAX config, port config, mesh, JAX initial state, {"jax", "ulp"}: the
    JAX run and JAX's run from its initial weights one ulp up, each (state,
    losses), the port's state and losses)."""
    done = {}

    def get(extra=()):
        key = tuple(extra)
        if key not in done:
            cfg_j, cfg_p = _configs(*BN, *extra)
            mesh = make_mesh(data=1, devices=jax.devices()[:1])
            start = jax_engine.create_train_state(cfg_j, mesh, jax.random.PRNGKey(0),
                                                  TOTAL_STEPS, WARMUP, NITER, dtype=F32[0])[0]
            step_j = jax_engine.make_train_step(cfg_j, mesh)
            state = dino_engine.create_train_state(cfg_p, TOTAL_STEPS, WARMUP, NITER, seed=0,
                                                   dtype=torch.float32, device="cpu")
            state.student.load_state_dict(state_dict_from_jax(
                _numpy(start.params), batch_stats={"head": _numpy(start.head_stats)}))
            state.teacher.load_state_dict(state.student.state_dict())
            accum = int(cfg_p.TRAIN.ACCUM_STEPS)
            step = dino_engine.make_train_step(cfg_p)
            rng = jax.random.PRNGKey(1)
            runs = {}
            with _kernel_backends():
                for name, s_j in (("jax", start), ("ulp", _one_ulp_up(start))):
                    s_j, losses_j = jax.tree.map(lambda x: jnp.array(x, copy=True), s_j), []
                    for wire in _wires(3, 4):
                        s_j, m_j = step_j(s_j, _to_device_batch(wire, mesh), rng,
                                          jnp.asarray(MOMENTUM, jnp.float32),
                                          jnp.asarray(TEMP, jnp.float32), jnp.asarray(0.0))
                        losses_j.append(float(m_j["loss"]))
                    runs[name] = (s_j, losses_j)
                losses = []
                for s, wire in enumerate(_wires(3, 4)):
                    state, m = step(state, torch.from_numpy(wire), 0, MOMENTUM, TEMP, False,
                                    draws=_jax_draws(rng, s, accum, 4 // accum))
                    losses.append(m["loss"].item())
            done[key] = (cfg_j, cfg_p, mesh, start, runs, state, losses)
        return done[key]

    return get


def _tensors(state_j) -> dict:
    """A JAX DINO state's student and teacher, with their head statistics,
    as port state_dict entries (``s.`` and ``t.``)."""
    out = {}
    for tag, params, stats in (("s", state_j.params, state_j.head_stats),
                               ("t", state_j.teacher_params, state_j.teacher_head_stats)):
        sd = state_dict_from_jax(_numpy(params), batch_stats={"head": _numpy(stats)})
        out.update({f"{tag}.{k}": v for k, v in sd.items()})
    return out


def _port_tensors(state) -> dict:
    return {f"{tag}.{k}": v for tag, m in (("s", state.student), ("t", state.teacher))
            for k, v in m.state_dict().items()}


def _distance(a: dict, b: dict, init: dict, skip=()) -> tuple:
    """All updates together, ||du_a - du_b|| / ||du_b||, and the worst
    tensor's (ratio, name); du = tensor minus ``init``, a qkv bias without
    its key third, the tensors of ``skip`` left out."""
    num = den = 0.0
    worst = (0.0, "")
    for name, t0 in init.items():
        if name.split(".", 1)[1] in skip:
            continue
        du_a = without_key_bias(name, a[name].float() - t0.float())
        du_b = without_key_bias(name, b[name].float() - t0.float())
        if du_b.norm() > 0:
            worst = max(worst, (((du_a - du_b).norm() / du_b.norm()).item(), name))
            num, den = num + ((du_a - du_b).norm() ** 2).item(), den + (du_b.norm() ** 2).item()
    return (num / den) ** 0.5, worst


@pytest.mark.parametrize("extra", [[], ["TRAIN.ACCUM_STEPS", 2]], ids=["3-steps", "accum-2"])
def test_bn_f32_train_trajectory_matches_jax(bn_runs, extra):
    _, cfg_p, _, start, runs, state, losses = bn_runs(extra)
    (state_j, losses_j), (state_u, losses_u) = runs["jax"], runs["ulp"]
    skip = dino_engine.bn_rounding_only(cfg_p)
    init, want, got = _tensors(start), _tensors(state_j), _port_tensors(state)
    assert set(got) == set(want) == set(init)
    # before any update: the forward and the loss as the MAE's and DINO's steps are held
    np.testing.assert_allclose(losses[0], losses_j[0], rtol=F32_LOSS_REL)
    # then no farther from JAX than ULP_FACTOR times JAX's own run from one ulp up
    off = [abs(a / b - 1) for a, b in zip(losses, losses_j)]
    off_u = [abs(a / b - 1) for a, b in zip(losses_u, losses_j)]
    assert all(o <= max(F32_LOSS_REL, ULP_FACTOR * u) for o, u in zip(off, off_u)), (off, off_u)
    port, port_worst = _distance(got, want, init, skip)
    ulp, ulp_worst = _distance(_tensors(state_u), want, init, skip)
    assert port <= ULP_FACTOR * ulp, (port, ulp)
    assert port_worst[0] <= ULP_FACTOR * ulp_worst[0], (port_worst, ulp_worst)
    for name in got:  # the running variances, unmoved by the rounding-only biases
        if name.endswith("running_var"):
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=name)
    np.testing.assert_allclose(state.center.numpy(), np.asarray(state_j.center), rtol=1e-3,
                               atol=1e-5)
    # each network keeps its own statistics (the EMA walks parameters only), and
    # the BN scales and biases train, the teacher's following by the EMA
    for k in ("head.mlp.1.running_mean", "head.mlp.4.running_var"):
        assert not torch.equal(got[f"s.{k}"], got[f"t.{k}"]), k
        assert not torch.equal(got[f"s.{k}"], init[f"s.{k}"]), k
    for k in ("head.mlp.1.weight", "head.mlp.4.bias"):
        assert not torch.equal(got[f"s.{k}"], init[f"s.{k}"])
        assert not torch.equal(got[f"t.{k}"], init[f"t.{k}"])
    for k in skip:  # left out of the distances, but trained on both sides
        assert not torch.equal(got[f"s.{k}"], init[f"s.{k}"]), k
        assert not torch.equal(want[f"s.{k}"], init[f"s.{k}"]), k


def test_bn_eval_loss_uses_running_statistics(bn_runs):
    """The eval step on the JAX run's trained weights, running statistics
    and centre, carried across: the loss within 1e-5, no statistic moved."""
    cfg_j, cfg_p, mesh, _, runs, _, _ = bn_runs()
    state_j = runs["jax"][0]
    state = dino_engine.create_train_state(cfg_p, TOTAL_STEPS, WARMUP, NITER, seed=3,
                                           dtype=torch.float32, device="cpu")
    trained = _tensors(state_j)
    for tag, model in (("s", state.student), ("t", state.teacher)):
        model.load_state_dict({k[2:]: v for k, v in trained.items() if k.startswith(tag)})
    state.center = torch.from_numpy(np.array(state_j.center))
    wire = _wires(1, 4, seed=12)[0]
    rng = jax.random.PRNGKey(5)
    with _kernel_backends():
        want = float(jax_engine.make_eval_step(cfg_j, mesh)(
            state_j, _to_device_batch(wire, mesh), rng, jnp.asarray(TEMP, jnp.float32))["loss"])
        got = dino_engine.make_eval_step(cfg_p)(
            state, torch.from_numpy(wire), None, TEMP,
            draws=jax_multicrop_decisions(rng, 4, 24, 112, 64, 2))["loss"].item()
    np.testing.assert_allclose(got, want, rtol=EVAL_LOSS_REL)
    for k, v in _port_tensors(state).items():  # eval moves no statistic
        assert torch.equal(v, trained[k]), k


def test_bn_checkpoints_cross_between_the_port_and_jax(bn_runs, tmp_path):
    """A port file restores in JAX ``restore_dino_state`` to the same trees
    and statistics, and a JAX file restores in the port bit for bit."""
    from headct_foundation_tpu.engines.dino_engine import _ckpt_view

    _, cfg_p, _, _, runs, state, _ = bn_runs()
    state_j = runs["jax"][0]
    ckpt.save_checkpoint(state, 1, 0.5, str(tmp_path), "port.ckpt")
    payload = jax_ckpt.load_checkpoint(str(tmp_path / "port.ckpt"))
    assert set(payload["head_stats"]) == {"mlp_bn_0", "mlp_bn_1"}
    restored, epoch, best = jax_ckpt.restore_dino_state(state_j, payload)
    assert (epoch, best, int(restored.step)) == (1, 0.5, 3)
    _assert_trees_equal(_numpy(restored.params),
                        jax_tree_from_state_dict(state.student.state_dict()))
    _assert_trees_equal(_numpy(restored.teacher_params),
                        jax_tree_from_state_dict(state.teacher.state_dict()))
    _assert_trees_equal(_numpy(restored.head_stats),
                        dino_engine.head_stats(state.student.state_dict()))
    _assert_trees_equal(_numpy(restored.teacher_head_stats),
                        dino_engine.head_stats(state.teacher.state_dict()))

    jax_ckpt.save_checkpoint(_ckpt_view(state_j), 1, 0.25, str(tmp_path), "jax.ckpt",
                             extra={"momentum_model_state_dict": state_j.teacher_params,
                                    "center": state_j.center,
                                    "head_stats": state_j.head_stats,
                                    "teacher_head_stats": state_j.teacher_head_stats},
                             fmt="pickle")
    jax_ckpt.wait_for_saves()
    payload = ckpt.load_checkpoint(str(tmp_path / "jax.ckpt"))
    fresh = dino_engine.create_train_state(cfg_p, TOTAL_STEPS, WARMUP, NITER, seed=3,
                                           dtype=torch.float32, device="cpu")
    fresh, epoch, best = ckpt.restore_dino_state(fresh, payload)
    assert (epoch, best, fresh.step) == (1, 0.25, 3)
    trees = fresh.jax_trees(fresh.step)
    for key in ("params", "opt_state", "momentum_model_state_dict", "head_stats",
                "teacher_head_stats"):
        _assert_trees_equal(trees[key], payload[key])
    assert not np.array_equal(payload["head_stats"]["mlp_bn_0"]["mean"],
                              payload["teacher_head_stats"]["mlp_bn_0"]["mean"])


def test_bn_two_gloo_processes_equal_one_at_twice_the_batch(tmp_path):
    """The BN head's statistics are the global batch's: 2 gloo processes at
    batch 2 against 1 process at 4, 2 float32 steps (the first with the last
    layer frozen), students, teachers and their statistics."""
    tiny = list(TINY) + BN
    wires = np.stack(_wires(2, 4))
    np.save(tmp_path / "wires.npy", wires)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _DP_WORKER, json.dumps(tiny), str(tmp_path / "wires.npy"),
             str(tmp_path / f"rank{rank}.npz")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-2000:] for o in outs)

    cfg = default_config()
    cfg.merge_from_list(tiny)
    state = dino_engine.create_train_state(cfg, 20, 0, 5, seed=0, dtype=torch.float32,
                                           device="cpu")
    step = dino_engine.make_train_step(cfg)
    losses = []
    for i, wire in enumerate(wires):
        state, m = step(state, torch.from_numpy(wire), 0, 0.99, 0.04, i == 0)
        losses.append(m["loss"].item())
    want = {"center": state.center.numpy(),
            **{"s." + k: v.numpy() for k, v in state.student.state_dict().items()},
            **{"t." + k: v.numpy() for k, v in state.teacher.state_dict().items()}}
    assert "s.head.mlp.1.running_var" in want and "t.head.mlp.4.running_mean" in want
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    skip = dino_engine.bn_rounding_only(cfg)
    for got in ranks:
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-3)
        for name, value in want.items():
            if name.split(".", 1)[-1] not in skip:
                assert_tensor_close(name, got[name], value)
    for name in ranks[0].files:
        assert np.array_equal(ranks[0][name], ranks[1][name]), name
