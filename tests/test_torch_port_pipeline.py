"""PyTorch port: ``pipe`` (GPipe, ``parallel/pipeline.py``) and its stacked
checkpoints, on the CPU.

One launch of four gloo processes (``tests/torch_port_mp_worker.py``) runs
every case on a mesh of its own over the four ranks:

* ``pipeline_apply`` on the toy layers of ``tests/test_pipeline.py``
  (tanh(x w + b), L = 4) at (S, M) = (2, 2), (2, 4) (``DATA 2 x PIPE 2``),
  (4, 2), (4, 4) and a padded tail (3 rows, M = 4) at ``PIPE 4``, held with
  its one-process emulation against JAX's ``pipeline_apply`` on the
  8-device CPU mesh and against the plain fold: values and gradients (of x
  and of every layer) within 1e-6;
* the tiny MAE of ``tests/test_pipeline.py:123-147`` at ``DATA 2 x PIPE 2``
  (hu16 wires, 1 channel), from JAX's weights and with the mask noise JAX's
  pipelined step draws: the loss and the unstacked first-step gradients
  against JAX's ``_make_pipelined_loss`` and against one port process, at
  JAX's own limits (loss rtol 1e-6; gradients atol 2e-5, rtol 2e-4), then
  three AdamW steps with ``GRAD_CLIP`` 1.0 against JAX's pipelined train
  step (its trunks in float32, as its state), and one SGD step under an
  active clip and one Lamb step against JAX's optimizer chain on the
  stacked tree: the clip and the trust ratio take each stacked leaf's norm
  over every layer of both stages;
* the checkpoints: the port's ``PIPE`` file restored by JAX's
  ``restore_state`` bit for bit, JAX's ``PIPE`` file restored at ``DATA 2 x
  PIPE 2`` bit for bit, a per-block file refused by a ``PIPE`` state's
  ``restore_state`` and warm-started into it whole;
* DINO and downstream at ``PIPE 4`` (the ``pipe`` ranks replicate the step,
  as JAX's ``pipe`` axis does for them) against one process, bit for bit;
* the refusals of JAX ``tests/test_pipeline.py:291-305``;
* the MAE main under ``torch.distributed.run`` at ``DATA 2 x PIPE 2``.

Limits: JAX's own for the MAE (above); the toy schedule's values within
1e-6 elementwise and its gradients within 1e-6 normwise (``||a - b|| /
||b||``: float32 sums over the batch round at ~1e-6 of their largest
terms, ~4e-6 absolute on gradients of ~10); the SGD and Lamb updates
within JAX's gradient rtol (2e-4) normwise, a qkv bias without its key
third.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from headct_foundation_tpu.config import default_config as jax_default_config
from headct_foundation_tpu.data.device_preprocess import wire_to_compute as jax_wire_to_compute
from headct_foundation_tpu.engines import mae_engine as jax_mae
from headct_foundation_tpu.optim import lr_sched as jax_lr_sched
from headct_foundation_tpu.optim import optimizers as jax_optim
from headct_foundation_tpu.parallel import pipeline as jax_pipeline
from headct_foundation_tpu.parallel.mesh import make_mesh
from headct_foundation_tpu.utils import checkpoint as jax_ckpt
from headct_foundation_tpu_torch.engines import mae_engine
from headct_foundation_tpu_torch.optim.optimizers import without_key_bias
from headct_foundation_tpu_torch.parallel import mesh, pipeline
from headct_foundation_tpu_torch.utils.checkpoint import load_checkpoint, restore_state
from headct_foundation_tpu_torch.utils.torch_interop import (
    jax_tree_from_state_dict,
    load_pretrained_into,
    state_dict_from_jax,
)
from tests import torch_port_mp_worker as worker
from tests.test_torch_port_dino_train import TINY as DINO_TINY
from tests.test_torch_port_dino_train import _jax_draws
from tests.test_torch_port_dino_train import _wires as dino_wires
from tests.test_torch_port_downstream_train import TARGETS
from tests.test_torch_port_downstream_train import TINY as DS_TINY
from tests.test_torch_port_downstream_train import _wires as ds_wires
from tests.test_torch_port_dropout import wires
from tests.test_torch_port_mae import jax_augment_decisions
from tests.test_torch_port_mesh_dino import jax_plain_attention
from tests.test_torch_port_model_parallel import _launch, _numpy

TINY = ["MAE.PATCH_SIZE", 12, "MAE.IN_CHANS", 1, "MAE.ENCODER_DEPTH", 2,
        "MAE.ENCODER_EMBED_DIM", 48, "MAE.ENCODER_MLP_DIM", 96, "MAE.ENCODER_NUM_HEADS", 4,
        "MAE.DECODER_DEPTH", 2, "MAE.DECODER_EMBED_DIM", 36, "MAE.DECODER_MLP_DIM", 72,
        "MAE.DECODER_NUM_HEADS", 4, "MAE.MASK_RATIO", 0.75, "MAE.USE_BIAS", True,
        "DATA.WIRE_FORMAT", "hu16", "TRAIN.GRAD_CLIP", 1.0, "TRAIN.BASE_LR", 1e-3,
        "TRAIN.MIN_LR", 1e-6]
GRID = [24, 24, 24]
PATCHES, BATCH, STEPS = 8, 8, 3
PIPE2 = ["PARALLEL.DATA", 2, "PARALLEL.PIPE", 2]
PIPE4 = ["PARALLEL.DATA", 1, "PARALLEL.PIPE", 4]
TOY_CASES = {"2x2": (2, 2), "2x4": (2, 4), "4x2": (4, 2), "4x4": (4, 4)}
TOY_L, TOY_SHAPE = 4, (16, 6, 16)
ATOL = RTOL = 1e-6  # the toy schedule's values and gradients
G_ATOL, G_RTOL = 2e-5, 2e-4  # JAX's own limits for the pipelined MAE's gradients
# AdamW with JAX's GRAD_CLIP 1.0; an active clip under SGD (scale-invariant
# AdamW hides a clip's coefficient) and Lamb's trust ratio, both per stacked leaf
OPT_CASES = {"adamw": [], "sgd": ["TRAIN.OPTIMIZER", "SGD", "TRAIN.GRAD_CLIP", 1e-3],
             "lamb": ["TRAIN.OPTIMIZER", "Lamb"]}


def _toy(seed: int = 0, shape=TOY_SHAPE):
    rng = np.random.RandomState(seed)
    d = shape[-1]
    return dict(ws=(rng.randn(TOY_L, d, d) * 0.3).astype(np.float32),
                bs=(rng.randn(TOY_L, d) * 0.1).astype(np.float32),
                x=rng.randn(*shape).astype(np.float32), w=rng.randn(*shape).astype(np.float32))


def _jax_toy(toy, pipe: int, micro: int, data: int) -> dict:
    """JAX's ``pipeline_apply`` on the 8-device mesh: output and gradients."""
    jmesh = make_mesh(data=data, pipe=pipe, devices=jax.devices()[:data * pipe])
    layers = {"w": jnp.asarray(toy["ws"]), "b": jnp.asarray(toy["bs"])}
    apply = lambda p, x: jnp.tanh(x @ p["w"] + p["b"])  # noqa: E731

    def loss(layers, x):
        out = jax_pipeline.pipeline_apply(jmesh, layers, x, apply, micro)
        return jnp.sum(out * toy["w"]), out

    (_, out), (gl, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        layers, jnp.asarray(toy["x"]))
    return {"out": np.asarray(out), "gx": np.asarray(gx), "gw": np.asarray(gl["w"]),
            "gb": np.asarray(gl["b"])}


def _fold(toy) -> dict:
    blocks = [worker.Toy(toy["ws"][i], toy["bs"][i]) for i in range(TOY_L)]
    x = torch.as_tensor(toy["x"]).clone().requires_grad_()
    out = pipeline.fold(blocks, x)
    (out * torch.as_tensor(toy["w"])).sum().backward()
    return {"out": out.detach(), "gx": x.grad, "gw": torch.stack([b.w.grad for b in blocks]),
            "gb": torch.stack([b.b.grad for b in blocks])}


def _emulated(toy, pipe: int, micro: int) -> dict:
    blocks = [worker.Toy(toy["ws"][i], toy["bs"][i]) for i in range(TOY_L)]
    x = torch.as_tensor(toy["x"]).clone().requires_grad_()
    out = pipeline.emulate_pipeline(pipeline.split_stages(blocks, pipe), x, micro)
    (out * torch.as_tensor(toy["w"])).sum().backward()
    return {"out": out.detach(), "gx": x.grad, "gw": torch.stack([b.w.grad for b in blocks]),
            "gb": torch.stack([b.b.grad for b in blocks])}


def _jax_config(pipe: int = 2):
    cfg = jax_default_config()
    cfg.merge_from_list(list(TINY))
    cfg.MAE.INPUT_SIZE, cfg.MODEL.ROI = 24, list(GRID)
    cfg.PARALLEL.PIPE = pipe
    return cfg


def _jax_noise(rng, step: int) -> np.ndarray:
    """The mask noise JAX's pipelined step draws at update ``step``: its
    ``encode_prefix`` masks with the micro-batch's ``mask_rng`` itself."""
    micro_rng = jax.random.fold_in(jax.random.fold_in(rng, step), 0)
    mask_rng, _ = jax.random.split(micro_rng)
    return np.asarray(jax.random.uniform(mask_rng, (BATCH, PATCHES)))


def _flat(params_tree) -> dict:
    """A JAX parameter tree of either layout as the port's state dict."""
    return state_dict_from_jax(jax_pipeline.unstack_if_pipelined(_numpy(params_tree)))


def _jax_mae(out, rng, batches):
    """JAX's pipelined MAE at data 2 x pipe 2: the weights, the first step's
    loss and gradients (``_make_pipelined_loss`` in float32), three train
    steps (its trunks in float32) and the state's checkpoint after them."""
    cfg = _jax_config()
    jmesh = make_mesh(data=2, pipe=2, devices=jax.devices()[:4])
    state, _, _ = jax_mae.create_train_state(cfg, jmesh, rng, 50, 0, dtype=jnp.float32)
    init = _flat(state.params)
    loss_fn = jax_mae._make_pipelined_loss(cfg, jmesh, dtype=jnp.float32)
    micro_rng = jax.random.fold_in(jax.random.fold_in(rng, 0), 0)
    mask_rng, _ = jax.random.split(micro_rng)

    def loss(params, wire):
        batch = jax_wire_to_compute(wire, cfg, 1)
        return loss_fn(state.apply_fn, params, batch, mask_rng)

    wire0 = jax_mae._to_device_batch(batches[0], jmesh)
    loss0, grads0 = jax.jit(jax.value_and_grad(loss))(state.params, wire0)
    out_j = dict(cfg=cfg, mesh=jmesh, init=init, loss0=float(loss0), grads0=_flat(grads0),
                 stacked_init=_numpy(state.params))
    state, losses = _jax_steps(cfg, jmesh, state, batches, rng)
    out_j["adamw"] = dict(losses=losses, params=_flat(state.params))
    jax_ckpt.save_checkpoint(state, 0, 1.0, str(out), "jax_pipe.pkl")
    out_j.update(state=state, checkpoint=str(out / "jax_pipe.pkl"))
    return out_j


def _jax_update(opts, stacked_params, grads: dict) -> dict:
    """One update of JAX's optimizer chain (its ``create_train_state``'s:
    the clip, then the optimizer, the sincos embeddings frozen) on the
    stacked tree, from the port's per-block gradients stacked."""
    cfg = _jax_config()
    cfg.merge_from_list(list(opts))
    sched = jax_lr_sched.get_lr_schedule(cfg, cfg.TRAIN.BASE_LR, 0, 50, cfg.TRAIN.MIN_LR)
    mask = jax_mae.mae_trainable_mask(stacked_params, cfg.MAE.POS_EMBED)
    tx = jax_optim.get_optimizer(cfg, sched, grad_clip=cfg.TRAIN.GRAD_CLIP or None,
                                 trainable_mask=mask)
    per_block = jax_pipeline.unstack_if_pipelined(stacked_params)
    zeros = {n: torch.zeros_like(v) for n, v in state_dict_from_jax(per_block).items()}
    tree = jax_tree_from_state_dict({**zeros, **grads})  # the frozen leaves' are 0
    g = jax_pipeline.stack_layer_params(tree, "blocks", 2)
    g = jax_pipeline.stack_layer_params(g, "decoder_blocks", 2)
    updates, _ = tx.update(g, tx.init(stacked_params), stacked_params)
    return _flat(optax.apply_updates(stacked_params, updates))


def _jax_steps(cfg, jmesh, state, batches, rng):
    """JAX's pipelined train step over ``batches``, its trunks in float32
    as its state (the step builds them in bfloat16 by default)."""
    orig = jax_mae._make_pipelined_loss
    with _patched(jax_mae, "_make_pipelined_loss", functools.partial(orig, dtype=jnp.float32)):
        step = jax_mae.make_train_step(jmesh, config=cfg)
    losses = []
    for wire in batches:
        state, m = step(state, jax_mae._to_device_batch(wire, jmesh), rng)
        losses.append(float(m["loss"]))
    return state, losses


@contextlib.contextmanager
def _patched(obj, name, value):
    prev = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's toy pipelines and pipelined MAE; the port's four-rank launch of
    every case and its one-process runs of the MAE (unpipelined), DINO and
    downstream cases."""
    out = tmp_path_factory.mktemp("pipeline")
    rng = jax.random.PRNGKey(7)
    toys = {k: _toy(i) for i, k in enumerate(TOY_CASES)}
    toys["tail"] = _toy(9, (3, 5, 8))
    jax_toys = {k: _jax_toy(toys[k], s, m, 8 // s) for k, (s, m) in TOY_CASES.items()}
    jax_toys["tail"] = _jax_toy(toys["tail"], 4, 4, 1)
    batches = wires(STEPS, BATCH, GRID)
    with jax_plain_attention():
        jx = _jax_mae(out, rng, batches)
        dino_draws = [_jax_draws(jax.random.PRNGKey(1), s, 1, 4) for s in range(2)]
    draws = [{"noise": _jax_noise(rng, s)} for s in range(STEPS)]
    mae = dict(total_steps=50, warmup=0, batches=batches, draws=draws, weights=jx["init"],
               augment=False)
    cases = [dict(name=f"toy{k}", engine="toy", micro=TOY_CASES.get(k, (4, 4))[1],
                  mesh_opts=PIPE2 if TOY_CASES.get(k, (4,))[0] == 2 else PIPE4, **toys[k])
             for k in toys]
    one_step = dict(batches=batches[:1], draws=draws[:1])  # SGD and Lamb: one update each
    cases += [{**mae, **({} if name == "adamw" else one_step), "name": name,
               "mesh_opts": PIPE2, "opts": opts, "checkpoint": name == "adamw"}
              for name, opts in OPT_CASES.items()]
    cases.append({**mae, "name": "jax-resume", "mesh_opts": PIPE2,
                  "batches": batches[:1], "draws": draws[:1], "weights": None,
                  "resume": jx["checkpoint"]})
    one = {name: worker.run_case({**mae, **({} if name == "adamw" else one_step),
                                  "name": f"one-{name}", "opts": opts,
                                  "checkpoint": name == "adamw"}, TINY, str(out), GRID)
           for name, opts in OPT_CASES.items()}
    cases.append({**mae, "name": "warm", "mesh_opts": PIPE2,
                  "batches": batches[:1], "draws": draws[:1], "weights": None,
                  "warm_start": one["adamw"]["checkpoint"]})
    dino = dict(engine="dino", batches=dino_wires(2, 4), draws=dino_draws, weights=None)
    ds_batches = ds_wires(2)
    ds_draws = [{"augment": {k: v.numpy() for k, v in jax_augment_decisions(
        jax.random.fold_in(jax.random.PRNGKey(1), s), len(ds_batches[0])).items()}}
        for s in range(2)]
    downstream = dict(engine="downstream", batches=ds_batches, targets=TARGETS[:2],
                      draws=ds_draws, weights=None)
    with _backend_kernel(), _threads(1):  # as each launched rank (OMP_NUM_THREADS=1)
        one["dino"] = worker.run_dino_case({**dino, "name": "one-dino"}, DINO_TINY, str(out))
        one["downstream"] = worker.run_downstream_case({**downstream, "name": "one-ds"},
                                                       DS_TINY, str(out))
    cases += [{**dino, "name": "dino", "mesh_opts": PIPE4, "opts_base": DINO_TINY},
              {**downstream, "name": "downstream", "mesh_opts": PIPE4, "opts_base": DS_TINY}]
    four = _launch(dict(opts=TINY, cases=cases, grid=GRID), out, 4)
    return dict(toys=toys, jax_toys=jax_toys, jax=jx, four=four, one=one, out=out)


@contextlib.contextmanager
def _threads(n: int):
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@contextlib.contextmanager
def _backend_kernel():
    from headct_foundation_tpu_torch.ops import attention as port_attn

    prev = port_attn.set_attention_backend("kernel")
    try:
        yield
    finally:
        port_attn.set_attention_backend(prev)


def _close(got: dict, want: dict, what: str):
    """Values elementwise within 1e-6; each gradient normwise within 1e-6
    (its float32 sums over the batch round at ~1e-6 of its largest terms)."""
    np.testing.assert_allclose(np.asarray(got["out"]), np.asarray(want["out"]), atol=ATOL,
                               rtol=RTOL, err_msg=f"{what}: out")
    for k in ("gx", "gw", "gb"):
        a, b = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= RTOL, f"{what}: {k} {rel:.3e} apart"


@pytest.mark.parametrize("case", list(TOY_CASES) + ["tail"])
def test_pipeline_apply_matches_jax_and_the_fold(runs, case):
    """The four ranks' schedule and its emulation against JAX's
    ``pipeline_apply`` and the plain fold, values and gradients; the
    no-grad forward equals the graded one."""
    toy = runs["toys"][case]
    s, m = TOY_CASES.get(case, (4, 4))
    got = runs["four"][f"toy{case}"]
    fold = _fold(toy)
    for what, want in (("JAX pipeline_apply", runs["jax_toys"][case]), ("fold", fold)):
        _close(got, want, f"pipeline_apply vs {what}")
        _close(_emulated(toy, s, m), want, f"emulation vs {what}")
    assert torch.equal(got["eval"], got["out"])


def test_stack_and_unstack_match_jax_key_for_key():
    """The port's stack/unstack on a JAX tree equal JAX's, key for key and
    bit for bit; on a state dict they round-trip; ``stack_trunks`` stacks
    every moment tree of an optimizer state."""
    cfg = _jax_config(pipe=1)
    model = jax_mae.build_mae_model(cfg, dtype=jnp.float32)
    rng = jax.random.PRNGKey(3)
    params = _numpy(model.init({"params": rng, "mask": rng},
                               jnp.zeros((1, 1, 24, 24, 24)))["params"])
    want = jax_pipeline.stack_layer_params(dict(params), "blocks", 2)
    want = _numpy(jax_pipeline.stack_layer_params(want, "decoder_blocks", 2))
    got = pipeline.stack_layer_params(pipeline.stack_layer_params(params, "blocks", 2),
                                      "decoder_blocks", 2)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_w.keys() == flat_g.keys()
    for k, v in flat_w.items():
        assert flat_g[k].dtype == v.dtype and np.array_equal(flat_g[k], v), k
    assert pipeline.stack_trunks(params).keys() == got.keys()
    back = pipeline.unstack_trunks({"mu": got})["mu"]
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back),
                                                    jax.tree.leaves(params)))
    sd = state_dict_from_jax(params)
    stacked = pipeline.stack_layer_params(sd, "blocks", 2)
    assert stacked["blocks.attn.qkv.weight"].shape[0] == 2
    assert pipeline.unstack_if_pipelined(stacked).keys() == sd.keys()
    assert all(torch.equal(pipeline.unstack_if_pipelined(stacked)[k], v) for k, v in sd.items())
    # adapt both ways, as JAX's adapt_trunk_layout
    for src, tgt in ((got, params), (params, got)):
        mine = pipeline.adapt_trunk_layout(src, tgt)
        theirs = _numpy(jax_pipeline.adapt_trunk_layout(src, tgt))
        assert set(mine) == set(theirs)
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(mine),
                                                        jax.tree.leaves(theirs)))


def _without_key_bias(sd: dict) -> dict:
    return {n: without_key_bias(n, torch.as_tensor(v)) for n, v in sd.items()}


def test_pipelined_mae_matches_jax_and_one_process(runs):
    """DATA 2 x PIPE 2 from JAX's weights with its mask noise: the first
    loss and the unstacked gradients against JAX's ``_make_pipelined_loss``
    and against one port process, at JAX's limits."""
    got, jx, one = runs["four"]["adamw"], runs["jax"], runs["one"]["adamw"]
    assert got["init"].keys() == jx["init"].keys()
    assert all(torch.equal(got["init"][n], v) for n, v in jx["init"].items())
    np.testing.assert_allclose(got["losses"][0], jx["loss0"], rtol=1e-6)
    np.testing.assert_allclose(got["losses"][0], one["losses"][0], rtol=1e-6)
    assert got["grads"].keys() == one["grads"].keys() <= jx["grads0"].keys()
    for name in got["grads"]:
        g = jx["grads0"][name]
        for what, want in (("JAX", g), ("one process", one["grads"][name])):
            np.testing.assert_allclose(got["grads"][name].numpy(), np.asarray(want),
                                       atol=G_ATOL, rtol=G_RTOL, err_msg=f"{name} vs {what}")


@pytest.mark.parametrize("opt", list(OPT_CASES))
def test_pipelined_mae_steps_match_jax_per_stacked_leaf(runs, opt):
    """The updates of DATA 2 x PIPE 2, whose clip and Lamb trust ratio take
    each block parameter's norm over its stacked leaf (every layer of both
    stages): three AdamW steps with JAX's GRAD_CLIP 1.0 against JAX's
    pipelined train step (the losses and every parameter, a qkv bias
    without its key third, whose gradient is rounding); one SGD step under
    an active clip (1e-3; AdamW is blind to a clip's scale) and one Lamb
    step against JAX's optimizer chain on the stacked tree, fed the port's
    gradients. The one-process run, whose norms are each block's, lands
    apart under SGD and Lamb."""
    got, one, jx = runs["four"][opt], runs["one"][opt], runs["jax"]
    start = _without_key_bias(jx["init"])
    if opt == "adamw":
        np.testing.assert_allclose(got["losses"], jx["adamw"]["losses"], rtol=1e-5)
        want = _without_key_bias(jx["adamw"]["params"])
    else:
        want = _without_key_bias(_jax_update(OPT_CASES[opt], jx["stacked_init"], got["grads"]))
    params = _without_key_bias(got["params"])
    for name, w in want.items():
        np.testing.assert_allclose(params[name].numpy(), w.numpy(), atol=G_ATOL, rtol=G_RTOL,
                                   err_msg=name)
        rel = _rel(params[name] - start[name], w - start[name])
        assert rel <= G_RTOL, f"{name}: update {rel:.3e} apart"
    if opt != "adamw":
        per_block = _without_key_bias(one["params"])
        apart = {n: _rel(per_block[n] - start[n], want[n] - start[n])
                 for n in want if n.startswith(pipeline.TRUNKS)}
        assert max(apart.values()) > 100 * G_RTOL, (
            "the per-block norms should not give the stacked leaf's update", apart)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).double().norm() / b.double().norm().clamp_min(1e-30))


def _find(tree, key):
    """The first subtree under ``key`` of a nested dict."""
    if isinstance(tree, dict):
        if key in tree:
            return tree[key]
        for v in tree.values():
            found = _find(v, key)
            if found is not None:
                return found
    return None


def test_pipe_checkpoints_cross_between_the_packages_bit_for_bit(runs):
    """The port's PIPE checkpoint (stacked params and AdamW moments) fills
    JAX's PIPE state through its ``restore_state`` bit for bit; JAX's PIPE
    checkpoint restores at DATA 2 x PIPE 2 bit for bit."""
    got, jx = runs["four"]["adamw"], runs["jax"]
    payload = jax_ckpt.load_checkpoint(got["checkpoint"])
    assert "blocks" in payload["params"] and "blocks_0" not in payload["params"]
    assert payload["params"]["blocks"]["attn"]["qkv"]["kernel"].shape[0] == 2
    restored, _, _ = jax_ckpt.restore_state(jx["state"], payload)
    params = _flat(restored.params)
    assert params.keys() == got["params"].keys()
    assert all(torch.equal(params[n], v) for n, v in got["params"].items())
    opt = _numpy(serialization.to_state_dict(restored.opt_state))
    for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        tree = _find(opt, field)
        assert tree["blocks"]["attn"]["qkv"]["kernel"].shape[0] == 2
        moments = _flat({k: v for k, v in tree.items() if k.startswith(pipeline.TRUNKS)})
        assert moments and all(torch.equal(v, got["moments"][n][key])
                               for n, v in moments.items())
    resumed = runs["four"]["jax-resume"]
    assert all(torch.equal(resumed["init"][n], v) for n, v in jx["adamw"]["params"].items())
    assert resumed["init"].keys() == jx["adamw"]["params"].keys()


def test_pipe_state_refuses_a_per_block_checkpoint_and_warm_starts_from_it(runs, tmp_path):
    """As JAX's ``restore_state``, a PIPE state raises on a per-block file
    and an unpipelined one on a stacked file; ``load_pretrained_into`` takes
    either layout with every trunk weight (JAX ``tests/test_pipeline.py:253-289``)."""
    one_ckpt = runs["one"]["adamw"]["checkpoint"]
    pipe_ckpt = runs["four"]["adamw"]["checkpoint"]
    warm = runs["four"]["warm"]
    one_init = runs["one"]["adamw"]["params"]
    assert all(torch.equal(warm["init"][n], v) for n, v in one_init.items())
    cfg = worker.config(TINY, GRID)
    state, _ = mae_engine.create_train_state(cfg, 10, 0, seed=4, dtype=torch.float32,
                                             device="cpu")
    with pytest.raises(KeyError, match="layouts differ"):
        restore_state(state, load_checkpoint(pipe_ckpt))
    missing, unexpected = load_pretrained_into(state.model, pipe_ckpt)
    assert not missing and not unexpected
    four = runs["four"]["adamw"]["params"]
    assert all(torch.equal(state.model.state_dict()[n], v) for n, v in four.items())
    cfg.defrost()
    cfg.PARALLEL.PIPE = 2
    state.config = cfg  # a PIPE state's full view reads stacked files only
    with pytest.raises(KeyError, match="layouts differ"):
        restore_state(state, load_checkpoint(one_ckpt))


def test_pipe_refusals_match_jax():
    """JAX ``tests/test_pipeline.py:291-305``: a depth PIPE does not divide
    and dropout raise ValueError; PIPE with fsdp, seq or tensor above 1
    raises when the mesh is laid out."""
    cfg = worker.config(TINY + ["PARALLEL.PIPE", 2, "MAE.DECODER_DEPTH", 3], GRID)
    with pytest.raises(ValueError, match="divide"):
        mae_engine.create_train_state(cfg, 10, 0, device="cpu")
    cfg = worker.config(TINY + ["PARALLEL.PIPE", 2, "MAE.DROPOUT_RATE", 0.1], GRID)
    with pytest.raises(ValueError, match="DROPOUT"):
        mae_engine.create_train_state(cfg, 10, 0, device="cpu")
    for axis in ("fsdp", "seq", "tensor"):
        with pytest.raises(ValueError, match=f"'{axis}'=2"):
            mesh.layout(world=4, pipe=2, **{axis: 2})
    assert mesh.layout(world=8, data=-1, pipe=4) == (2, 1, 1, 4, 1)


@pytest.mark.parametrize("engine", ["dino", "downstream"])
def test_dino_and_downstream_at_pipe_equal_one_process(runs, engine):
    """PIPE 4 (DATA 1): every ``pipe`` rank takes the whole batch and the
    same update, which is one process's bit for bit."""
    got, want = runs["four"][engine], runs["one"][engine]
    assert got["losses"] == want["losses"]
    for key in ("grads", "params"):
        assert got[key].keys() == want[key].keys()
        assert all(torch.equal(got[key][n], v) for n, v in want[key].items()), key


def test_mae_main_under_torchrun_at_data_x_pipe(tmp_path):
    """``main_pretrain_mae`` under ``torch.distributed.run`` at DATA 2 x PIPE 2
    (four gloo processes) trains an epoch and writes the stacked PIPE
    checkpoint; one unpipelined process refuses its full resume, as JAX's
    ``restore_state`` does, and starts from its parameters instead."""
    from headct_foundation_tpu_torch import main_pretrain_mae
    from tests.test_torch_port_cli import _dataset as mae_dataset
    from tests.test_torch_port_mesh_cli import _log, _mesh, _torchrun

    cfg = mae_dataset(tmp_path)
    depth = ["MAE.DECODER_DEPTH", "2"]
    result = _torchrun("headct_foundation_tpu_torch.main_pretrain_mae", 4,
                       ["--cfg", cfg, "--device", "cpu", "--max_epochs", "1", "--opts",
                        *map(str, PIPE2), "DATA.BATCH_SIZE", "2", *depth])
    assert result["world"] == 4 and result["mesh"] == _mesh(data=2, pipe=2)
    assert np.isfinite(result["epochs"][0]["train"]["loss"])
    latest = str(tmp_path / "model_saved" / "latest_debug.pt")
    params = load_checkpoint(latest)["params"]
    assert params["decoder_blocks"]["attn"]["qkv"]["kernel"].shape[0] == 2
    result = main_pretrain_mae.run(["--cfg", cfg, "--device", "cpu", "--model_load_path", latest,
                                    "--max_epochs", "1", "--opts", "DATA.BATCH_SIZE", "4", *depth])
    assert "Full resume failed" in _log(tmp_path) and "layouts differ" in _log(tmp_path)
    assert result["start_epoch"] == 0 and result["mesh"] == _mesh()
