"""PyTorch port: MAE and DINO backbone dropout, held against the JAX
package's steps on the CPU with the same masks on both sides.

The masks are injected: on the JAX side the test (never the JAX package)
patches ``flax.linen.Dropout.__call__`` to apply a numpy mask keyed by the
module's scope path (``patch_embedding/dropout``,
``blocks_0/attn/Dropout_0``, ``blocks_0/mlp/Dropout_1``, ...); on the port's,
``models/layers.py set_mask_hook`` hands the same mask to the site of the
same name (``blocks.0.mlp:1``). A mask is a function of its path and shape
(``_mask``), so the JAX step, compiled once, and the port, which asks at
every call, apply the same masks at every step. DINO's teacher and student
share their paths; there the mask is also keyed by the parity of the
path's use (the teacher's backbone runs first in each micro-batch on both
sides), so the two networks drop different elements.

The tiny configurations are the float32 ones of ``tests/test_torch_port_train.py``
(MAE: 24^3, patch 12, width 48, 2 + 2 blocks) and
``tests/test_torch_port_dino_train.py`` (DINO), at dropout 0.25. Limits, those
of the float32 train tests: the loss within 1e-3 relative (MAE) or 1e-4
(DINO), each gradient within rtol 1e-3 / atol 5e-4 (``test_torch_port_mae.py``'s
gradient check), each parameter after the AdamW updates within rtol 1e-3 /
atol 1e-5 (the DINO test's ``assert_tensor_close``).
"""

import contextlib
import zlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.config import default_config as jax_default_config
from headct_foundation_tpu.data.augment import mae_augment
from headct_foundation_tpu.data.device_preprocess import wire_to_compute as jax_wire_to_compute
from headct_foundation_tpu.engines import dino_engine as jax_dino
from headct_foundation_tpu.engines import mae_engine as jax_mae
from headct_foundation_tpu.ops import attention as jax_attn
from headct_foundation_tpu.parallel.mesh import make_mesh
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.data.transforms import hu16_encode
from headct_foundation_tpu_torch.engines import dino_engine, mae_engine
from headct_foundation_tpu_torch.models import layers
from headct_foundation_tpu_torch.models.mae import MaskedAutoencoderViT
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.utils.torch_interop import state_dict_from_jax
from tests.test_torch_port_dino_train import (
    TINY as DINO_TINY,
    _jax_draws as dino_jax_draws,
    assert_tensor_close,
)
from tests.test_torch_port_mae import jax_augment_decisions
from tests.test_torch_port_train import TINY as MAE_TINY

RATE = 0.25
GRAD_RTOL, GRAD_ATOL = 1e-3, 5e-4
MAE_LOSS_REL, DINO_LOSS_REL = 1e-3, 1e-4


def _numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _mask(path: str, shape, rate: float = RATE) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(f"{path}{tuple(shape)}".encode()))
    return rng.random(shape) >= rate


def jax_path(site: str) -> str:
    """A port dropout site (``blocks.0.mlp:1``) as the JAX scope path."""
    module, index = site.rsplit(":", 1)
    parts = module.split(".")
    out = []
    for p in parts:
        if p.isdigit():
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    leaf = "dropout" if parts[-1] == "patch_embedding" else f"Dropout_{index}"
    return "/".join(out + [leaf])


@contextlib.contextmanager
def injected_masks(paired: bool = False):
    """Both sides drop out with ``_mask(path)``; ``paired`` keys the mask by
    the parity of the path's use as well (DINO's teacher, then student).
    Yields the port's list of (site, shape) uses."""
    counts_j, counts_p, uses = {}, {}, []

    def key(path, counts):
        if not paired:
            return path
        k = counts.get(path, 0)
        counts[path] = k + 1
        return f"{path}#{k % 2}"

    original = fnn.Dropout.__call__

    def jax_call(self, inputs, deterministic=None, rng=None):
        if self.rate == 0.0 or deterministic or self.deterministic:
            return inputs
        keep = _mask(key("/".join(self.scope.path), counts_j), inputs.shape, self.rate)
        return jnp.where(keep, inputs / (1.0 - self.rate), jnp.zeros((), inputs.dtype))

    def port_hook(site, shape):
        uses.append((site, tuple(shape)))
        return torch.from_numpy(_mask(key(jax_path(site), counts_p), shape))

    fnn.Dropout.__call__ = jax_call
    prev = layers.set_mask_hook(port_hook)
    try:
        yield uses
    finally:
        fnn.Dropout.__call__ = original
        layers.set_mask_hook(prev)


@contextlib.contextmanager
def kernel_backends():
    prev = (jax_attn.set_attention_backend("pallas"), jax_attn.set_pallas_min_t(None),
            port_attn.set_attention_backend("kernel"), port_attn.set_pallas_min_t(None))
    try:
        yield
    finally:
        jax_attn.set_attention_backend(prev[0])
        jax_attn.set_pallas_min_t(prev[1])
        port_attn.set_attention_backend(prev[2])
        port_attn.set_pallas_min_t(prev[3])


def wires(k: int, batch: int, shape=(24, 24, 24), seed: int = 11) -> list:
    rng = np.random.RandomState(seed)
    return [hu16_encode(rng.uniform(-1000, 1500, (batch, 1) + tuple(shape))) for _ in range(k)]


def jax_mae_draws(model, rng, step: int, n: int, patches: int) -> list:
    """The mask noise and augmentation decisions the JAX MAE step draws for
    update ``step`` (``engines/mae_engine.py:252-259``), one micro-batch."""
    micro_rng = jax.random.fold_in(jax.random.fold_in(rng, step), 0)
    mask_rng, _ = jax.random.split(micro_rng)
    key = model.apply({}, rngs={"mask": mask_rng}, method=lambda m: m.make_rng("mask"))
    return [{"noise": torch.tensor(np.asarray(jax.random.uniform(key, (n, patches)))),
             "augment": jax_augment_decisions(jax.random.fold_in(micro_rng, 7), n)}]


def jax_mae_grads(state_j, cfg_j, mesh, wire, rng, step: int):
    """(loss, gradients) of the JAX MAE step's micro-batch 0 at update
    ``step`` (its ``_micro_loss``, ``:252-272``), under ``mesh``."""
    in_chans = int(cfg_j.MAE.IN_CHANS)

    def loss_fn(params, batch):
        with jax_attn.attention_mesh(mesh):
            batch = jax_wire_to_compute(batch, cfg_j, in_chans)
            micro_rng = jax.random.fold_in(jax.random.fold_in(rng, step), 0)
            mask_rng, drop_rng = jax.random.split(micro_rng)
            batch = mae_augment(jax.random.fold_in(micro_rng, 7), batch)
            loss, _, _ = state_j.apply_fn({"params": params}, batch, deterministic=False,
                                          rngs={"mask": mask_rng, "dropout": drop_rng})
            return loss

    batch = jax_mae._to_device_batch(wire, mesh)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state_j.params, batch)
    return float(loss), state_dict_from_jax(_numpy(grads))


def _mae_configs(*extra):
    cfg_j, cfg_p = jax_default_config(), default_config()
    opts = list(MAE_TINY) + ["MAE.DROPOUT_RATE", RATE] + list(extra)
    cfg_j.merge_from_list(opts)
    cfg_p.merge_from_list(opts)
    return cfg_j, cfg_p


def _params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("extra", [pytest.param([], id="plain"),
                                   pytest.param(["PARALLEL.REMAT", True], id="remat")])
def test_mae_step_with_injected_masks_matches_jax(extra):
    """Two AdamW updates (warm-up 0) of the MAE step at dropout 0.25 against
    JAX ``make_train_step``: the first step's loss and gradients, then the
    parameters after both updates; with REMAT the port replays the masks in
    the MLP's recomputation."""
    cfg_j, cfg_p = _mae_configs(*extra)
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    rng = jax.random.PRNGKey(0)
    with kernel_backends(), injected_masks() as uses:
        state_j, _, _ = jax_mae.create_train_state(cfg_j, mesh, rng, 20, 0, dtype=jnp.float32)
        jax_model = jax_mae.build_mae_model(cfg_j, dtype=jnp.float32)
        step_j = jax_mae.make_train_step(mesh, augment=True, config=cfg_j)
        state, _ = mae_engine.create_train_state(cfg_p, 20, 0, seed=0, dtype=torch.float32,
                                                 device="cpu")
        state.model.load_state_dict(state_dict_from_jax(_numpy(state_j.params)))
        grads_fn = mae_engine.make_grad_step(augment=True, config=cfg_p)
        for s, wire in enumerate(wires(2, 4)):
            draws = jax_mae_draws(jax_model, rng, s, 4, 8)
            if s == 0:
                loss_j, grads_j = jax_mae_grads(state_j, cfg_j, mesh, wire, rng, s)
            loss = grads_fn(state, torch.from_numpy(wire), 0, draws).item()
            if s == 0:
                assert abs(loss - loss_j) <= MAE_LOSS_REL * abs(loss_j), (loss, loss_j)
                for name, p in state.model.named_parameters():
                    if p.grad is not None:
                        np.testing.assert_allclose(p.grad.numpy(), grads_j[name].numpy(),
                                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
            mae_engine.apply_update(state)
            state_j, m_j = step_j(state_j, jax_mae._to_device_batch(wire, mesh), rng)
            assert abs(loss - float(m_j["loss"])) <= MAE_LOSS_REL * abs(float(m_j["loss"]))
    # every site of the model took its mask: patch embedding + 3 per block
    assert {site for site, _ in uses} == {"patch_embedding:0"} | {
        f"{trunk}.{i}.{m}" for trunk in ("blocks", "decoder_blocks") for i in range(2)
        for m in ("attn:0", "mlp:0", "mlp:1")}
    want = state_dict_from_jax(_numpy(state_j.params))
    for name, p in state.model.state_dict().items():
        assert_tensor_close(name, p.numpy(), want[name].numpy(), "MAE")


def test_dino_step_with_injected_masks_matches_jax():
    """Two DINO updates at backbone dropout 0.25, the teacher and the student
    each with their own masks, against the JAX DINO step."""
    cfg_j, cfg_p = jax_default_config(), default_config()
    opts = list(DINO_TINY) + ["VIT.DROPOUT_RATE", RATE]
    cfg_j.merge_from_list(opts)
    cfg_p.merge_from_list(opts)
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    rng = jax.random.PRNGKey(1)
    with kernel_backends(), injected_masks(paired=True) as uses:
        state_j = jax_dino.create_train_state(cfg_j, mesh, jax.random.PRNGKey(0), 20, 0, 5,
                                              dtype=jnp.float32)[0]
        step_j = jax_dino.make_train_step(cfg_j, mesh)
        state = dino_engine.create_train_state(cfg_p, 20, 0, 5, seed=0, dtype=torch.float32,
                                               device="cpu")
        state.student.load_state_dict(state_dict_from_jax(_numpy(state_j.params)))
        state.teacher.load_state_dict(state_dict_from_jax(_numpy(state_j.teacher_params)))
        step = dino_engine.make_train_step(cfg_p)
        for s, wire in enumerate(wires(2, 4)):
            state_j, m_j = step_j(state_j, jax_mae._to_device_batch(wire, mesh), rng,
                                  jnp.asarray(0.99, jnp.float32), jnp.asarray(0.04, jnp.float32),
                                  jnp.asarray(0.0))
            state, m = step(state, torch.from_numpy(wire), 0, 0.99, 0.04, False,
                            draws=dino_jax_draws(rng, s, 1, 4))
            np.testing.assert_allclose(m["loss"].item(), float(m_j["loss"]), rtol=DINO_LOSS_REL)
    # per micro-batch: the teacher's 2 x 4 crops, then the student's 4 x 4
    first = [shape for site, shape in uses if site == "patch_embedding:0"]
    assert first[:2] == [(8, 8, 48), (16, 8, 48)]
    for model, tree in ((state.student, state_j.params), (state.teacher, state_j.teacher_params)):
        want = state_dict_from_jax(_numpy(tree))
        for name, p in model.state_dict().items():
            assert_tensor_close(name, p.numpy(), want[name].numpy(), "DINO")


def _tiny_mae(rate: float, **kw) -> MaskedAutoencoderViT:
    return MaskedAutoencoderViT(
        input_size=24, patch_size=12, mask_ratio=0.75, in_chans=3, dropout_rate=rate,
        pos_embed="sincos", encoder_depth=2, encoder_embed_dim=48, encoder_mlp_dim=96,
        encoder_num_heads=4, decoder_depth=1, decoder_embed_dim=48, decoder_mlp_dim=96,
        decoder_num_heads=4, use_bias=True, **kw).init_weights(torch.Generator().manual_seed(0))


def test_rate_zero_and_eval_draw_nothing():
    """Rate 0 in train mode and rate 0.25 in eval mode draw no mask and give
    the rate-0 model's loss and gradients bit for bit."""
    x = torch.rand(2, 3, 24, 24, 24, generator=torch.Generator().manual_seed(3))
    noise = torch.rand(2, 8, generator=torch.Generator().manual_seed(4))
    calls = []
    prev = layers.set_mask_hook(lambda site, shape: calls.append(site))
    try:
        out = []
        for rate, train in ((0.0, True), (RATE, False)):
            model = _tiny_mae(rate).train(train)
            loss = model(x, noise=noise, dropout_generator=torch.Generator().manual_seed(5))[0]
            loss.backward()
            out.append((loss, {n: p.grad for n, p in model.named_parameters()
                               if p.grad is not None}))
    finally:
        layers.set_mask_hook(prev)
    assert calls == []
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(g, out[1][1][n]) for n, g in out[0][1].items())


def test_mae_remat_replays_the_masks():
    """With ``remat`` the MLP's masks are drawn before the checkpoint, in the
    plain forward's order: one generator seed gives the same loss and
    gradients with and without it."""
    x = torch.rand(2, 3, 24, 24, 24, generator=torch.Generator().manual_seed(3))
    noise = torch.rand(2, 8, generator=torch.Generator().manual_seed(4))
    out = []
    for remat in (False, True):
        model = _tiny_mae(0.3, remat=remat).train()
        loss = model(x, noise=noise, dropout_generator=torch.Generator().manual_seed(5))[0]
        loss.backward()
        out.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                                  if p.grad is not None}))
    assert out[0][0] == out[1][0]
    for name, g in out[0][1].items():
        assert torch.equal(g, out[1][1][name]), name


def test_mae_step_dropout_is_seeded_and_apart_from_the_masking():
    """The MAE step's dropout: two runs from one seed are bit-identical, a
    rate-0.25 step differs from the rate-0 step, and the masking noise is
    the same with dropout on or off (its generator is drawn apart)."""
    wire = torch.from_numpy(wires(1, 2)[0])
    noises, losses = [], []
    for rate in (RATE, RATE, 0.0):
        _, cfg = _mae_configs("MAE.DROPOUT_RATE", rate)
        state, _ = mae_engine.create_train_state(cfg, 20, 0, seed=0, dtype=torch.float32,
                                                 device="cpu")
        seen = []
        forward = state.model.forward
        state.model.forward = lambda x, noise=None, **kw: (seen.append(noise),
                                                           forward(x, noise, **kw))[1]
        state, m = mae_engine.make_train_step(augment=True, config=cfg)(state, wire, seed=7)
        noises.append(seen[0])
        losses.append(m["loss"].item())
    assert losses[0] == losses[1] != losses[2]
    assert torch.equal(noises[0], noises[2])


def test_teacher_and_student_draw_different_masks(monkeypatch):
    """A DINO step at rate 0.25 draws the teacher's and the student's masks
    from generators of their own: at each site the student's first crops
    are not masked as the teacher's are; a second run is bit-identical."""
    cfg = default_config()
    cfg.merge_from_list(list(DINO_TINY) + ["VIT.DROPOUT_RATE", RATE])
    drawn = []
    keep_mask = layers.keep_mask

    def record(shape, *args, **kw):
        m = keep_mask(shape, *args, **kw)
        drawn.append((kw.get("site", args[3] if len(args) > 3 else None), m))
        return m

    monkeypatch.setattr(layers, "keep_mask", record)
    losses = []
    for _ in range(2):
        drawn.clear()
        state = dino_engine.create_train_state(cfg, 20, 0, 5, seed=0, dtype=torch.float32,
                                               device="cpu")
        state, m = dino_engine.make_train_step(cfg)(state, torch.from_numpy(wires(1, 2)[0]),
                                                    3, 0.99, 0.04, False)
        losses.append(m["loss"].item())
    assert losses[0] == losses[1]
    by_site = {}
    for site, m in drawn:
        by_site.setdefault(site, []).append(m)
    assert by_site and all(len(v) == 2 for v in by_site.values())
    for site, (teacher, student) in by_site.items():
        assert not torch.equal(teacher, student[:teacher.shape[0]]), site
