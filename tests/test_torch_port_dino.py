"""PyTorch port: the DINO modules against the JAX package on the CPU.

Same inputs (numpy from a seed), same weights (the JAX init carried across
with ``state_dict_from_jax``) and the random decisions that ``jax.random``
draws from the JAX functions' keys, handed to the port's ``apply`` halves.
Tolerances:

* the schedules, the teacher temperature and the centre's update from the
  teacher's mean row (what the engines pass): exact; from several rows
  within 1e-6 relative (XLA sums the mean in another order);
* ``dino_loss``: 1e-6 relative;
* AdamW, Lamb and Lion with the per-update weight-decay schedule: 1e-5;
* the head, ``crop_and_resize`` (both modes), ``rand_gaussian_smooth``,
  ``rand_adjust_contrast``, ``mae_augment(reshape=False)`` and
  ``dino_multicrop``: float32 within 1e-5 (elementwise, absolute and
  relative); bfloat16 normwise, ||a - b|| / ||b|| <= 1e-2 (the two
  frameworks sum the resampling products in other orders and round each
  pass to bfloat16).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.config import default_config as jax_default_config
from headct_foundation_tpu.data import augment as jax_aug
from headct_foundation_tpu.models.dino_head import DINOHead as JaxDINOHead
from headct_foundation_tpu.optim import schedules as jax_sched
from headct_foundation_tpu.utils.torch_interop import tree_to_torch
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.data import augment
from headct_foundation_tpu_torch.losses import dino_loss
from headct_foundation_tpu_torch.models.dino_head import DINOHead
from headct_foundation_tpu_torch.optim import schedules
from headct_foundation_tpu_torch.utils.torch_interop import (
    jax_tree_from_state_dict,
    state_dict_from_jax,
)

# the JAX losses package exports the function under the module's name
jax_loss = importlib.import_module("headct_foundation_tpu.losses.dino_loss")
F32_TOL = 1e-5
BF16_REL_L2 = 1e-2
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _close(got: torch.Tensor, want, dtype) -> None:
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    got = got.detach().float()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL, atol=F32_TOL)
    else:
        rel = ((got - want).norm() / want.norm()).item()
        assert rel <= BF16_REL_L2, rel


def _volumes(b: int, r: int = 24, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).rand(b, 3, r, r, r).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_schedules_temperature_and_center_are_exact():
    cfg_j, cfg_p = jax_default_config(), default_config()
    for cfg in (cfg_j, cfg_p):
        cfg.merge_from_list(["TRAIN.MAX_EPOCHS", 7, "TRAIN.WEIGHT_DECAY", 0.04,
                             "TRAIN.WEIGHT_DECAY_END", 0.4, "DINO.MOMENTUM_TEACHER", 0.996])
    for fn in ("get_wd_schedule", "get_momentum_schedule"):
        np.testing.assert_array_equal(getattr(schedules, fn)(cfg_p, 5),
                                      getattr(jax_sched, fn)(cfg_j, 5))
    np.testing.assert_array_equal(schedules.cosine_scheduler(1.0, 0.1, 4, 3, 1, 0.2),
                                  jax_sched.cosine_scheduler(1.0, 0.1, 4, 3, 1, 0.2))
    np.testing.assert_array_equal(dino_loss.teacher_temp_schedule(0.04, 0.07, 3, 10),
                                  jax_loss.teacher_temp_schedule(0.04, 0.07, 3, 10))
    rng = np.random.RandomState(1)
    center, t_out = rng.randn(1, 32).astype(np.float32), rng.randn(6, 32).astype(np.float32)
    # the engines pass the teacher's mean row: the update is exact
    np.testing.assert_array_equal(
        dino_loss.update_center(_t(center), _t(t_out[:1])).numpy(),
        np.asarray(jax_loss.update_center(jnp.asarray(center), jnp.asarray(t_out[:1]))))
    # a mean over rows sums in XLA's order: within one float32 rounding
    np.testing.assert_allclose(
        dino_loss.update_center(_t(center), _t(t_out)).numpy(),
        np.asarray(jax_loss.update_center(jnp.asarray(center), jnp.asarray(t_out))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ncrops", [4, 6])
def test_dino_loss_matches_jax(ncrops):
    rng = np.random.RandomState(2)
    b, k = 3, 64
    student = rng.randn(ncrops * b, k).astype(np.float32)
    teacher = rng.randn(2 * b, k).astype(np.float32)
    center = 0.1 * rng.randn(1, k).astype(np.float32)
    want = float(jax_loss.dino_loss(jnp.asarray(student), jnp.asarray(teacher),
                                    jnp.asarray(center), jnp.asarray(0.04, jnp.float32), ncrops))
    got = dino_loss.dino_loss(_t(student), _t(teacher), _t(center), 0.04, ncrops).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _jax_head(dtype, nlayers=3):
    head = JaxDINOHead(in_dim=48, out_dim=128, nlayers=nlayers, hidden_dim=64, bottleneck_dim=16,
                       dtype=dtype)
    params = head.init(jax.random.PRNGKey(3), jnp.zeros((1, 48), dtype))["params"]
    return head, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("nlayers", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dino_head_matches_jax(dtype, nlayers):
    head_j, params = _jax_head(_JNP[dtype], nlayers)
    head = DINOHead(48, 128, nlayers=nlayers, hidden_dim=64, bottleneck_dim=16, dtype=dtype)
    sd = state_dict_from_jax(params)
    assert set(sd) == set(tree_to_torch(params)) == set(head.state_dict())
    head.load_state_dict(sd)
    x = np.random.RandomState(4).randn(10, 48).astype(np.float32)
    want = head_j.apply({"params": params}, jnp.asarray(x, _JNP[dtype]))
    got = head(_t(x).to(dtype))
    assert got.dtype == dtype and tuple(got.shape) == (10, 128)
    _close(got, want, dtype)
    back = jax_tree_from_state_dict(head.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_dino_head_bn_raises():
    with pytest.raises(NotImplementedError, match="USE_BN"):
        DINOHead(48, 128, use_bn=True)


def _boxes(b: int, inside: bool, integer: bool, seed: int):
    rng = np.random.RandomState(seed)
    if inside:  # boxes within the 24^3 volume, so the content is non-zero
        size = rng.randint(6, 17, (b, 3)) if integer else rng.uniform(6, 16, (b, 3))
        start = np.floor(rng.uniform(0, 24 - size)) if integer else rng.uniform(0, 24 - size)
    else:  # partly outside: those reads are 0
        size = rng.randint(10, 40, (b, 3)) if integer else rng.uniform(10, 40, (b, 3))
        start = np.floor(rng.uniform(-12, 12, (b, 3))) if integer else rng.uniform(-12, 12, (b, 3))
    return start.astype(np.float32), size.astype(np.float32)


@pytest.mark.parametrize("out", [(24, 24, 24), (12, 16, 20)])
@pytest.mark.parametrize("inside", [True, False])
@pytest.mark.parametrize("mode", ["area", "linear"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_crop_and_resize_matches_jax(dtype, mode, inside, out):
    x = _volumes(3)
    start, size = _boxes(3, inside, mode == "area", seed=5)
    want = jax_aug.crop_and_resize(jnp.asarray(x, _JNP[dtype]), jnp.asarray(start),
                                   jnp.asarray(size), out, mode=mode)
    got = augment.crop_and_resize(_t(x).to(dtype), _t(start), _t(size), out, mode=mode)
    assert got.dtype == dtype and tuple(got.shape) == (3, 3) + out
    if inside:
        assert float(jnp.abs(want.astype(jnp.float32)).min()) > 0.0
    _close(got, want, dtype)


def _jax_smooth_decisions(rng, b):
    k_sig, k_do = jax.random.split(rng)
    return (_t(jax.random.uniform(k_sig, (b, 3), minval=0.5, maxval=1.0)),
            _t(jax.random.bernoulli(k_do, 0.2, (b,))))


def _jax_contrast_decisions(rng, b):
    k_g, k_do = jax.random.split(rng)
    shape = (b, 1, 1, 1, 1)
    return (_t(jax.random.uniform(k_g, shape, minval=0.2, maxval=1.0)).reshape(b),
            _t(jax.random.bernoulli(k_do, 0.2, shape)).reshape(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smooth_and_contrast_match_jax(dtype):
    b = 6
    x = _volumes(b, seed=6)
    xj, xp = jnp.asarray(x, _JNP[dtype]), _t(x).to(dtype)
    for seed in (0, 2):  # p = 0.2: both keys turn some samples on and some off
        rng = jax.random.PRNGKey(seed)
        sigma, on = _jax_smooth_decisions(rng, b)
        _close(augment.rand_gaussian_smooth(xp, sigma, on),
               jax_aug.rand_gaussian_smooth(rng, xj, (0.5, 1.0), 0.2), dtype)
        _close(augment.rand_gaussian_smooth(xp, sigma, torch.ones(b, dtype=torch.bool)),
               jax_aug.rand_gaussian_smooth(rng, xj, (0.5, 1.0), 1.0), dtype)
        gamma, on = _jax_contrast_decisions(rng, b)
        _close(augment.rand_adjust_contrast(xp, gamma, on),
               jax_aug.rand_adjust_contrast(rng, xj, (0.2, 1.0), 0.2), dtype)
        _close(augment.rand_adjust_contrast(xp, gamma, torch.ones(b, dtype=torch.bool)),
               jax_aug.rand_adjust_contrast(rng, xj, (0.2, 1.0), 1.0), dtype)


def test_mae_augment_with_smoothing_matches_jax():
    b = 6
    x = _volumes(b, seed=7)
    for seed in (0, 2):
        rng = jax.random.PRNGKey(seed)
        keys = jax.random.split(rng, 5)
        shape = (b, 1, 1, 1, 1)
        k1, k2 = jax.random.split(keys[3])
        sigma, on = _jax_smooth_decisions(keys[4], b)
        decisions = {
            "flip": torch.stack([_t(jax.random.bernoulli(keys[i], 0.1, shape)).reshape(b)
                                 for i in range(3)]),
            "shift": _t(jax.random.uniform(k1, shape, minval=-0.1, maxval=0.1)).reshape(b),
            "shift_on": _t(jax.random.bernoulli(k2, 0.5, shape)).reshape(b),
            "sigma": sigma.t(), "smooth_on": on}
        _close(augment.apply_mae_augment(_t(x), decisions),
               jax_aug.mae_augment(rng, jnp.asarray(x), reshape=False), torch.float32)
    assert augment.mae_augment(_t(x), torch.Generator().manual_seed(0), reshape=False).shape == x.shape


def jax_multicrop_decisions(rng, b: int, volume_size: int, global_crop_size: int,
                            local_crop_size: int, local_crops_number: int, mode: str = "area"):
    """The decisions ``data/augment.py:273 dino_multicrop`` draws from rng,
    in ``draw_dino_multicrop``'s layout (batch first)."""
    integer = mode == "area"
    canvas, local_canvas = jax_aug.CANVAS, jax_aug.LOCAL_CANVAS
    offset = (canvas - volume_size) // 2 if integer else (canvas - volume_size) / 2.0
    keys = jax.random.split(rng, 2 + local_crops_number)
    shape = (b, 1, 1, 1, 1)
    out = []
    for gi in range(2):
        k_box, k_aug, k_extra = jax.random.split(keys[gi], 3)
        start, size = jax_aug._rand_box(k_box, b, global_crop_size, canvas, 0.0, canvas,
                                        integer=integer)
        k4 = jax.random.split(k_aug, 4)
        k1, k2 = jax.random.split(k4[3])
        d = {"start": _t(start - offset), "size": _t(size),
             "flip": torch.stack([_t(jax.random.bernoulli(k4[i], 0.2, shape)).reshape(b)
                                  for i in range(3)], dim=1),
             "shift": _t(jax.random.uniform(k1, shape, minval=-0.2, maxval=0.2)).reshape(b),
             "shift_on": _t(jax.random.bernoulli(k2, 0.5, shape)).reshape(b)}
        if gi == 0:
            d["sigma"], d["smooth_on"] = _jax_smooth_decisions(k_extra, b)
        else:
            d["gamma"], d["contrast_on"] = _jax_contrast_decisions(k_extra, b)
        out.append(d)
    lo = (canvas - local_canvas) // 2 if integer else (canvas - local_canvas) / 2.0
    for li in range(local_crops_number):
        k_box, _ = jax.random.split(keys[2 + li])
        start, size = jax_aug._rand_box(k_box, b, local_crop_size, global_crop_size, lo,
                                        lo + local_canvas, integer=integer)
        out.append({"start": _t(start - offset), "size": _t(size)})
    return out


@pytest.mark.parametrize("mode", ["area", "linear"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dino_multicrop_matches_jax(dtype, mode):
    b = 4
    x = _volumes(b, seed=8)
    rng = jax.random.PRNGKey(9)
    kw = dict(global_crop_size=112, local_crop_size=64, local_crops_number=2, mode=mode)
    want = jax_aug.dino_multicrop(rng, jnp.asarray(x, _JNP[dtype]), final_size=(24, 24, 24),
                                  **kw)
    decisions = jax_multicrop_decisions(rng, b, 24, 112, 64, 2, mode)
    got = augment.apply_dino_multicrop(_t(x).to(dtype), decisions, (24, 24, 24), mode=mode)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == dtype
        _close(g, w, dtype)
    # the port's own draws: integer boxes within the JAX ranges
    drawn = augment.draw_dino_multicrop(64, torch.Generator().manual_seed(0), "cpu", 24, **kw)
    for i, d in enumerate(drawn):
        lo, hi = (112, 224) if i < 2 else (64, 112)
        assert float(d["size"].min()) >= lo and float(d["size"].max()) <= hi
        if mode == "area":
            assert torch.equal(d["size"], d["size"].round())
            assert torch.equal(d["start"], d["start"].round())


@pytest.mark.parametrize("name", ["AdamW", "Lamb", "Lion"])
def test_scheduled_weight_decay_matches_jax(name):
    """4 updates with the weight decay read per update from a schedule
    (the last value past its end), against the JAX chain built with
    ``get_optimizer(weight_decay=<schedule>)``: float32 within 1e-5."""
    import optax

    from headct_foundation_tpu.optim import optimizers as jax_opt
    from headct_foundation_tpu_torch.optim.optimizers import (
        get_optimizer,
        scheduled_weight_decay,
        set_step_hyperparameters,
    )

    cfg_j, cfg_p = jax_default_config(), default_config()
    for cfg in (cfg_j, cfg_p):
        cfg.merge_from_list(["TRAIN.OPTIMIZER", name, "TRAIN.GRAD_CLIP", 0.0])
    wd_sched, lr = np.array([0.04, 0.2, 0.4]), 1e-2
    wd_dev = jnp.asarray(wd_sched, jnp.float32)
    tx = jax_opt.get_optimizer(cfg_j, lr, weight_decay=lambda c: wd_dev[jnp.minimum(c, 2)])
    rng = np.random.RandomState(3)
    p0 = {"w": rng.randn(6, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    params_j = jax.tree.map(jnp.asarray, p0)
    opt_state = tx.init(params_j)
    params = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    opt = get_optimizer(cfg_p, list(params.values()))
    for n in range(4):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, params_j)
        params_j = optax.apply_updates(params_j, updates)
        for k, p in params.items():
            p.grad = _t(grads[k])
        set_step_hyperparameters(opt, lr, scheduled_weight_decay(wd_sched, n))
        opt.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params_j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
