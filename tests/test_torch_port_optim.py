"""PyTorch port: the optimizer zoo, the per-parameter gradient clip, the
fused Lion update's plain version and the elementary losses, held against
the JAX package.

On the CPU ``lion_update_leaf`` runs its plain version; the JAX side runs
``ops/lion_kernel.py lion_update_leaf``, whose ``pallas_call`` is
interpreted on the CPU. The CUDA kernel B6 itself is compared with the plain
version in tests/test_torch_port_cuda.py, which runs only where there is a GPU.
Inputs are made with numpy from a seed and handed to both.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from headct_foundation_tpu.losses import basic as jax_losses
from headct_foundation_tpu.ops.lion_kernel import lion_update_leaf as jax_lion_update_leaf
from headct_foundation_tpu.optim import optimizers as jax_opt
from headct_foundation_tpu_torch.config import default_config
from headct_foundation_tpu_torch.losses import basic
from headct_foundation_tpu_torch.ops.lion_kernel import (
    lion_update_leaf,
    lion_update_leaf_reference,
)
from headct_foundation_tpu_torch.optim import optimizers

LR, WD, B1, B2 = 3e-4, 0.05, 0.9, 0.99


def _lion_inputs(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    p, g = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    m = (0.1 * rng.randn(*shape)).astype(np.float32)
    return p, g, m, getattr(torch, dtype), getattr(jnp, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(700,), (3, 5, 7), (1,)])
def test_lion_update_leaf_matches_jax_kernel(shape, dtype):
    """delta (in p's dtype) and m_new (float32) against the interpreted
    Pallas kernel: atol 1e-6 in float32, one bfloat16 step for a bf16 delta."""
    p, g, m, tdt, jdt = _lion_inputs(shape, dtype)
    d_j, m_j = jax_lion_update_leaf(jnp.asarray(p, jdt), jnp.asarray(g, jdt), jnp.asarray(m),
                                    jnp.float32(LR), jnp.float32(WD), B1, B2)
    pt, gt, mt = torch.from_numpy(p).to(tdt), torch.from_numpy(g).to(tdt), torch.from_numpy(m)
    before = lion_update_leaf.launches
    d_t, m_t = lion_update_leaf(pt, gt, mt, LR, WD, B1, B2)
    assert lion_update_leaf.launches == before  # CPU tensors never launch
    assert d_t.dtype == tdt and d_t.shape == shape and m_t.dtype == torch.float32
    d_j, d_t = np.asarray(d_j, np.float32), d_t.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(d_t, d_j, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(d_t, d_j, atol=0, rtol=2.0 ** -8)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=1e-6, rtol=0)


def test_lion_update_leaf_in_place_and_nan():
    """m_out = m takes m_new in place; a NaN gradient gives a NaN delta (sign
    keeps NaN, as jnp.sign does and torch.sign does not)."""
    p, g, m, _, _ = _lion_inputs((9,), "float32", seed=1)
    g[3] = np.nan
    want = lion_update_leaf_reference(*(torch.from_numpy(x) for x in (p, g, m)), LR, WD, B1, B2)
    mt = torch.from_numpy(m.copy())
    delta, m_new = lion_update_leaf(torch.from_numpy(p), torch.from_numpy(g), mt, LR, WD, B1, B2,
                                    m_out=mt)
    assert m_new is mt
    torch.testing.assert_close(delta, want[0], equal_nan=True, atol=0, rtol=0)
    torch.testing.assert_close(mt, want[1], equal_nan=True, atol=0, rtol=0)
    assert torch.isnan(delta[3]) and not torch.isnan(delta[:3]).any()


@pytest.mark.parametrize("bad", ["m_dtype", "p_dtype", "shape", "empty", "stride"])
def test_lion_update_leaf_rejects_what_the_kernel_does_not_take(bad):
    p = g = m = torch.zeros(4, 6)
    err = ValueError
    if bad == "m_dtype":
        m, err = m.bfloat16(), TypeError
    elif bad == "p_dtype":
        p, err = p.double(), TypeError
    elif bad == "shape":
        g = torch.zeros(6, 4)
    elif bad == "empty":
        p = g = m = torch.zeros(0)
    else:
        p = torch.zeros(6, 4).t()
    with pytest.raises(err):
        lion_update_leaf(p, g, m, LR, WD, B1, B2)


def _param_set(seed=2):
    """A few parameters of different scales (one all zero) and their grads."""
    rng = np.random.RandomState(seed)
    shapes = {"w": (6, 5), "b": (5,), "z": (4,), "s": (3, 2, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    params["z"][:] = 0.0
    grads = [{k: (rng.randn(*s) * (5.0 if k == "w" else 0.05)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


def _torch_params(params):
    return {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}


def test_clip_by_per_param_norm_matches_jax():
    """Each gradient on its own: the large one clipped to norm 1, the small
    ones untouched; a frozen parameter's gradient is left alone."""
    _, grads = _param_set()
    want, _ = jax_opt.clip_by_per_param_norm(1.0).update(
        {k: jnp.asarray(v) for k, v in grads[0].items()}, optax.EmptyState())
    ps = _torch_params({k: np.zeros_like(v) for k, v in grads[0].items()})
    frozen = torch.nn.Parameter(torch.zeros(3), requires_grad=False)
    frozen.grad = torch.full((3,), 100.0)
    for k, p in ps.items():
        p.grad = torch.from_numpy(grads[0][k].copy())
    optimizers.clip_by_per_param_norm(list(ps.values()) + [frozen], 1.0)
    for k, p in ps.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert float(ps["w"].grad.norm()) == pytest.approx(1.0, rel=1e-5)
    assert torch.equal(frozen.grad, torch.full((3,), 100.0))


def _run_both(tx, opt, params, grads, lr):
    """Three steps of an optax chain and of a torch optimizer over the same
    parameters and gradients; returns (jax params, torch params) as numpy."""
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(pj)
    for g in grads:
        up, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, pj)
        pj = optax.apply_updates(pj, up)
    for g in grads:
        for k, p in opt.ps.items():
            p.grad = torch.from_numpy(g[k].copy())
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    return ({k: np.asarray(v) for k, v in pj.items()},
            {k: p.detach().numpy() for k, p in opt.ps.items()})


def _with_params(make, params):
    ps = _torch_params(params)
    opt = make(list(ps.values()))
    opt.ps = ps
    return opt


def test_sgd_is_the_optax_trace_chain():
    """torch SGD(momentum, dampening 0, no Nesterov, no decay) is
    optax.trace(momentum) followed by -lr, over 3 steps."""
    params, grads = _param_set()
    tx = optax.chain(optax.trace(decay=0.9, nesterov=False), optax.scale_by_learning_rate(0.1))
    opt = _with_params(lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9, dampening=0.0,
                                                   nesterov=False, weight_decay=0.0), params)
    want, got = _run_both(tx, opt, params, grads, 0.1)
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("quirk", [False, True])
def test_lamb_matches_jax(quirk):
    """Lamb against scale_by_lamb + scale_by_learning_rate over 3 steps,
    including an all-zero parameter (trust ratio 1)."""
    params, grads = _param_set()
    tx = optax.chain(jax_opt.scale_by_lamb(b1=0.9, b2=0.95, eps=1e-6, weight_decay=0.05,
                                           exp_avg_quirk=quirk),
                     optax.scale_by_learning_rate(1e-2))
    opt = _with_params(lambda ps: optimizers.Lamb(ps, betas=(0.9, 0.95), weight_decay=0.05,
                                                  exp_avg_quirk=quirk), params)
    want, got = _run_both(tx, opt, params, grads, 1e-2)
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
        assert not np.array_equal(got[k], params[k]), k


@pytest.mark.parametrize("fused", [False, True])
def test_lion_matches_jax(fused):
    """Lion against scale_by_lion_with_wd over 3 steps, fused (the interpreted
    Pallas kernel against B6's plain version) and unfused; the momentum is
    the state ``exp_avg``."""
    params, grads = _param_set()
    tx = jax_opt.scale_by_lion_with_wd(lr=1e-3, b1=0.9, b2=0.99, weight_decay=0.1,
                                       use_pallas=fused)
    opt = _with_params(lambda ps: optimizers.Lion(ps, betas=(0.9, 0.99), weight_decay=0.1,
                                                  fused=fused), params)
    want, got = _run_both(tx, opt, params, grads, 1e-3)
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert all(set(s) == {"exp_avg"} and s["exp_avg"].dtype == torch.float32
               for s in opt.state.values())


def test_get_optimizer_builds_the_zoo():
    cfg = default_config()
    ps = [torch.nn.Parameter(torch.ones(4)), torch.nn.Parameter(torch.ones(2), False)]
    kinds = {"SGD": torch.optim.SGD, "AdamW": torch.optim.AdamW, "Lamb": optimizers.Lamb,
             "Lion": optimizers.Lion}
    for name, kind in kinds.items():
        cfg.TRAIN.OPTIMIZER = name
        opt = optimizers.get_optimizer(cfg, ps)
        assert type(opt) is kind and opt.param_groups[0]["params"] == ps[:1], name
    cfg.TRAIN.LION_FUSED = True
    cfg.TRAIN.OPTIMIZER = "Lion"
    assert optimizers.get_optimizer(cfg, ps).param_groups[0]["fused"]
    cfg.TRAIN.OPTIMIZER = "Adafactor"
    with pytest.raises(NotImplementedError):
        optimizers.get_optimizer(cfg, ps)


def test_basic_losses_match_jax():
    rng = np.random.RandomState(3)
    x, y = rng.randn(4, 7).astype(np.float32), rng.randn(4, 7).astype(np.float32)
    for name in ("l2_loss", "l1_loss", "kl_divergence"):
        want = getattr(jax_losses, name)(jnp.asarray(x), jnp.asarray(y))
        got = getattr(basic, name)(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, err_msg=name)
