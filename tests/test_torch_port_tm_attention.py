"""PyTorch port: the token-major attention tool (kernels B7, B8) held
against the JAX repository's ``tools/experimental_tm_attention.py``.

On the CPU the port's ``tm_attention_fwd`` / ``tm_attention_bwd`` run their
plain versions; the JAX tool's ``pallas_call``s are interpreted on the CPU.
The JAX tool is imported by path, as ``tools/bench_tm_attention.py`` does.
Its backward's head split needs H*D to be a multiple of 128, so every shape
here has H*D = 128. The CUDA kernels are compared with the plain versions in
tests/test_torch_port_cuda.py, which runs only where there is a GPU.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu_torch.tools import experimental_tm_attention as port_tm

_spec = importlib.util.spec_from_file_location(
    "experimental_tm_attention",
    Path(__file__).resolve().parent.parent / "tools" / "experimental_tm_attention.py")
jax_tm = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_tm)

# float32: the JAX kernel tests' tolerance; bfloat16: one bf16 step
_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2.0 ** -8, 2.0 ** -8)}


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]  # q, k, v, incoming grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 70, 4, 32), (2, 129, 2, 64)])
def test_fused_attention_tm_matches_jax(shape, dtype):
    """Out and the gradients of q, k, v through FusedAttentionTM against
    jax.vjp of the JAX tool's fused_attention_tm; the log-sum-exp [B, H, T]
    against the JAX forward's residual."""
    B, T, H, D = shape
    q, k, v, g = _inputs(shape, seed=T)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    qj, kj, vj, gj = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    o_j, vjp = jax.vjp(lambda q, k, v: jax_tm.fused_attention_tm(q, k, v), qj, kj, vj)
    want = vjp(gj)
    _, (_, _, _, _, lse_j) = jax_tm._tm_fwd_impl(qj, kj, vj, None)

    qt, kt, vt = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    launches = (port_tm.tm_attention_fwd.launches, port_tm.tm_attention_bwd.launches)
    o, lse = port_tm.FusedAttentionTM.apply(qt, kt, vt, None)
    o.backward(torch.from_numpy(g).to(tdt))
    assert (port_tm.tm_attention_fwd.launches, port_tm.tm_attention_bwd.launches) == launches
    assert o.dtype == tdt and o.is_contiguous() and lse.shape == (B, H, T)
    assert not lse.requires_grad
    atol, rtol = _TOL[dtype]
    for name, a, w in (("o", o, o_j), ("dq", qt.grad, want[0]), ("dk", kt.grad, want[1]),
                       ("dv", vt.grad, want[2])):
        assert a.dtype == tdt and a.shape == shape, name
        np.testing.assert_allclose(a.detach().float().numpy(), np.asarray(w, np.float32),
                                   atol=atol, rtol=rtol, err_msg=name)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=1e-4, rtol=1e-4)
    o_fn = port_tm.fused_attention_tm(*(x.detach() for x in (qt, kt, vt)))
    assert torch.equal(o_fn, o.detach())


def test_tm_attention_bwd_reference_matches_jax_kernel():
    """The backward's plain version against the interpreted Pallas backward
    (delta inside) on the JAX forward's own residuals, with a custom scale."""
    shape = (2, 33, 2, 64)
    q, k, v, g = _inputs(shape, seed=5)
    _, res = jax_tm._tm_fwd_impl(*(jnp.asarray(x) for x in (q, k, v)), 0.3)
    want = jax_tm._tm_bwd(0.3, (res, (shape[2], shape[3])), jnp.asarray(g))
    o_j, lse_j = res[3], res[4]
    got = port_tm.tm_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                   torch.from_numpy(np.array(o_j).reshape(shape)),
                                   torch.from_numpy(g), torch.from_numpy(np.array(lse_j)), 0.3)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("bad", ["strided", "length", "lse"])
def test_tm_attention_rejects_what_the_kernels_do_not_take(bad):
    x = torch.zeros(1, 9, 2, 16)
    if bad == "strided":  # a [B, T, 3, H, D] slice is not token-major
        q = torch.zeros(1, 9, 3, 2, 16)[:, :, 0]
        with pytest.raises(ValueError, match="contiguous"):
            port_tm.tm_attention_fwd(q, q, q)
    elif bad == "length":
        q = torch.zeros(1, 1025, 1, 16)
        with pytest.raises(ValueError):
            port_tm.tm_attention_fwd(q, q, q)
    else:
        with pytest.raises(ValueError, match="lse"):
            port_tm.tm_attention_bwd(x, x, x, x, x, torch.zeros(2, 1, 9))
