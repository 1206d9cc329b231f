"""PyTorch port: the measuring tools (``bench.py``, ``tools/{bench_dino,
bench_downstream,bench_longcontext,perf_breakdown,op_profile,bench_attention,
sweep_attention}.py``) on the CPU at the oracle tests' tiny width (24^3,
patch 12, width 48; ``tests/test_parity_oracle.py:35``).

* ``bench.compute_only`` times the MAE CLI's own step object
  (``main_pretrain_mae.make_train_step``, spied on), and its chained loss
  equals the same steps called one by one from a fresh seed state, bit for
  bit on the CPU; its line has the root ``bench.py``'s keys and ``device``.
* ``with_loader`` on a tiny packed cache: ``input_wait_frac`` in [0, 1], no
  placeholder.
* ``perf_breakdown``'s variants' first losses on weights carried from the
  JAX MAE (``state_dict_from_jax``) and the mask noise ``jax.random`` draws
  match the JAX model's ``apply`` (``full``, ``fwd_bwd``, ``fwd``) and
  ``forward_encoder`` (``encoder_fwd_bwd``) on the same numpy input within
  1e-5 relative in float32. One JAX model per module (``jax_mae``).
* ``op_profile``'s parser on a CPU profile of one tiny MAE step: shares
  summing to 100% within 0.1, the top entries traced to frames in the
  port's package; on hand-built CUDA-shaped events, a kernel hung from its
  runtime launch, its op and frame, and a backward kernel traced to its
  forward op's frame by sequence number.
* ``sweep_attention``'s paths agree with the plain path on O, dQ, dK, dV
  (float32 elementwise within the kernels' limits, bfloat16 normwise
  1e-2); on the CPU each path is its wrapper's plain version.
"""

import inspect
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headct_foundation_tpu.models.mae import MaskedAutoencoderViT as JaxMAE
from headct_foundation_tpu_torch import bench, main_pretrain_mae
from headct_foundation_tpu_torch.engines import mae_engine
from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor
from headct_foundation_tpu_torch.ops import attention as port_attn
from headct_foundation_tpu_torch.ops import flash_attention as fa
from headct_foundation_tpu_torch.tools import (
    bench_attention,
    bench_dino,
    bench_downstream,
    bench_longcontext,
    op_profile,
    perf_breakdown,
    sweep_attention,
)
from headct_foundation_tpu_torch.utils.torch_interop import state_dict_from_jax

TINY_MAE = ["MODEL.ROI", [24, 24, 24], "MAE.INPUT_SIZE", 24, "MAE.PATCH_SIZE", 12,
            "MAE.ENCODER_DEPTH", 2, "MAE.ENCODER_EMBED_DIM", 48, "MAE.ENCODER_MLP_DIM", 96,
            "MAE.ENCODER_NUM_HEADS", 4, "MAE.DECODER_DEPTH", 2, "MAE.DECODER_EMBED_DIM", 48,
            "MAE.DECODER_MLP_DIM", 96, "MAE.DECODER_NUM_HEADS", 4]
JAX_TINY = dict(input_size=24, patch_size=12, mask_ratio=0.75, in_chans=3, pos_embed="sincos",
                encoder_depth=2, encoder_embed_dim=48, encoder_mlp_dim=96, encoder_num_heads=4,
                decoder_depth=2, decoder_embed_dim=48, decoder_mlp_dim=96, decoder_num_heads=4,
                use_bias=True)
TINY_VIT = ["MODEL.ROI", [24, 24, 24], "VIT.INPUT_SIZE", 24, "VIT.HIDDEN_SIZE", 48,
            "VIT.MLP_DIM", 96, "VIT.NUM_LAYERS", 2, "VIT.NUM_HEADS", 4]
TINY_DINO = TINY_VIT + ["DINO.HEAD_HIDDEN_DIM", 32, "DINO.BOTTLENECK_DIM", 16,
                        "DINO.HEAD_N_PROTOTYPES", 64]
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "wire_format", "device"}
LOSS_REL = 1e-5


def tiny_cfg():
    return bench.flagship_config(TINY_MAE)


def test_compute_only_times_the_cli_step(monkeypatch):
    made = []
    real = main_pretrain_mae.make_train_step

    def spy(config):
        made.append(config)
        return real(config)

    monkeypatch.setattr(main_pretrain_mae, "make_train_step", spy)
    cfg = tiny_cfg()
    r = bench.compute_only(cfg, "cpu", batch=2, steps=3, runs=1, check_chain=True)
    assert made == [cfg]  # the CLI's own step, built once
    assert BENCH_KEYS <= set(r) and r["device"]["name"] == "cpu"
    assert r["unit"] == "volumes/s/CPU" and r["vs_baseline"] is None  # no GPU number on the CPU
    assert r["wire_format"] == "hu16" and r["value"] > 0 and math.isfinite(r["final_loss"])
    assert r["timed_steps"] == 3 and not any(r["launches"].values())
    json.dumps(r)
    # the chained steps against the same steps one by one, from a fresh seed state
    state = bench.cli_state(cfg, torch.device("cpu"))
    step = real(cfg)
    wire = torch.from_numpy(bench.wire_batch(cfg, 2))
    for _ in range(3):
        state, m = step(state, wire, bench.SEED)
        float(m["loss"])
    assert r["chain_check"]["chained_loss"] == float(m["loss"]) == r["chain_check"]["single_loss"]
    # the CLI's main takes its step from the same function
    assert "make_train_step(config)" in inspect.getsource(main_pretrain_mae.main)


def test_with_loader_on_a_packed_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("HEADCT_NATIVE", "0")  # every volume is a packed hit; no decoder build
    r = bench.with_loader(tiny_cfg(), "cpu", batch=2, epochs=2, steps_per_epoch=2,
                          host_epochs=1, workdir=str(tmp_path))
    assert 0.0 <= r["input_wait_frac"] <= 1.0 and r["placeholders"] == 0
    assert r["packed_cache"] and r["timed_steps"] == 2 and math.isfinite(r["final_loss"])
    assert set(r["host_loader_vols_per_s_by_workers"]) == {"4", "16", "16_uncapped"}
    assert r["host_loader_effective_workers"]["16_uncapped"] == 16
    assert r["h2d_MB_per_s"] is None  # no host-to-device copy on the CPU
    assert r["wire_MB_per_vol"] == pytest.approx(24 ** 3 * 2 / 1e6)
    assert not list(tmp_path.iterdir())  # the cache is removed
    with pytest.raises(ValueError, match="warm_epochs"):
        bench.with_loader(tiny_cfg(), "cpu", epochs=1, workdir=str(tmp_path))


def test_feature_latency_splits_the_stages(tmp_path):
    fe = FeatureExtractor(img_size=24, hidden_size=48, mlp_dim=96, num_layers=2, num_heads=4,
                          device="cpu")
    r = bench.feature_latency("cpu", n_scans=2, chain=2, runs=1, workdir=str(tmp_path),
                              extractor=fe)
    parts = r["decomposition_ms"]
    assert set(parts) == {"decode", "h2d", "device", "dispatch_fetch"}
    assert r["value"] > 0 and all(math.isfinite(v) for v in parts.values())
    assert r["unit"] == "ms" and r["device"]["name"] == "cpu"
    # the split preprocessor is the whole one
    path = bench.synth_scans(str(tmp_path), 1, shape=(40, 36, 20))[0]
    prep = fe.preprocessor
    torch.testing.assert_close(prep.transform(*prep.ship(*prep.decode(path))), prep(path),
                               rtol=0, atol=0)


@pytest.fixture(scope="module")
def jax_mae():
    """The tiny JAX MAE, its parameters perturbed by a seeded numpy draw, an
    input, the mask key and the noise it draws, and JAX's losses."""
    model = JaxMAE(**JAX_TINY)
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                                 jnp.zeros((1, 3, 24, 24, 24)))["params"]
    rs = np.random.RandomState(3)
    params = jax.tree.map(lambda p: (np.asarray(p) + 0.05 * rs.randn(*p.shape)).astype(np.float32),
                          params)
    x = np.random.RandomState(5).rand(2, 3, 24, 24, 24).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    loss = float(model.apply({"params": params}, jnp.asarray(x), deterministic=True,
                             mask_rng=rng)[0])
    latent = model.apply({"params": params}, jnp.asarray(x), rng, True,
                         method=JaxMAE.forward_encoder)[0]
    enc = float(jnp.mean(latent.astype(jnp.float32) ** 2))
    noise = torch.from_numpy(np.array(jax.random.uniform(rng, (2, 8))))
    return params, x, noise, {"model": loss, "encoder": enc}


@pytest.mark.parametrize("variant", ["full", "fwd_bwd", "fwd", "encoder_fwd_bwd"])
def test_perf_breakdown_losses_match_jax(jax_mae, variant):
    params, x, noise, want = jax_mae
    state = mae_engine.create_train_state(tiny_cfg(), 100, 2, seed=0, dtype=torch.float32,
                                          device="cpu")[0]
    state.model.load_state_dict(state_dict_from_jax(params), strict=True)
    variants = perf_breakdown.Variants(state, torch.from_numpy(x), noise_of=lambda i: noise)
    got = float(getattr(variants, variant)(1)())
    ref = want["encoder" if variant == "encoder_fwd_bwd" else "model"]
    assert abs(got - ref) <= LOSS_REL * abs(ref), (variant, got, ref)


def test_perf_breakdown_line():
    r = perf_breakdown.run(batch=2, steps=2, runs=1, attn="xla", device="cpu", overrides=TINY_MAE)
    assert set(r["ms_per_step"]) == set(perf_breakdown.VARIANTS)
    assert set(r["derived_ms"]) == {"backward", "optimizer_overhead_in_full",
                                    "decoder_share_fwd_bwd"}
    assert all(math.isfinite(v) for v in r["losses"].values())
    assert r["attn"] == "xla" and r["device"]["name"] == "cpu"
    full = perf_breakdown.run(batch=2, steps=1, runs=1, full_only=True, device="cpu",
                              overrides=TINY_MAE)
    assert set(full["ms_per_step"]) == {"full"} and "derived_ms" not in full


@pytest.mark.parametrize("tool", ["dino", "downstream", "lock", "longcontext"])
def test_step_bench_lines(tool):
    if tool == "dino":
        r = bench_dino.run(batch=2, remat=True, steps=2, runs=1, device="cpu", overrides=TINY_DINO)
        assert r["remat"] is True
    elif tool in ("downstream", "lock"):
        r = bench_downstream.run(batch=2, lock=tool == "lock", classifier="attentive", steps=2,
                                 runs=1, device="cpu", overrides=TINY_VIT)
        assert r["lock"] is (tool == "lock") and r["classifier"] == "attentive"
    else:
        r = bench_longcontext.run(batch=1, steps=2, runs=1, device="cpu", overrides=TINY_MAE)
    assert {"metric", "value", "unit", "ms_per_step", "batch_per_gpu", "device"} <= set(r)
    assert r["value"] > 0 and math.isfinite(r["final_loss"]) and r["timed_steps"] == 2
    assert r["unit"] == "volumes/s/CPU" and not any(r["launches"].values())


def test_op_profile_on_a_cpu_step():
    r = op_profile.run("mae", batch=2, steps=1, device="cpu", cfg=tiny_cfg())
    assert abs(sum(r["categories"].values()) - 100.0) <= 0.1
    assert sum(k["share"] for k in r["top_kernels"]) <= 100.0 + 1e-6
    top = r["top_kernels"][:5]
    assert all(k["frame"] and ".py:" in k["frame"] for k in top), top
    assert r["elementwise_sites"] and r["device"]["name"] == "cpu"
    assert math.isfinite(r["final_loss"])


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": args}


def test_op_profile_parser_on_a_cuda_shaped_trace():
    """A forward kernel hangs from its launch under an op and the Python
    calls open around it; a backward kernel's op sits under its autograd
    node, whose sequence number leads to the forward op's frames; a kernel
    launched outside any op (the port's ctypes wrappers) is a direct
    launch."""
    pkg = "/x/headct_foundation_tpu_torch"
    trace = [
        _x("python_function", f"{pkg}/engines/mae_engine.py(321): grads", 0, 100),
        _x("python_function", f"{pkg}/models/layers.py(95): forward", 1, 20),
        _x("cpu_op", "aten::mul", 2, 5, **{"Sequence number": 7}),
        _x("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=101),
        _x("cpu_op", "aten::mm", 10, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=103),
        _x("python_function", f"{pkg}/ops/flash_attention.py(214): fused_attention", 30, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 31, 1, correlation=104),
        _x("python_function", "torch/_tensor.py(600): backward", 40, 50),
        _x("cpu_op", "autograd::engine::evaluate_function: MulBackward0", 41, 10,
           **{"Sequence number": 7}),
        _x("cpu_op", "aten::mul", 42, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 43, 1, correlation=102),
        _x("kernel", "vectorized_elementwise_kernel<mul>", 50, 30.0, correlation=101),
        _x("kernel", "vectorized_elementwise_kernel<mul>", 60, 40.0, correlation=102),
        _x("kernel", "sm90_xmma_gemm_bf16", 70, 20.0, correlation=103),
        _x("kernel", "flash_fwd_wgmma_kernel", 80, 10.0, correlation=104),
    ]
    r = op_profile.parse(trace, on_cuda=True, steps=1)
    assert r["device_ms_per_step"] == pytest.approx(0.1)
    assert r["categories"] == pytest.approx({"elementwise and other": 70.0, "GEMMs": 20.0,
                                             "attention kernels B1/B2": 10.0})
    by_op = {k["op"]: k for k in r["top_kernels"]}
    assert by_op["aten::mul"]["frame"] == "models/layers.py:95 forward"
    assert by_op["aten::mul in MulBackward0"]["frame"] == "models/layers.py:95 forward (backward)"
    assert by_op["aten::mm"]["category"] == "GEMMs" and by_op["aten::mm"]["share"] == 20.0
    assert by_op["(direct launch)"]["frame"] == "ops/flash_attention.py:214 fused_attention"
    assert [s["share"] for s in r["elementwise_sites"]] == [40.0, 30.0]
    # on the CPU each op's self time: its duration less its child ops'
    r = op_profile.parse(trace, on_cuda=False, steps=1)
    assert r["device_ms_per_step"] == pytest.approx((5 + 5 + 5 + 5) / 1e3)
    assert {k["op"]: k["share"] for k in r["top_kernels"]}["aten::mul in MulBackward0"] == 25.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sweep_paths_agree(monkeypatch, dtype):
    monkeypatch.setattr(fa, "VMEM_PATH_MAX_T", 48)  # a T past it leaves the whole path out
    short = sweep_attention.point("short", (2, 40, 2, 16), torch.device("cpu"), 1, dtype)
    long = sweep_attention.point("long", (1, 50, 2, 16), torch.device("cpu"), 1, dtype)
    assert set(short["paths"]) == {"plain", "whole", "blocked"} and not short["left_out"]
    assert set(long["paths"]) == {"plain", "blocked"} and "whole" in long["left_out"]
    for res in (short, long):
        for path in ("whole", "blocked"):
            if path in res["paths"]:
                assert res["paths"][path]["agreement"]["ok"], res["paths"][path]
    # a kernel path that disagrees fails the point
    monkeypatch.setitem(sweep_attention.PATHS, "blocked", lambda q, k, v: 1.1 * fa.
                        blocked_attention_reference(q, k, v)[0])
    with pytest.raises(RuntimeError, match="disagrees"):
        sweep_attention.point("bad", (2, 40, 2, 16), torch.device("cpu"), 1, dtype)


def test_sweep_fused_point():
    """The cell's own layout: q, k and v as views of one [B, T, 3, H, D]
    projection, every kernel path within the plain path's limits; the run
    takes it for the points in FUSED only."""
    q, k, v, _ = sweep_attention.fused_inputs((2, 40, 2, 16), torch.bfloat16, torch.device("cpu"))
    assert q.stride() == k.stride() == v.stride() and not q.is_contiguous()
    assert q._base is k._base is v._base and q._base.requires_grad
    res = sweep_attention.point("fused", (2, 40, 2, 16), torch.device("cpu"), 1, fused=True)
    assert res["fused"] and set(res["paths"]) == {"plain", "whole", "blocked"}
    assert all(res["paths"][p]["agreement"]["ok"] for p in ("whole", "blocked"))
    assert sweep_attention.FUSED <= {label for label, _ in sweep_attention.POINTS}


def test_sweep_crossovers():
    def res(shape, **ms):
        return {"shape": list(shape), "paths": {p: {"fwd_bwd_ms": t} for p, t in ms.items()}}

    grid = [res(s, plain=p, whole=w, blocked=9.0) for s, p, w in
            zip(sweep_attention.MIN_T_GRID, (1.0, 2.0, 2.0, 4.0, 8.0), (2.0, 3.0, 1.5, 3.0, 4.0))]
    long = [res((2, 769, 12, 64), plain=9.0, whole=1.0, blocked=2.0),
            res((2, 1025, 12, 64), plain=9.0, blocked=2.0)]
    c = sweep_attention.crossovers(grid + long)
    assert (c["pallas_min_t"]["implied"] == 192
            and c["pallas_min_t"]["current"] == port_attn.DEFAULT_PALLAS_MIN_T)
    assert c["VMEM_PATH_MAX_T"]["implied"] == 769


def test_bench_attention_line():
    r = bench_attention.run([("tiny", (2, 40, 2, 16))], iters=1, device="cpu")
    res = r["shapes"]["tiny"]
    for path in bench_attention.PATHS:
        assert res[path]["fwd_ms"] > 0 and res[path]["tf_s_fwd_bwd"] > 0
        assert not res[path]["launches"]  # plain versions on the CPU
    assert res["kernel"]["max_abs_diff_vs_plain"] <= 2e-2  # bfloat16 inputs
