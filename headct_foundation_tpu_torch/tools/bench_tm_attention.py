"""A/B micro-benchmark: token-major against whole-sequence attention on the card.

Port of the JAX repository's ``tools/bench_tm_attention.py``. At each of its
shapes (``SHAPES``, bfloat16), runs forward and backward of (a)
``ops.flash_attention.FusedAttention`` (kernels B1, B2, reading [B, T, H, D]
through its strides) and (b) ``FusedAttentionTM`` (kernels B7, B8, on the
token-major layout [B, T, H*D]) on the same inputs and incoming gradient,
cross-checks out and the gradients of q, k and v between the two, then times
forward+backward per call of each: CUDA events, median of ``ITERS`` after 3
warm-up calls, each call queued behind a device-side sleep so that the
events bracket device time and not the host's launch work (the JAX tool
timed a compiled scan of steps). Prints one line per shape and, last, one
JSON object.

    python -m headct_foundation_tpu_torch.tools.bench_tm_attention

Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import json
import statistics
from typing import Callable, Dict, Sequence, Tuple

import torch

from headct_foundation_tpu_torch.ops.flash_attention import FusedAttention
from headct_foundation_tpu_torch.tools.experimental_tm_attention import FusedAttentionTM

ITERS = 20
AHEAD = 4_000_000  # clock cycles of device sleep before each timed call, ~2 ms at 1.98 GHz

SHAPES = [  # (name, [B, T, H, D]) as in the JAX tool
    ("mae_encoder", (32, 129, 12, 64)),
    ("mae_decoder", (32, 513, 16, 48)),
    ("dino_student", (128, 517, 12, 64)),
    ("vit_96", (32, 513, 12, 64)),
]


def cuda_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3, ahead: int = 0) -> float:
    """Median device time of one call, from CUDA events around each call.
    With an idle stream the events also bracket the host's launch work. A
    nonzero ``ahead`` first queues a device-side sleep of that many clock
    cycles, long enough for the host to enqueue both events and fn's
    launches behind it, so that they bracket the device's work alone (for a
    call shorter than its launches)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if ahead:
            torch.cuda._sleep(ahead)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def _fwd_bwd(apply, q, k, v, w) -> Tuple[torch.Tensor, ...]:
    """o and the gradients of sum(o * w) with respect to q, k, v."""
    o = apply(q, k, v, None)[0]
    return (o, *torch.autograd.grad(o, (q, k, v), w))


def run(shapes: Sequence = SHAPES, iters: int = ITERS) -> Dict[str, dict]:
    """The cross-check and timings at each of ``shapes``, by name."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_tm_attention needs a CUDA card")
    out = {}
    for name, (B, T, H, D) in shapes:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, w = (torch.randn(B, T, H, D, device="cuda", generator=g).to(torch.bfloat16)
                      for _ in range(4))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        a = _fwd_bwd(FusedAttention.apply, q, k, v, w)
        b = _fwd_bwd(FusedAttentionTM.apply, q, k, v, w)
        torch.cuda.synchronize()
        diffs = [(x.float() - y.float()).abs().max().item() for x, y in zip(a, b)]
        res = {"shape": [B, T, H, D], "dtype": "bfloat16",
               "max_abs_diff_out": diffs[0], "max_abs_diff_grad": max(diffs[1:]),
               "bit_identical": all(torch.equal(x, y) for x, y in zip(a, b))}
        del a, b
        for label, apply in (("bhtd", FusedAttention.apply), ("tm", FusedAttentionTM.apply)):
            res[label] = {"ms_per_call_fwd_bwd": cuda_ms(
                lambda apply=apply: _fwd_bwd(apply, q, k, v, w), iters, ahead=AHEAD)}
        res["speedup_tm"] = res["bhtd"]["ms_per_call_fwd_bwd"] / res["tm"]["ms_per_call_fwd_bwd"]
        print(f"bench_tm_attention {name} {[B, T, H, D]} bf16: FusedAttention "
              f"{res['bhtd']['ms_per_call_fwd_bwd']:.4f} ms, FusedAttentionTM "
              f"{res['tm']['ms_per_call_fwd_bwd']:.4f} ms per forward+backward "
              f"(speedup {res['speedup_tm']:.3f}); max |diff| out {diffs[0]:.3e} grads "
              f"{max(diffs[1:]):.3e}, bit-identical {res['bit_identical']}", flush=True)
        out[name] = res
        del q, k, v, w
        torch.cuda.empty_cache()
    return out


def main() -> None:
    out = run()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shapes": out}), flush=True)


if __name__ == "__main__":
    main()
