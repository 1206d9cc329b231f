"""One run of one cell on one rank: set-up, the measured window through the
training CLIs' own epoch loop, the readings, the reference check.

Set-up builds the CLI's train state and step (``main_pretrain_mae``'s or
``dino_engine.make_train_step``), puts the seed's weights (``weights.py``,
made on the device) into the student (and DINO's teacher), sets the state
at the start of epoch ``traffic["epoch"]`` and drives the first
``traffic["compared_steps"]`` steps through the epoch loop
(``train_one_epoch``) and the package's ``DevicePrefetcher`` over the ring
of wire batches; those steps warm every shape the window uses and give the
measured readings: each step's loss, each parameter's first gradient as
AdamW got it (its first moment after one step over 1 - beta1) and each
parameter's change over those steps. The window then runs the same epoch
loop over the ring until ``seconds`` have passed (``data.TimedRing``). The
step passed to the loop is ``Stepper``: it calls the CLI's step with the
benchmark's draws for that update, reads the host clock around the call
and records a CUDA event after it, with no host sync. A traced run then
profiles ``traffic["trace_steps"]`` more steps. Once the window has closed
and the peak memory is read, the state is freed and the reference
(``reference/train.py``) follows the same steps from the same weights,
batches and draws.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from benchmark import compare, counts, data, trace, weights
from benchmark.cells import Cell
from benchmark.reference import dino as ref_dino
from benchmark.reference import mae as ref_mae
from benchmark.reference import train as ref_train


def port_config(run_cfg: dict):
    """The measured package's config node for the run configuration."""
    from headct_foundation_tpu_torch.config import default_config

    cfg = default_config()
    cfg.merge_from_dict(run_cfg)
    cfg.freeze()
    return cfg


def steps_total(run_cfg: dict, steps_per_epoch: int) -> tuple:
    total = steps_per_epoch * int(run_cfg["TRAIN"]["MAX_EPOCHS"])
    return total, int(float(run_cfg["TRAIN"]["PER_WARMUP"]) * total)


class SetupMarks:
    """Host seconds of each set-up stage, for standard error."""

    def __init__(self):
        self.t = time.perf_counter()
        self.marks: List[tuple] = []

    def __call__(self, stage: str) -> None:
        now = time.perf_counter()
        self.marks.append((stage, now - self.t))
        self.t = now

    def report(self, rank: int) -> None:
        print(f"rank {rank} set-up seconds: "
              + ", ".join(f"{stage} {s:.2f}" for stage, s in self.marks), file=sys.stderr)


class Stepper:
    """The step the epoch loop calls: the CLI's step with this update's
    draws, the host clock around it and a CUDA event after it."""

    def __init__(self, step: Callable, draws: Callable[[int], Any], cuda: bool):
        self.step, self.draws, self.cuda = step, draws, cuda
        self.host_s: List[float] = []
        self.ends: List[Any] = []          # CUDA events, or host times off the card
        self.losses: List[torch.Tensor] = []
        self.after: Optional[Callable[[int, Any], None]] = None
        self.before: Optional[Callable[[int], None]] = None

    def __call__(self, state, batch, seed, *rest):
        n = len(self.host_s)
        if self.before is not None:
            self.before(n)
        d = self.draws(state.step)
        t0 = time.perf_counter()
        state, metrics = self.step(state, batch, seed, *rest, draws=[d])
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.ends.append(ev)
        t1 = time.perf_counter()
        if not self.cuda:
            self.ends.append(t1)
        self.host_s.append(t1 - t0)
        self.losses.append(metrics["loss"])
        if self.after is not None:
            self.after(n, state)
        return state, metrics


@dataclass
class RankResult:
    """What one rank hands back (plain numbers)."""
    steps: int = 0                       # window steps
    window_s: float = 0.0
    intervals_ms: List[float] = field(default_factory=list)
    host_ms: List[float] = field(default_factory=list)
    data_time_s: float = 0.0
    peak_bytes: int = 0
    failed: int = 0
    launches: Dict[str, float] = field(default_factory=dict)  # per step of the epoch call
    profile: Optional[dict] = None
    readings: Optional[dict] = None      # the measured run's
    reference: Optional[dict] = None
    left_out: int = 0                    # elements the nought rule left out of the change


def _engine(engine: str):
    from headct_foundation_tpu_torch import main_pretrain_mae
    from headct_foundation_tpu_torch.engines import dino_engine, mae_engine

    if engine == "mae":
        return mae_engine, main_pretrain_mae.make_train_step
    return dino_engine, dino_engine.make_train_step


def _networks(state, engine: str) -> Dict[str, torch.nn.Module]:
    if engine == "mae":
        return {"": state.model}
    return {"": state.student, "teacher.": state.teacher}


def load_weights(state, engine: str, spec: List[tuple], w: Dict[str, torch.Tensor]) -> None:
    """Copy the seed's weights into the state's networks; the parameters,
    their shapes and which of them train must be the reference's."""
    trainable = {s[0] for s in weights.trainable(spec)}
    for prefix, net in _networks(state, engine).items():
        params = dict(net.named_parameters())
        if set(params) != {s[0] for s in spec}:
            raise ValueError(f"the {prefix or 'model'} parameters differ from the reference's: "
                             f"{sorted(set(params) ^ {s[0] for s in spec})[:6]}")
        with torch.no_grad():
            for name, p in params.items():
                if not prefix and p.requires_grad != (name in trainable):
                    raise ValueError(f"{name}: trains {p.requires_grad} in the measured run")
                if name in w:
                    p.copy_(w[name])


def run_rank(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
             rank: int = 0, world: int = 1, agree: Optional[Callable[[bool], bool]] = None,
             barrier: Optional[Callable[[], None]] = None,
             all_reduce: Optional[Callable[[List[torch.Tensor]], None]] = None,
             on_window: Optional[Callable[[], None]] = None) -> RankResult:
    """One rank's run (see the module). ``on_window`` is called as the
    window opens (the set-up clock stops there)."""
    res, change = measure(cell, seed, seconds, traced, device, rank, world, agree, barrier,
                          on_window)
    gc.collect()  # the measured state is gone with ``measure``'s frame
    if device.type == "cuda":
        torch.cuda.empty_cache()
    raw = reference(cell, cell.run_config(), seed, device, rank, world, all_reduce)
    masks = compare.nought_masks(raw["grads"])
    res.readings["change_norms"] = compare.change_norms(change, masks)
    res.reference = compare.readings(raw, masks)
    res.left_out = sum(int((~m).sum()) for m in masks.values())
    return res


def measure(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
            rank: int, world: int, agree, barrier, on_window) -> tuple:
    """Set-up, the compared steps and the window: the result and each
    parameter's change over the compared steps (host tensors)."""
    cuda = device.type == "cuda"
    marks = SetupMarks()
    t = cell.traffic
    run_cfg = cell.run_config()
    cfg = port_config(run_cfg)
    engine_mod, make_step = _engine(cell.engine)
    ref_model = ref_mae if cell.engine == "mae" else ref_dino
    spe = int(t["steps_per_epoch"])
    epoch, compared = int(t["epoch"]), int(t["compared_steps"])
    total, warm = steps_total(run_cfg, spe)
    batch = int(t["batch"])
    if cell.engine == "mae":
        state, _ = engine_mod.create_train_state(cfg, total, warm, seed=seed % (1 << 63),
                                                 device=device)
    else:
        state = engine_mod.create_train_state(cfg, total, warm, spe, seed=seed % (1 << 63),
                                              device=device)
    marks("train state")
    spec = ref_model.spec(run_cfg)
    w0 = weights.make(spec, seed, device)
    load_weights(state, cell.engine, spec, w0)
    marks("weights")
    state.step = start_step = epoch * spe
    ring = data.ring(batch, int(t["input_size"]), int(t["ring"]), seed, rank)
    marks("ring")
    stepper = Stepper(make_step(cfg), lambda step: data.draws(
        cell.engine, run_cfg, seed, step, batch, world, rank, device), cuda)
    beta1 = float(run_cfg["TRAIN"]["BETA1"])
    student = state.model if cell.engine == "mae" else state.student
    trained = [(n, p) for n, p in student.named_parameters() if p.requires_grad]
    first_grads: Dict[str, torch.Tensor] = {}

    def after(n: int, st) -> None:
        if n == 0:  # AdamW's first moment after one update is (1 - beta1) g
            none = torch.zeros((), device=device)  # an optimizer that took no step got none
            moments = [st.optimizer.state.get(p, {}).get("exp_avg", none) for _, p in trained]
            norms = torch.stack(torch._foreach_norm(moments)) / (1.0 - beta1)
            first_grads["norms"] = norms

    stepper.after = after
    max_epoch = int(run_cfg["TRAIN"]["MAX_EPOCHS"])
    state, _ = engine_mod.train_one_epoch(cfg, state, stepper, data.TimedRing(ring, count=compared),
                                          seed, epoch, max_epoch)
    stepper.after = None
    readings, change = _measured(state, cell.engine, w0, stepper, first_grads["norms"],
                                 trained, compared)
    marks("compared steps")
    del w0
    _sync(device)
    if barrier is not None:
        barrier()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    marks("window opens")
    marks.report(rank)
    if on_window is not None:
        on_window()
    t_start = time.perf_counter()
    loader = data.TimedRing(ring, first=compared, seconds=seconds,
                            extra=2 * int(t["trace_steps"]) if traced else 0, agree=agree)
    tracer = Tracer(loader, compared, int(t["trace_steps"]), device) if traced else None
    stepper.before = tracer
    before = engine_mod.kernel_launches()
    loader.start()
    state, stats = engine_mod.train_one_epoch(cfg, state, stepper, loader, seed, epoch, max_epoch)
    _sync(device)
    host_end = time.perf_counter()
    res = RankResult(steps=loader.timed, data_time_s=float(stats["data_time"]),
                     launches={k: (v - before[k]) / max(int(stats["steps"]), 1)
                               for k, v in engine_mod.kernel_launches().items()},
                     readings=readings)
    window = slice(compared, compared + loader.timed)
    res.host_ms = [1e3 * s for s in stepper.host_s[window]]
    if cuda:
        ends = [start.elapsed_time(e) for e in stepper.ends[window]]
        res.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    else:
        ends = [1e3 * (e - t_start) for e in stepper.ends[window]]
    res.window_s = ends[-1] / 1e3 if ends else host_end - t_start
    res.intervals_ms = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    losses = torch.stack([l.float() for l in stepper.losses[window]]).cpu()
    res.failed = int((~torch.isfinite(losses)).sum())
    if tracer is not None:
        res.profile = tracer.result()
    return res, change


class Tracer:
    """The traced stretches after the window: ``steps`` steps under
    ``torch.profiler`` without Python stacks (the device's busy and idle
    time, the top operations, the idle gaps and the exposed NCCL time, at
    the profiler's least cost to the host), then ``steps`` more with
    stacks, whose call sites give each layer's device time."""

    def __init__(self, loader: data.TimedRing, compared: int, steps: int, device: torch.device):
        self.loader, self.compared, self.steps, self.device = loader, compared, steps, device
        self.prof: Any = None
        self.parsed: List[dict] = []

    def _stop(self) -> None:
        """Stop the running profile and reduce it now: the next one clears
        the profiler's events."""
        _sync(self.device)
        self.prof.stop()
        self.parsed.append(trace.parse(trace.export(self.prof), self.steps))
        self.prof = None

    def _start(self, stacks: bool) -> None:
        from torch.profiler import ProfilerActivity, profile

        if self.prof is not None:
            self._stop()
        _sync(self.device)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.device.type == "cuda" else [])
        self.prof = profile(activities=acts, with_stack=stacks)
        self.prof.start()

    def __call__(self, n: int) -> None:
        if self.loader.timed is None:
            return
        first = self.compared + self.loader.timed
        if n == first:
            self._start(stacks=False)
        elif n == first + self.steps:
            self._start(stacks=True)

    def result(self) -> dict:
        self._stop()
        plain, stacked = self.parsed
        plain["layer_ms"] = stacked["layer_ms"]
        return plain


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measured(state, engine: str, w0: Dict[str, torch.Tensor], stepper: Stepper,
              grad_norms: torch.Tensor, trained: list, compared: int) -> tuple:
    """The measured run's losses and first-gradient norms (host floats) and
    each parameter's change over the compared steps (host tensors)."""
    names = [n for n, _ in trained]
    change = {n: p.detach() - w0[n] for n, p in trained}
    if engine == "dino":
        teacher = dict(state.teacher.named_parameters())
        change.update({f"teacher.{n}": teacher[n].detach() - w0[n] for n in names})
        change["center"] = state.center
    losses = torch.stack([x.float() for x in stepper.losses[:compared]]).cpu()
    return ({"losses": [float(l) for l in losses],
             "grad_norms": dict(zip(names, grad_norms.double().cpu().tolist()))},
            {k: v.float().cpu() for k, v in change.items()})


def reference(cell: Cell, run_cfg: dict, seed: int, device: torch.device, rank: int,
              world: int, all_reduce=None, precision: str = "float32",
              fault: Optional[str] = None) -> dict:
    """The plain reference over the compared steps of this rank's rows
    (averaged over ranks by ``all_reduce``): ``reference/train.py follow``'s
    losses, first gradients and changes."""
    t = cell.traffic
    ref_model = ref_mae if cell.engine == "mae" else ref_dino
    spe, epoch, compared = int(t["steps_per_epoch"]), int(t["epoch"]), int(t["compared_steps"])
    batch = int(t["batch"])
    w0 = weights.make(ref_model.spec(run_cfg), seed, device)
    ring = data.ring(batch, int(t["input_size"]), int(t["ring"]), seed, rank)
    batches = [torch.from_numpy(ring[i % len(ring)]).to(device) for i in range(compared)]
    start = epoch * spe
    draws = [data.draws(cell.engine, run_cfg, seed, start + i, batch, world, rank, device)
             for i in range(compared)]
    return ref_train.follow(cell.engine, run_cfg, w0, batches, draws, start, epoch, spe,
                            int(t["ref_rows"]), precision=precision, all_reduce=all_reduce,
                            fault=fault)


def checks(cell: Cell, res: RankResult) -> Dict[str, Dict[str, float]]:
    values = compare.gaps(res.readings, res.reference)
    return {k: {"value": values[k], "limit": float(cell.limits[k])} for k in cell.limits}


@dataclass
class RunRecord:
    """What a metric reader reads (pooled over ranks)."""
    cell: Cell
    run_cfg: dict
    world: int
    batch: int
    steps: int                  # window steps of one rank
    window_s: float             # the slowest rank's window
    intervals_ms: List[float]
    host_ms: List[float]
    data_time_s: float
    peak_bytes: int
    setup_s: float
    device_name: str
    profile: Optional[dict]

    @property
    def volumes_per_s(self) -> float:
        return self.steps * self.batch / self.window_s

    @property
    def peak(self) -> Optional[Dict[str, float]]:
        return counts.peaks(self.device_name)


def metrics(record: RunRecord, names: List[dict]) -> Dict[str, Dict[str, Any]]:
    """Each named metric's reading with its unit; a reader that finds
    nothing to read is left out."""
    from benchmark.cells import reader

    out = {}
    for m in names:
        value = reader(m["name"])(record)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"{m['name']} read {value}")
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
