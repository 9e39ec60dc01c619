"""One run of one cell: set-up, the measured window, the traced
sub-window, the metrics and the check that decides `correct`.

A cell is found by name. `BENCHMARK.json` names its configuration and its
traffic; the harness then reads, under this folder:

  configs/<config>.json     the model's published keys, its precision and
                            the port's registry name
  workloads/<cell>.json     the traffic mix's parameters (traffic.py), the
                            engine's test-time settings, the traced
                            sub-window's length and the check's limits
  ops/*.json                one file per kernel family: the operation it
                            serves, the work function (a function of
                            work.py, or "<file>.py:<function>" of a file
                            in ops/) and the kernel-name patterns; an
                            operation's patterns are the union of its files
  metrics/<metric>.py       one reader per per-layer metric: read(run)
                            returns the value, or None where the run holds
                            nothing to read
  reference/encoders/<MODEL_ENCODER>.py
                            the configuration's encoder in the plain
                            reference (reference.load)

The program under test is driven only through
`aot_tpu_torch.engine.build_infer_engine(...)`: `add_reference_frame` at a
video's first frame, `ensure_lt_capacity` before each long-term write and
`step` for every other frame, with the host mirror of the write schedule
(`make_shadow`), as the evaluator drives it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from vosbench import check, work
from vosbench.stages import Stages
from vosbench.trace import Trace
from vosbench.traffic import Traffic, Video
from vosbench.weights import make_weights

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aot_tpu")
GIB = float(1 << 30)
STAGE = "pre_ytb_dav"        # the eval CLI's default stage
LEAD_IN = 2       # frames profiled before the sub-window (CUPTI's start-up)
TRACE_START = 0.5  # the traced sub-window starts halfway through the window


def forbidden_modules(names) -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (aot_tpu_torch is the port and passes)."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    workload: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    ops: Dict[str, Dict]
    root: Path


def load_cell(bench_path: Path, name: str, root: Path = ROOT) -> Cell:
    bench = json.loads(Path(bench_path).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {bench_path}: "
                         f"{sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / "configs" / f"{entry['config']}.json")
                        .read_text())
    workload = json.loads((root / "workloads" / f"{name}.json").read_text())
    if workload["traffic"] != entry["traffic"]:
        raise SystemExit(f"{name}: workloads/{name}.json is traffic "
                         f"{workload['traffic']!r}, BENCHMARK.json says "
                         f"{entry['traffic']!r}")
    if config["name"] != configs[entry["config"]]["name"]:
        raise SystemExit(f"{name}: configs/{entry['config']}.json names "
                         f"{config['name']!r}")

    def mine(m):
        return name in m.get("workloads", [name])

    ops: Dict[str, Dict] = {}
    for path in sorted((root / "ops").glob("*.json")):
        spec = json.loads(path.read_text())
        op = ops.setdefault(spec["op"], {"work": spec["work"], "kernels": []})
        if op["work"] != spec["work"]:
            raise SystemExit(f"{path}: op {spec['op']!r} already has work "
                             f"{op['work']!r}")
        op["kernels"] += spec["kernels"]
    return Cell(name, config, workload,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)], ops, Path(root))


def load_file(path: Path, prefix: str):
    """The module in the file at `path`, loaded by path."""
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: Path, metric: str) -> Callable:
    return load_file(root / "metrics" / f"{metric}.py",
                     "vosbench_metric_").read


def load_work(root: Path, name: str) -> Callable:
    """The work function an ops/*.json names: "<file>.py:<function>", a
    file of ops/ loaded by path, or else a function of work.py."""
    if ":" not in name:
        return getattr(work, name)
    file, function = name.split(":", 1)
    if Path(file).name != file or not file.endswith(".py"):
        raise SystemExit(f"work {name!r}: name a .py file of ops/")
    return getattr(load_file(root / "ops" / file, "vosbench_ops_"),
                   function)


@dataclasses.dataclass
class Frame:
    video: int
    t: int                     # frame index in its video (0: reference)
    kind: str                  # 'ref' or 'step'
    live: int                  # long-term frames its read sees
    start: float
    end: float = 0.0
    enqueue: float = 0.0
    window: bool = False
    traced: bool = False
    mask: Optional[np.ndarray] = None          # served mask, checked videos
    logits: Optional[torch.Tensor] = None      # kept for the check (host)
    seq: int = 0                               # position in the run


class PortServer:
    """The program: VOSInferEngine driven as the evaluator drives it."""

    def __init__(self, cfg, model):
        from aot_tpu_torch.engine import build_infer_engine

        self.model = model
        self.eng = build_infer_engine(model, cfg)
        self.state = None

    def start(self, img, mask, objects: int) -> None:
        self.state = self.eng.add_reference_frame(img, mask, objects)
        self.shadow = self.eng.make_shadow()
        self.shadow.add_ref(0)
        self.t = 0

    def step(self, img, size):
        """(mask (1, H, W) int on the device, logits, enqueue seconds)."""
        self.t += 1
        if self.shadow.will_write(self.t):
            self.state = self.eng.ensure_lt_capacity(self.state,
                                                     self.shadow.count + 1)
        t0 = time.perf_counter()
        self.state, pred, logits = self.eng.step(self.state, img, size)
        enqueue = time.perf_counter() - t0
        self.shadow.update(self.t)
        return pred, logits, enqueue

    def close(self) -> None:
        self.state = self.eng = self.model = None


def port_cfg(cell: Cell):
    from aot_tpu_torch.configs import build_config

    keys = {k: v for k, v in cell.config.items()
            if k.startswith(("MODEL_", "TEST_"))}
    keys.update(cell.workload.get("engine", {}))
    keys["TEST_DTYPE"] = cell.config["precision"]
    return build_config(stage=STAGE, model=cell.config["model"], **keys)


def port_program(cell: Cell, weights, device):
    """The port's serving model with the benchmark's weights loaded."""
    from aot_tpu_torch.models.aot import build_vos_model

    cfg = port_cfg(cell)
    model = build_vos_model(cfg, device="meta").to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return PortServer(cfg, model.eval())


def weight_layout(cell: Cell) -> Dict[str, tuple]:
    """The published state dict's names and shapes, as the port's serving
    model holds them (the port loads the published checkpoints strictly)."""
    from aot_tpu_torch.models.aot import build_vos_model

    model = build_vos_model(port_cfg(cell), device="meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def profiler_activities(device):
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Runner:
    """Drives frames through a server and keeps the record of each. Masks
    come back into one page-locked buffer; only the videos in `checked`
    keep theirs (and some logits) for the check."""

    def __init__(self, cell: Cell, server, traffic: Traffic, device):
        self.cell = cell
        self.server = server
        self.traffic = traffic
        self.device = device
        self.size = traffic.size
        self.frames: List[Frame] = []
        self.videos: Dict[int, Video] = {}
        self.profiling = False
        self.phases: List[tuple] = []
        self.engine = cell.workload.get("engine", {})
        self.gap = cell.config["TEST_LONG_TERM_MEM_GAP"]
        self.keep_every = cell.workload["check"]["keep_logits_every"]
        self.count = 0
        self.checked: List[int] = []
        self.readback = torch.empty((1,) + tuple(self.size),
                                    dtype=torch.uint8,
                                    pin_memory=device.type == "cuda")

    @contextlib.contextmanager
    def phase(self, name: str):
        """While profiling, the span of a harness phase on the host's wall
        clock (the trace's clock), in microseconds."""
        if not self.profiling:
            yield
            return
        start = time.time_ns() / 1e3
        try:
            yield
        finally:
            self.phases.append((name, start, time.time_ns() / 1e3))

    def upload(self, frame: torch.Tensor) -> torch.Tensor:
        return frame[None].to(self.device)

    def run(self, video: Video, t: int, window: bool) -> Frame:
        self.videos[video.index] = video
        if t == 0:
            self.lt_count, self.last_write = 1, 0
            rec = Frame(video.index, 0, "ref", 1, time.perf_counter())
            with self.phase("video_switch"):
                img = self.upload(self.traffic.image(video, 0))
                mask = self.upload(torch.from_numpy(
                    self.traffic.mask(video))).long()
                self.server.start(img, mask, video.objects)
                synchronize(self.device)
        else:
            live = work.live_frames_of(self.engine, self.lt_count)
            rec = Frame(video.index, t, "step", live, time.perf_counter())
            with self.phase("upload"):
                img = self.upload(self.traffic.image(video, t))
            with self.phase("step"):
                pred, logits, rec.enqueue = self.server.step(img, self.size)
            with self.phase("readback"):
                self.readback.copy_(pred.to(torch.uint8))
            if t - self.last_write >= self.gap:
                self.lt_count += 1
                self.last_write = t
        rec.end = time.perf_counter()
        rec.window = window
        rec.traced = self.profiling
        rec.seq = self.count
        self.count += 1
        # a checked video keeps every served mask, and on the host the
        # logits of every keep_every-th frame and of its last frame (on the
        # card they would move the peak memory with the frame rate)
        if rec.kind == "step" and video.index in self.checked:
            rec.mask = self.readback.numpy()[0].copy()
            if t % self.keep_every == 0 or t == video.frames - 1:
                rec.logits = logits.cpu()
        self.frames.append(rec)
        return rec


def program_tracing():
    """The program's spans and counters (`aot_tpu_torch.utils.tracing`),
    or None where the program has none: then a run goes as before, with no
    stage table and no counters to read."""
    try:
        from aot_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def feed(video: Video, t: int, stream: Iterator[Video]
         ) -> Iterator[Tuple[Video, int]]:
    """(video, frame) to serve next, from frame t of `video` on, then the
    stream's next videos."""
    while True:
        if t >= video.frames:
            video, t = next(stream), 0
        yield video, t
        t += 1


@dataclasses.dataclass
class Setup:
    """What set-up leaves for the window: the program serving, and the
    frames to serve next."""
    layout: Dict[str, tuple]
    weights: Dict[str, torch.Tensor]
    server: object
    traffic: Traffic
    runner: "Runner"
    frames: Iterator[Tuple[Video, int]]


def setup(cell: Cell, seed: int, device,
          program: Optional[Callable] = None) -> Setup:
    """A run's set-up: TF32 off and cuDNN autotuning on, as the eval CLI
    sets them; the weights and the frame pool from the seed; the program
    `program(cell, weights, device)` (the port by default); the warm-up
    video; the checked videos drawn from the stream's first pass; then the
    stream's reference frame and first `fill_steps` frames."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    wl = cell.workload
    layout = weight_layout(cell)
    weights = make_weights(layout, seed, device)
    server = (program or port_program)(cell, weights, device)
    traffic = Traffic(wl, seed, device)
    runner = Runner(cell, server, traffic, device)
    warm = traffic.warmup()
    for t in range(warm.frames):
        runner.run(warm, t, window=False)
    first, stream = traffic.first_pass(traffic.videos())
    runner.checked = check.sample_videos(first, seed, wl["check"]["videos"],
                                         wl["check"].get("within_frames"))
    frames = feed(next(stream), 0, stream)
    for _ in range(wl.get("fill_steps", 0) + 1):
        runner.run(*next(frames), window=False)
    synchronize(device)
    return Setup(layout, weights, server, traffic, runner, frames)


@dataclasses.dataclass
class Profiled:
    """The traced frames as recorded; read once the window has closed
    (writing out the profiler's trace takes seconds)."""
    prof: object
    window: List[float]          # the traced frames' span, wall clock us
    frames: int
    spans: Optional[list]        # the program's span records
    counters: Optional[Dict[str, float]]   # their change over the frames

    def read(self, phases) -> Tuple[Trace, Optional[Stages]]:
        trace = Trace.from_profiler(self.prof, self.window, phases)
        self.prof = None
        stages = (Stages(trace, self.spans, self.frames)
                  if self.spans is not None else None)
        return trace, stages


def profile_frames(runner: "Runner", frames, count: int, device,
                   tracing) -> Profiled:
    """The traced sub-window: torch.profiler on the device's activity
    (recording every host op as well would slow the host several-fold and
    read as device idle time) over LEAD_IN frames, which take the
    profiler's start-up, then `count` frames. With the program's tracing
    module given, its spans are on from just before the profiler starts
    to just after it stops, and its counters are read at the `count`
    frames' edges."""
    prof = torch.profiler.profile(activities=profiler_activities(device))
    if tracing is not None:
        tracing.take_spans()
        prev = tracing.enable_spans(True)
    prof.start()
    for _ in range(LEAD_IN):
        runner.run(*next(frames), window=True)
    runner.profiling = True
    before = tracing.counters() if tracing is not None else None
    window = [time.time_ns() / 1e3, None]
    for _ in range(count):
        runner.run(*next(frames), window=True)
    window[1] = time.time_ns() / 1e3
    after = tracing.counters() if tracing is not None else None
    runner.profiling = False
    prof.stop()
    spans = counters = None
    if tracing is not None:
        tracing.enable_spans(prev)
        spans = tracing.take_spans()
        counters = {k: after.get(k, 0) - before.get(k, 0)
                    for k in sorted(set(after) | set(before))
                    if after.get(k, 0) != before.get(k, 0)}
    return Profiled(prof, window, count, spans, counters)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, program: Optional[Callable] = None) -> Dict:
    """One run. `program(cell, weights, device)` builds the server under
    test (the port by default). Returns the result line's fields plus the
    check's numbers under 'checks'."""
    device = torch.device(device)
    wl = cell.workload
    s = setup(cell, seed, device, program)
    runner, frames = s.runner, s.frames
    setup_peak = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # the measured window, with the collector held off: what set-up made is
    # frozen out of its scans, and the window's garbage is freed by counts
    gc.collect()
    gc.freeze()
    gc.disable()
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    t_close = t_window + seconds
    t_trace = t_window + seconds * TRACE_START
    sub = None
    profiled = None
    while time.perf_counter() < t_close:
        if trace and sub is None and time.perf_counter() >= t_trace:
            sub = [time.perf_counter(), None]
            profiled = profile_frames(runner, frames, wl["trace_frames"],
                                      device, program_tracing())
            sub[1] = time.perf_counter()
            continue
        runner.run(*next(frames), window=True)
    synchronize(device)
    gc.enable()
    gc.unfreeze()
    done = [f for f in runner.frames if f.window and f.end <= t_close]
    attempted = sum(1 for f in runner.frames if f.window)
    window_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)

    result: Dict = {"correct": False, "attempted": attempted,
                    "failed": 0, "metrics": {}, "device": {}}
    if device.type == "cuda":
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(device),
                            "count": 1,
                            "memory_peak_bytes": max(setup_peak, window_peak)}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}

    run = RunRecord(cell, runner, done, seconds, t_window, t_close, sub,
                    s.layout, s.traffic.size)
    if not trace:
        times = [f.end - f.start for f in done]
        e2e = {
            "frames_per_s": (len(done) / seconds, "frames/s"),
            "frame_ms_p95": (percentile(times, 95) * 1e3, "ms"),
            "peak_mem_gib": (window_peak / GIB, "GiB"),
            "setup_s": (setup_s, "s"),
        }
        for m in cell.end_to_end:
            value, unit = e2e[m["name"]]
            result["metrics"][m["name"]] = {"value": value, "unit": unit}
    else:
        run.trace, run.stages = profiled.read(runner.phases)
        run.counters = profiled.counters
        for m in cell.per_layer:
            value = load_reader(cell.root, m["name"])(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown(run)

    # the check, once the program's state is freed
    s.server.close()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check.check(cell, runner, s.weights, s.traffic, device)
    result["timing"] = {"check_s": time.perf_counter() - t_check,
                        "per_second": per_second(done, t_window, seconds),
                        "drift": checks["drift"]}
    result["correct"] = bool(checks["correct"])
    result["checks"] = checks["numbers"]
    return result


@dataclasses.dataclass
class RunRecord:
    """What a per-layer reader reads."""
    cell: Cell
    runner: Runner
    done: List[Frame]            # frames served inside the window
    seconds: float
    t_window: float
    t_close: float
    sub: Optional[list]          # [start, end] of the traced sub-window
    layout: Dict
    size: tuple
    trace: Optional[Trace] = None
    stages: Optional[Stages] = None      # None: the program has no spans
    counters: Optional[Dict[str, float]] = None   # change over the traced
                                                  # frames

    @functools.cached_property
    def stage_table(self) -> Optional[Dict[str, Dict[str, float]]]:
        return self.stages.table() if self.stages is not None else None

    def stage(self, name: str, key: str) -> Optional[float]:
        """`key` (stages.Stages.table) of the span `name` a traced frame;
        None where the program recorded no spans or never opened it."""
        row = (self.stage_table or {}).get(name)
        return None if row is None else row[key]

    def before_trace(self) -> List[Frame]:
        """The window's frames served before the profiler started: once
        started, it leaves the host slower for the rest of the process."""
        end = self.sub[0] if self.sub else self.t_close
        return [f for f in self.done if f.end <= end]

    def before_trace_seconds(self) -> float:
        return (self.sub[0] if self.sub else self.t_close) - self.t_window

    def traced(self) -> List[Frame]:
        return [f for f in self.runner.frames if f.traced]

    def frame_work(self, f: Frame):
        return work.frame_work(work.model_key(self.cell.config),
                               tuple(self.layout.items()), tuple(self.size),
                               f.kind, f.live, self.cell.root)

    def op_roofline(self, op: str) -> Optional[float]:
        """100 x the least time of the traced frames' reads of `op` over the
        device time of the kernels its ops/ files name; None where none
        ran."""
        spec = self.cell.ops.get(op)
        if spec is None or self.trace is None:
            return None
        device_s = self.trace.matched_seconds(spec["kernels"])
        fn = load_work(self.cell.root, spec["work"])
        bound = sum(fn(self.frame_work(f)[1]) for f in self.traced())
        if device_s <= 0 or bound <= 0:
            return None
        return 100.0 * bound / device_s


def per_second(frames, t_window: float, seconds: float) -> List[int]:
    """Frames served in each second of the window."""
    counts = [0] * int(math.ceil(seconds))
    for f in frames:
        counts[min(int(f.end - t_window), len(counts) - 1)] += 1
    return counts


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def breakdown(run: RunRecord, top: int = 10) -> Dict:
    """The traced frames' largest device operations and idle gaps by the
    harness's phase (seconds over the frames); where the program recorded
    spans, its stages by device time (each span with everything under
    it), the idle time by span, and its counters a frame (by name)."""
    tr = run.trace
    ops = sorted(tr.device_time_by_name().items(), key=lambda kv: -kv[1])
    gaps = sorted(tr.idle_by_phase().items(), key=lambda kv: -kv[1])
    out = {"device_ops": [[n[:160], s] for n, s in ops[:top]],
           "idle_gaps": [[n, s] for n, s in gaps[:top]]}
    if run.stage_table is not None:
        frames = run.stages.frames
        stages = sorted(((n, r["device_ms"] * frames / 1e3)
                         for n, r in run.stage_table.items()),
                        key=lambda kv: -kv[1])
        out["stages"] = [[n, s] for n, s in stages[:top]]
        out["idle_by_span"] = [[n, s] for n, s in
                               list(run.stages.idle_by_span().items())[:top]]
    if run.counters is not None:
        frames = max(len(run.traced()), 1)
        out["counters"] = [[n, v / frames] for n, v in
                           sorted(run.counters.items())[:top]]
    return out

