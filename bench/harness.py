"""The benchmark's yardstick: one cell's run, from its files to its line.

``run_cell`` finds the cell by name in ``BENCHMARK.json``, its
configuration under ``bench/configs/``, its traffic under
``bench/traffic/`` (whose ``driver`` key names a module of
``bench/drivers/``) and its correctness limits under ``bench/cells/``;
makes the weights from the seed (``bench/weights.py``), hands them to
the driver, which builds the port's engines and runs set-up, the window
and (with ``--trace 1``) a profiled sub-window; then frees the program's
state, judges what the window served against the plain reference
(``bench/judge.py``) and reads each per-layer metric with its reader
``bench/metrics/<name>.py``.  A later cell, mix or metric is a new file
found by its name: nothing here names one.

The window arithmetic (a rate over the whole window, a percentile over
all samples, the device's busy union and idle share) is here, so the
tests can hold it at hand-worked values.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: top-level module names that must not be loaded by a run: JAX, its
#: libraries, and the JAX package of this repository
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: host calls that launch a kernel, and those that wait for the device
LAUNCH_MARK = "LaunchKernel"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
#: one host thread for PyTorch's and the BLAS libraries' own pools: the
#: program's host path is one Python thread, and spare pool threads only
#: compete with it for the host's cores
THREAD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
#: entries of each list of the optional ``breakdown``
BREAKDOWN_TOP = 10


# ---------------------------------------------------------------------------
# files and the environment
# ---------------------------------------------------------------------------
def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def cache_env(root: Path) -> Dict[str, str]:
    """Fixed cache directories inside the checkout, for every compiler
    the program or PyTorch could call (the port's own kernels build under
    ``src/repro_torch/kernels/build/``, also inside the checkout)."""
    out = root / "bench" / "out" / "cache"
    return {
        "TRITON_CACHE_DIR": str(out / "triton"),
        "TORCH_EXTENSIONS_DIR": str(out / "torch_extensions"),
        "CUDA_CACHE_PATH": str(out / "nv"),
        "TORCHINDUCTOR_CACHE_DIR": str(out / "inductor"),
        "USE_FLAX": "0",
    }


def host_state() -> str:
    """The host's load average and mean core clock, for the log."""
    with open("/proc/loadavg") as f:
        load = " ".join(f.read().split()[:3])
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(l.split(":")[1]) for l in f if l.startswith("cpu MHz")]
        clock = f"{sum(mhz) / len(mhz):.0f} MHz over {len(mhz)} cores"
    except (OSError, ValueError, ZeroDivisionError):
        clock = "clock unknown"
    return f"load {load}, {clock}, {len(os.sched_getaffinity(0))} cores for this process"


def log(msg: str) -> None:
    """A progress line on standard error, with the process's age."""
    print(f"[bench {process_age_s():8.2f}s] {msg}", file=sys.stderr, flush=True)


def forbidden_loaded(modules: Sequence[str]) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


# ---------------------------------------------------------------------------
# the configuration as the port runs it
# ---------------------------------------------------------------------------
def as_run(cfgj: Dict[str, Any]) -> Dict[str, Any]:
    """The configuration file's published keys with the port's
    ``departures`` applied: each departure's ``runs`` value in place of the
    published one, which is what the program computes and the reference
    follows.  ``reduced`` names cuts of scale and is applied in the file."""
    out = dict(cfgj)
    out.update({k: d["runs"] for k, d in cfgj.get("departures", {}).items()})
    return out


def model_config(cfgj: Dict[str, Any]):
    """The port's ``ModelConfig`` for a configuration as run
    (:func:`as_run`), checked key by key (its reference module's
    ``PORT_WIDTHS``) against it."""
    from bench.reference import module
    from repro_torch.configs import get_config, get_smoke_config

    port = cfgj["port"]
    get = get_smoke_config if port.get("smoke") else get_config
    cfg = get(port["arch"]).with_(**port.get("overrides", {}))
    if cfg.dtype != cfgj["dtype"]:
        raise ValueError(f"{cfgj['name']}: the port computes in {cfg.dtype}, "
                         f"the file states {cfgj['dtype']}")
    for key, attr in module(cfgj["reference"]).PORT_WIDTHS:
        val = cfg
        for part in attr.split("."):
            val = getattr(val, part)
        if float(val) != float(cfgj[key]):
            raise ValueError(f"{cfgj['name']}: {key} is {cfgj[key]} in the file, "
                             f"{val} in the port ({attr})")
    return cfg


# ---------------------------------------------------------------------------
# window arithmetic
# ---------------------------------------------------------------------------
def rate(count: float, seconds: float) -> float:
    """A count over the whole window's seconds."""
    if seconds <= 0:
        raise ValueError("a window of no time has no rate")
    return count / seconds


def percentile(values: Sequence[float], q: int) -> float:
    """The ``q``-th percentile of every value (linear between order
    statistics, as ``statistics.quantiles(method="inclusive")``)."""
    if not values:
        raise ValueError("no values")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as disjoint sorted ones."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_in(intervals: Sequence[Tuple[float, float]], t0: float, t1: float) -> float:
    """Length of the union of ``intervals`` inside ``[t0, t1]``."""
    return sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in merge(intervals))


def idle_share(intervals: Sequence[Tuple[float, float]], t0: float, t1: float) -> float:
    """Share (0..1) of ``[t0, t1]`` in which no interval is open."""
    return 1.0 - busy_in(intervals, t0, t1) / (t1 - t0)


def gaps_in(intervals: Sequence[Tuple[float, float]], t0: float,
            t1: float) -> List[Tuple[float, float]]:
    """The idle stretches of ``[t0, t1]`` between the merged intervals."""
    out, at = [], t0
    for a, b in merge(intervals):
        if b <= t0 or a >= t1:
            continue
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < t1:
        out.append((at, t1))
    return out


# ---------------------------------------------------------------------------
# what a driver hands back
# ---------------------------------------------------------------------------
@dataclass
class Trace:
    """One profiled sub-window, reduced to what the readers need (times
    in seconds on the profiler's clock)."""

    t0: float
    t1: float
    steps: int
    kernels: List[Tuple[str, float, float]]
    launches: int
    syncs: int
    host_ops: List[Tuple[str, float, float]]
    attn_calls: List[Tuple[str, Dict[str, Any]]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return busy_in([(a, b) for _, a, b in self.kernels], self.t0, self.t1)


@dataclass
class Record:
    """A driver's run: the end-to-end values it measured, the window's
    raw data the per-layer readers reduce, and the finished requests the
    judge compares."""

    e2e: Dict[str, float]
    setup_s: float
    attempted: int
    failed: int
    window_s: float
    samples: List[Tuple[List[int], List[int]]]
    data: Dict[str, Any] = field(default_factory=dict)
    checks: List[Tuple[str, float, float]] = field(default_factory=list)
    trace: Optional[Trace] = None
    memory_peak_bytes: int = 0
    fingerprint: Dict[str, Any] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# the profiled sub-window
# ---------------------------------------------------------------------------
class Profiler:
    """``torch.profiler`` over a short sub-window that follows the measured
    window.  The profiler's first session in a process takes 11-13 s to
    start on the card (CUDA tracing's set-up), and once one has run, every
    later launch of the process is slower (a traced window ran its steps
    20-30 % slower after a session in set-up); so nothing of it runs
    before the window closes.  The drivers then run one empty session
    (``warm``), go on with the same traffic until it is steady again, and
    trace a few seconds of it: ``start`` and ``begin`` .. ``stop``."""

    def __init__(self, device) -> None:
        self.device = device
        self.prof = None
        self.marker = None
        self.steps = 0
        self.start_s = self.stop_s = 0.0

    def _activities(self):
        import torch
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        return acts

    def warm(self) -> None:
        from torch.profiler import profile

        t = time.perf_counter()
        with profile(activities=self._activities()):
            pass
        log(f"profiler warmed in {time.perf_counter() - t:.2f} s")

    def start(self) -> None:
        from torch.profiler import profile

        self.prof = profile(activities=self._activities())
        t = time.perf_counter()
        self.prof.start()
        self.start_s = time.perf_counter() - t

    def begin(self) -> None:
        import torch

        self.marker = torch.profiler.record_function("bench::subwindow")
        self.marker.__enter__()

    @property
    def on(self) -> bool:
        return self.marker is not None

    def stop(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.marker.__exit__(None, None, None)
        self.marker = None
        t = time.perf_counter()
        self.prof.stop()
        self.stop_s = time.perf_counter() - t

    def reduce(self, attn_calls) -> Trace:
        """The sub-window's kernels, host launches and syncs, and host ops,
        from the profiler's raw events (building its ``FunctionEvent``
        tree takes ~50x longer)."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        kernels, host, launches, syncs = [], [], 0, 0
        t0 = t1 = main = None
        events = self.prof.profiler.kineto_results.events()
        log(f"trace: {len(events)} raw events")
        for e in events:
            name = e.name()
            a = e.start_ns() / 1e9
            b = a + e.duration_ns() / 1e9
            if e.device_type() == cuda:
                # user annotations mirrored on the device timeline are no work
                if not (e.is_user_annotation() or name.startswith("bench::")):
                    kernels.append((name, a, b))
                continue
            if name == "bench::subwindow":
                t0, t1, main = a, b, e.start_thread_id()
                continue
            host.append((name, a, b, e.start_thread_id()))
            if LAUNCH_MARK in name:  # cudaLaunchKernel, cuLaunchKernelEx, ...
                launches += 1
            elif name in SYNC_CALLS:
                syncs += 1
        if t0 is None:
            raise RuntimeError("the profiled sub-window lost its marker")
        log(f"trace reduced: {len(kernels)} device ops, {launches} launches, {syncs} syncs, "
            f"{self.steps} steps; the profiler's start took {self.start_s:.2f} s, "
            f"its stop {self.stop_s:.2f} s")
        host_ops = [(n, a, b) for n, a, b, th in host if th == main]
        return Trace(t0, t1, self.steps, kernels, launches, syncs, host_ops, attn_calls)


def breakdown(trace: Trace) -> Dict[str, List[List[Any]]]:
    """The device operations that took most time, and the longest idle
    stretches summed by the innermost host op running at their middle."""
    by_kernel: Dict[str, float] = {}
    for name, a, b in trace.kernels:
        by_kernel[name] = by_kernel.get(name, 0.0) + (b - a)
    ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
    gaps = gaps_in([(a, b) for _, a, b in trace.kernels], trace.t0, trace.t1)
    by_host: Dict[str, float] = {}
    events = sorted(trace.host_ops, key=lambda e: (e[1], -e[2]))
    stack: List[Tuple[str, float, float]] = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while i < len(events) and events[i][1] <= mid:
            while stack and stack[-1][2] <= events[i][1]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][0] if stack else "(no host op)"
        by_host[name] = by_host.get(name, 0.0) + (b - a)
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle]}


# ---------------------------------------------------------------------------
# per-layer readers
# ---------------------------------------------------------------------------
def reader(root: Path, name: str) -> Callable[[Record, Dict[str, Any]], Optional[float]]:
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    """The driver module ``bench/drivers/<kind>.py``."""
    return importlib.import_module(f"bench.drivers.{kind}")


# ---------------------------------------------------------------------------
# one run of one cell
# ---------------------------------------------------------------------------
@dataclass
class Cell:
    """Everything a driver needs, found by the cell's name."""

    root: Path
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    model_cfg: Any = None
    params: Any = None
    profiler: Optional[Profiler] = None


def find_cell(root: Path, bench: Dict[str, Any], workload: str,
              config_file: Optional[Path] = None,
              overrides: Optional[Dict[str, Dict]] = None) -> Tuple[Dict, Dict, Dict, Dict]:
    """The workload entry, its configuration as run, its traffic and its
    limits.  ``config_file`` replaces the configuration and ``overrides`` updates
    the traffic's and the limits' keys (the CPU tests' smoke variants)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    confs = {c["name"]: c for c in bench["configs"]}
    cfgj = as_run(load_json(config_file or root / confs[w["config"]]["file"]))
    traffic = load_json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "bench" / "cells" / f"{workload}.json")
    for part, d in (overrides or {}).items():
        {"traffic": traffic, "limits": limits}[part].update(d)
    return w, cfgj, traffic, limits


def run_cell(root: Path, bench: Dict[str, Any], workload: str, seed: int, seconds: float,
             trace: bool, device, config_file: Optional[Path] = None,
             overrides: Optional[Dict[str, Dict]] = None,
             after: Optional[Callable[[Cell, Record], None]] = None) -> Tuple[Dict[str, Any],
                                                                                  List[Tuple[str, float, float]],
                                                                  Record]:
    """Run one cell; return its result line's object, its checks and the
    driver's record.

    ``after``, when
    given, is called with the cell and the record once the run is judged,
    while the weights are still held (the control's readings).
    """
    import torch

    from bench import judge, weights
    from repro_torch.models import zoo

    w, cfgj, traffic, limits = find_cell(root, bench, workload, config_file, overrides)
    cell = Cell(root, workload, cfgj, traffic, limits, seed, seconds, trace, device)
    cell.model_cfg = model_config(cfgj)
    if trace:
        cell.profiler = Profiler(device)
    layout, _ = zoo.param_shapes(cell.model_cfg)
    cell.params = weights.make(layout, seed, cell.model_cfg.tdtype, device)
    log(f"weights made: {weights.nbytes(cell.params) / 1e9:.2f} GB; {host_state()}")
    rec: Record = driver(traffic["driver"]).run(cell)
    # the program's state is gone with the driver's frame; the weights stay
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"window closed: {len(rec.samples)} finished requests; {host_state()}; judging")
    gap = judge.judge(cell, rec.samples)
    log("judged")
    if after is not None:
        after(cell, rec)
    checks = list(rec.checks) + gap
    correct = all(v <= lim for _, v, lim in checks)
    if trace:
        names = [m["name"] for m in bench["per_layer"] if workload in m.get("workloads", [])]
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
    else:
        names = [m["name"] for m in bench["end_to_end"]
                 if workload in m.get("workloads", [workload])]
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    metrics = {}
    for name in names:
        if name == "setup_s":
            val: Optional[float] = rec.setup_s
        elif not trace:
            val = rec.e2e.get(name)
        else:
            val = reader(root, name)(rec, cfgj)
        if val is not None:
            metrics[name] = {"value": float(val), "unit": units[name]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(rec.memory_peak_bytes)}
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": int(rec.attempted),
                           "failed": int(rec.failed), "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = breakdown(rec.trace)
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out, checks, rec
