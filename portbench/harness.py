"""One run of one cell: set-up, the measured window, the check against the
reference, and the metrics, printed as one JSON line.

The window dispatches the entry's calls back to back over a ring of inputs
made from the seed, at most ``in_flight`` calls on the device at once (each
call waits on the completion event of the call ``in_flight`` before it), for
``--seconds`` seconds; it ends when the last call dispatched in it has
completed.  A sample of the calls, drawn from the seed, keeps its outputs;
once the window has closed and the memory peak has been read, the reference
works out each ring input's outputs again and every number compared is
printed beside its limit.

With ``--trace 1`` the window runs under ``torch.profiler`` (device activity
only) and the per-layer metrics are read from its trace, the program's
launch counters and the benchmark's own host spans; otherwise the cell's
end-to-end metrics are reported.
"""

from __future__ import annotations

import bisect
import collections
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "plotweave")  # top-level module names the run must not hold
PRIMER_BYTES = 1 << 20  # an upload before a traced window: the trace may lose the first device work it sees
PRIMER_PAUSE = 0.05  # seconds between it and the window
PRIMER_GAP_NS = 20_000_000  # a gap this long among the first device operations ends the primer's part
BREAKDOWN = 10


def fail(msg: str, code: int = 1):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


_plugins: dict = {}


def plugin(root: Path, kind: str, name: str):
    """``<root>/portbench/<kind>/<name>.py``, imported by its path."""
    path = Path(root) / "portbench" / kind / f"{name}.py"
    if path not in _plugins:
        if not path.is_file():
            fail(f"no {kind[:-1] if kind.endswith('s') else kind} {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{len(_plugins)}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _plugins[path] = module
    return _plugins[path]


@dataclass
class Cell:
    name: str
    root: Path
    config: dict
    mix: dict
    chips: int
    end_to_end: list
    per_layer: list


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its configuration,
    traffic mix and metrics."""
    bench = load_json(Path(root) / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        fail(f"BENCHMARK.json has no workload {name!r}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m["workloads"] or ("workloads" not in m and m["moves"] in reported)]
    return Cell(name, Path(root), load_json(Path(root) / conf["file"]),
                load_json(Path(root) / "portbench" / "traffic" / f"{cell['traffic']}.json"), int(cell["chips"]),
                e2e, per_layer)


class _HostMark:
    """The completion mark of a call on the CPU, where calls are synchronous."""

    def record(self):
        pass

    def synchronize(self):
        pass


class Sample:
    """A uniform sample of ``size`` calls' outputs, drawn from the seed
    (Algorithm R): which calls it keeps depends on the seed and on how many
    calls the window made."""

    def __init__(self, size: int, seed: int):
        self.size, self.items = size, []
        self.rng = np.random.default_rng([seed, 1])

    def offer(self, i: int, out) -> None:
        if len(self.items) < self.size:
            self.items.append((i, out))
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.size:
            self.items[j] = (i, out)


@dataclass
class Window:
    calls: int = 0
    seconds: float = 0.0  # from the first dispatch to the completion of the last call dispatched
    host_s: list = field(default_factory=list)  # seconds inside the entry's call, each call
    launches: dict = field(default_factory=dict)  # the program's launch counters over the window


def _launch_counts() -> dict:
    from plotweave_torch.ops import kernels  # noqa: PLC0415

    return dict(kernels.LAUNCHES)


def _built() -> list:
    """The kernel libraries that this process built (the rest it loaded from
    the checkout's build cache)."""
    from plotweave_torch.ops import kernels  # noqa: PLC0415

    return sorted(kernels.build_log)


def drive(entry, seconds: float | None, calls: int | None, depth: int, sample: Sample | None) -> Window:
    """Dispatch ``entry``'s calls for ``seconds`` (or ``calls`` calls), at
    most ``depth`` in flight."""
    cuda = entry.device.type == "cuda"
    marks = [torch.cuda.Event() if cuda else _HostMark() for _ in range(depth + 1)]
    pending: collections.deque = collections.deque()
    win = Window()
    before = _launch_counts()
    ring = entry.ring
    start = time.perf_counter()
    i = 0
    while (time.perf_counter() - start < seconds) if calls is None else i < calls:
        if len(pending) >= depth:
            pending.popleft().synchronize()
        t0 = time.perf_counter()
        out = entry.call(i % ring)
        win.host_s.append(time.perf_counter() - t0)
        mark = marks[i % len(marks)]
        mark.record()
        pending.append(mark)
        if sample is not None:
            sample.offer(i, out)
        i += 1
    while pending:
        pending.popleft().synchronize()
    win.seconds = time.perf_counter() - start
    win.calls = i
    after = _launch_counts()
    win.launches = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    return win


@dataclass
class Trace:
    """The device's side of a traced window."""
    window_s: float
    busy_s: float
    ops: dict  # device operation name → [seconds, count]
    gaps: dict  # what the host was doing → idle seconds

    def seconds(self, parts) -> tuple:
        """(seconds, count) of the device operations whose name holds one of ``parts``."""
        s = n = 0
        for name, (sec, cnt) in self.ops.items():
            if any(p in name for p in parts):
                s, n = s + sec, n + cnt
        return s, n


def start_trace(device: torch.device):
    """A profiler started over the device's activity (the host's on a CPU run)."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    prof = profile(activities=[ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU])
    prof.prepare_trace()
    prof.start_trace()
    return prof


def stop_trace(prof) -> list:
    """Stops the profiler: (name, on the device, start ns, end ns) of every
    event, read from the profiler's results without building its tree of
    Python events, which takes tens of seconds for a window's events."""
    import torch.autograd.profiler as autograd_profiler  # noqa: PLC0415
    from torch.autograd import DeviceType  # noqa: PLC0415

    try:
        events = autograd_profiler._disable_profiler().events()
    except (AttributeError, RuntimeError):
        prof.stop_trace()
        events = prof.profiler.kineto_results.events()
    out = []
    for e in events:
        start = e.start_ns()
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start, start + e.duration_ns()))
    return out


def summarize(events) -> Trace | None:
    """A :class:`Trace` from (name, on the device, start ns, end ns) events:
    the window is the device's operations after the primer's (the operations
    before the first pause of ``PRIMER_GAP_NS`` among the first three), from
    the first one's start to the last one's end; an idle gap is labelled by
    the runtime call the host was in at its middle."""
    device = sorted((e for e in events if e[1]), key=lambda e: e[2])
    for j in range(min(3, len(device) - 1)):
        if device[j + 1][2] - max(e[3] for e in device[: j + 1]) > PRIMER_GAP_NS:
            device = device[j + 1 :]
            break
    if not device:
        return None
    host = sorted((e for e in events if not e[1] and e[0].startswith("cuda")), key=lambda e: e[2])
    host_starts = [e[2] for e in host]
    ops: dict = {}
    busy = 0
    gaps: dict = collections.defaultdict(float)
    cur_start, cur_end = device[0][2], device[0][3]
    for name, _, start, end in device:
        ops.setdefault(name, [0.0, 0])
        ops[name][0] += (end - start) / 1e9
        ops[name][1] += 1
        if start > cur_end:
            busy += cur_end - cur_start
            mid = (cur_end + start) // 2
            k = bisect.bisect_right(host_starts, mid) - 1
            label = host[k][0] if k >= 0 and host[k][3] >= mid else "host, in no CUDA call"
            gaps[label] += (start - cur_end) / 1e9
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return Trace((cur_end - device[0][2]) / 1e9, busy / 1e9, ops, dict(gaps))


class Run:
    """What a metric's reader reads: the cell, the window, its trace, and the
    work of each ring input as the reference counted it."""

    def __init__(self, cell: Cell, window: Window, setup_s: float, trace: Trace | None, works: list, ring: int,
                 mpx_per_call: float):
        self.cell, self.window, self.setup_s, self.trace = cell, window, setup_s, trace
        self.works, self.ring, self.mpx_per_call = works, ring, mpx_per_call

    def kernel_seconds(self, module):
        """The traced device seconds of a kernel over the window, scaled up
        where the trace shows fewer launches than the program's counters
        made; None where it shows none."""
        if self.trace is None:
            return None
        sec, seen = self.trace.seconds(module.TRACE)
        made = sum(self.window.launches.get(c, 0) for c in module.COUNTERS)
        if seen == 0 or made == 0:
            return None
        if seen != made:
            print(f"portbench: the trace shows {seen} launches of {module.TRACE} and the program counted {made}",
                  file=sys.stderr)
        return sec * max(1.0, made / seen)

    def bound_seconds(self, module) -> float:
        """The kernel's least seconds over every call of the window."""
        from portbench.roofline import bound_s  # noqa: PLC0415

        per = [bound_s(*module.work(w)) for w in self.works]
        full, rest = divmod(self.window.calls, self.ring)
        return full * sum(per) + sum(per[:rest])


def roofline_share(run: Run, kernel: str):
    """A kernel's share of its roofline, in %: its least time over its traced
    time, summed over the window's calls; None where the trace has none."""
    module = plugin(run.cell.root, "roofline", kernel)
    traced = run.kernel_seconds(module)
    return None if traced is None else 100.0 * run.bound_seconds(module) / traced


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float) -> dict:
    """One run; returns the result's object (``checks`` last)."""
    seed %= 1 << 64  # numpy's seed sequences take non-negative integers
    entry = plugin(cell.root, "entries", cell.mix["entry"]).Entry(cell.config, cell.mix, seed, device)
    t_entry = time.perf_counter()
    entry.setup()
    t_inputs = time.perf_counter()
    depth = int(cell.mix["in_flight"])
    sample_size = int(cell.mix["sample_calls"])
    # every shape and the allocator's blocks of the window: the ring twice, and as many outputs kept
    warm = Sample(sample_size, seed)
    drive(entry, None, 2 * entry.ring + sample_size + depth, depth, warm)
    del warm
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_warm = time.perf_counter()
    print(f"portbench: set-up: start and imports {t_entry - t0:.3f} s, inputs {t_inputs - t_entry:.3f} s, warm-up "
          f"{t_warm - t_inputs:.3f} s", file=sys.stderr)
    prof = None
    if trace:
        prof = start_trace(device)
        torch.zeros(PRIMER_BYTES, dtype=torch.uint8).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        time.sleep(PRIMER_PAUSE)
    setup_s = time.perf_counter() - t0
    sample = Sample(sample_size, seed)
    window = drive(entry, seconds, None, depth, sample)
    t_window = time.perf_counter()
    events = stop_trace(prof) if prof is not None else None
    banned = banned_modules()
    if banned:
        fail(f"the process holds {banned} after the window", 3)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    trace_summary = summarize(events) if events is not None else None
    del prof, events
    t_trace = time.perf_counter()
    checks, failed, works = entry.check(sample.items)
    del sample
    t_check = time.perf_counter()
    print(f"portbench: set-up {setup_s:.3f} s, window {window.seconds:.3f} s ({window.calls} calls), trace read in "
          f"{t_trace - t_window:.3f} s, reference and check {t_check - t_trace:.3f} s", file=sys.stderr)
    run = Run(cell, window, setup_s, trace_summary, works, entry.ring, entry.mpx_per_call)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = plugin(cell.root, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for v, lim in checks.values()) and failed == 0,
              "attempted": window.calls, "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        t = trace_summary
        dev["busy_s"] = t.busy_s if t else 0.0
        dev["window_s"] = t.window_s if t else window.seconds
        if t:
            top = sorted(t.ops.items(), key=lambda kv: -kv[1][0])[:BREAKDOWN]
            result["breakdown"] = {"device_ops": [[name[:120], sec] for name, (sec, _) in top],
                                   "idle_gaps": sorted(([k, v] for k, v in t.gaps.items()),
                                                       key=lambda kv: -kv[1])[:BREAKDOWN]}
    result["built"] = _built()  # set-up built these libraries: only a checkout's first run does
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result


def main(argv, t0: float) -> int:
    import argparse  # noqa: PLC0415

    p = argparse.ArgumentParser(prog="portbench/run.py", description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = find_cell(args.workload)
    t_imports = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 2)
    torch.cuda.init()
    print(f"portbench: start and imports {t_imports - t0:.3f} s, the card's start {time.perf_counter() - t_imports:.3f} s",
          file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t0)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
