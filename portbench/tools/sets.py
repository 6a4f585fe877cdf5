"""Run cells of BENCHMARK.json several times, one process a run, and report
each metric's median and spread (the distance between the first and third
quartiles of ``statistics.quantiles(values, n=4)`` over the median).

    python3 portbench/tools/sets.py --cells a4-2000.photo --seeds 11 12 13 \\
        --seconds 10 --trace 0 --out out/sets.jsonl

Each run's result line, exit code, wall seconds and the end of its standard
error go to ``--out`` as one JSON line.  A set's runs take the seeds in turn;
``--sets 2`` runs the same seeds again as a second set."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def run_once(cell: str, seed: int, seconds: float, trace: int, timeout: float) -> dict:
    t0 = time.perf_counter()
    cmd = [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
    lines = out.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if rc == 0 and lines else None
    except json.JSONDecodeError:
        result = None
    return {"cell": cell, "seed": seed, "trace": trace, "seconds": seconds, "rc": rc, "wall_s": time.perf_counter() - t0,
            "result": result, "stderr_tail": err[-3000:]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", nargs="+", required=True)
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    with open(out, "a") as f:
        for cell in args.cells:
            for s in range(args.sets):
                for seed in args.seeds:
                    r = run_once(cell, seed, args.seconds, args.trace, args.timeout)
                    r["set"] = s
                    runs.append(r)
                    f.write(json.dumps(r) + "\n")
                    f.flush()
                    res = r["result"] or {}
                    print(f"{cell} set {s} seed {seed}: rc {r['rc']}, {r['wall_s']:.1f} s, correct "
                          f"{res.get('correct')}, " + ", ".join(f"{k} {v['value']:.6g}" for k, v in
                                                                 res.get("metrics", {}).items())
                          + (f", checks {res.get('checks')}" if res else f"\n  {r['stderr_tail'][-1500:]}"), flush=True)
    for cell in args.cells:
        for s in range(args.sets):
            ok = [r["result"] for r in runs if r["cell"] == cell and r["set"] == s and r["result"]]
            for name in sorted({m for res in ok for m in res["metrics"]}):
                vals = [res["metrics"][name]["value"] for res in ok if name in res["metrics"]]
                if len(vals) >= 2:
                    print(f"{cell} set {s} {name}: median {statistics.median(vals):.6g}, spread "
                          f"{spread(vals) * 100:.3f} %, values {vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
