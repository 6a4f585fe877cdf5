"""The control of ``correct``: for each seed, a cell's ring of inputs made as
a run makes them, the reference in the program's place computed in the
nearest lower precision (the entry's ``reference(j, control=True)``), held
to the reference as a run holds the program.  Each number must exceed its
limit for the control to come out as not correct.

    python3 portbench/tools/control.py --cell a4-2000.photo --seeds 5 6 7 --out out/control.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def control_readings(cell_name: str, seed: int, device: torch.device, root: Path = ROOT) -> dict:
    from portbench import harness  # noqa: PLC0415

    cell = harness.find_cell(cell_name, root)
    entry = harness.plugin(cell.root, "entries", cell.mix["entry"]).Entry(cell.config, cell.mix, seed, device)
    entry.setup()
    totals: dict = {}
    for j in range(entry.ring):
        ref = entry.reference(j)
        off = entry.judge(entry.as_output(entry.reference(j, control=True)), ref)
        for name, v in off.items():
            totals[name] = totals.get(name, 0) + v
    return totals


def main(argv=None) -> int:
    sys.path[0] = str(ROOT)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for seed in args.seeds:
            t0 = time.perf_counter()
            off = control_readings(args.cell, seed, device)
            line = {"cell": args.cell, "seed": seed, "control": off, "seconds": time.perf_counter() - t0,
                    "device": str(device)}
            f.write(json.dumps(line) + "\n")
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
