"""Run one cell of BENCHMARK.json once on this machine's card and print the
result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout.  It fails, printing no result, where
torch sees no CUDA card (or fewer than the cell asks for).  The program's
kernels are built into its checkout (``plotweave_torch/_build/``) by the
first run there and loaded by every later one."""

import os
import sys
import time

T0 = time.perf_counter()

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root  # the checkout's root, not this folder
    # a library the port loads must not load JAX by itself
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T0))
