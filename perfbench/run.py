"""Entry point of the benchmark (see ``perfbench/harness.py``):

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It exits with a code other than 0, and
prints no result, where there is no CUDA card or fewer than the cell asks
for, where the program is missing, or where JAX was loaded."""

import os
import sys

if __name__ == "__main__":
    # The checkout's root, not this folder, heads the import path, so that
    # the folders here cannot shadow other modules.
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.getcwd())
    from perfbench.harness import main

    sys.exit(main())
