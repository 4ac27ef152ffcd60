"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout; see portbench/lib/harness.py.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the transformers package, where present, loads flax unless told not to
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
