"""A control reading of a cell's comparison (not run by the benchmark's
own runs): the plain reference one precision below the configuration's
in the program's place, at the cell's own sizes.

    python3 portbench/control.py --workload <cell> --seed <n>
"""
import os
import sys

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.lib.harness import control_main  # noqa: E402

if __name__ == "__main__":
    sys.exit(control_main())
