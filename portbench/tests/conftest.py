"""The benchmark's own tests (python -m pytest portbench/tests): they put
the repository's root on the path and import no JAX."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
