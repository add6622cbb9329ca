"""Run one cell of the benchmark once and print its result line.

    python perfbench/run.py --workload exact-b1 --seed 12345 --seconds 51 --trace 0

Run from the root of a checkout on a machine with an NVIDIA card; see
``perfbench/README.md``.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT          # the checkout's root, not this directory: its names are no top-level modules

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
