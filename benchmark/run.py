"""Runs one cell of the benchmark on the card and prints its result as the last line of standard
output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python -m benchmark.run ...``) from the root of a checkout. See ``benchmark/README.md``.
"""
import time

T0 = time.perf_counter()  # set-up is timed from here: imports, build, weights, inputs, warm-up

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, never this folder, leads the path: no module here shadows the stdlib
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
