"""The benchmark of the PyTorch/CUDA port (nextpolish_tpu_torch): one run
of one cell.

    python3 npbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds BENCHMARK.json, npbench/ and
the port.  See npbench/harness.py for what a run does.
"""
import time

T0 = time.perf_counter()  # set-up counts from here

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from npbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t0=T0))
