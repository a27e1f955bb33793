#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``ompi_tpu_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout and
prints the result as the last line of standard output (one JSON
object); ``--cpu`` rehearses a cell on the CPU at a small size.  See
``portbench/harness.py``.
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from portbench import harness
    t_start = harness.process_start_perf()
    sys.exit(harness.main(sys.argv[1:], t_start))
