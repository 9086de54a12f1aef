"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers compared with the reference are the last lines
of standard error. Build and kernel caches stay inside the checkout.

The process keeps to the last ``HOST_CORES`` cores it may use, with one
thread in each host thread pool, so that its host work (every cell is
bound by the host's launches) lands alike from run to run.
"""

import os
import sys
import time

T_START = time.perf_counter()
HOST_CORES = 4
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-HOST_CORES:])
HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(os.path.dirname(HERE), ".bench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from benchlib import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t_start=T_START))
