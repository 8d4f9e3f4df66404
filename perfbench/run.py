"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA devices as the
cell asks for; without them it exits with code 2 and prints no result. The
last line of the standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its limit,
which also end the standard error).
"""

import time

T0 = time.perf_counter()  # set-up counts from here: imports, inputs, builds, captures

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# build and kernel caches at fixed paths inside the checkout (the program's
# own kernels build into build/lvae_torch/, fixed by lvae_torch itself)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "perfbench", sub)

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
