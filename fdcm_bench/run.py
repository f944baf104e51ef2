"""Run one cell of the benchmark of openfdcm_tpu_torch once, on this
machine's first CUDA device, and print its result as the last line of
standard output (one JSON object).

    python3 fdcm_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without enough CUDA devices, without
the ``openfdcm_tpu_torch`` package beside this directory, or when JAX or
the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "fdcm_bench", sub)
sys.path.insert(0, ROOT)

from fdcm_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
