"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``, ``portbench/``
and the port (``dcos_commons_tpu_torch``).  The last line of standard
output is the result object; the numbers that decide ``correct`` are
the last lines of standard error.  Exits 2 without a result when the
cell's CUDA cards are not there, 3 when a module of JAX or of the JAX
package was loaded.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed places inside the checkout: only a
# checkout's first run builds (the port's own kernels build into
# build/kernels/ there too)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "portbench",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "portbench",
                                              "triton")
sys.path.insert(0, ROOT)

from portbench.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
