"""Entry point: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.

The program's build directory (``mixlab_tpu_torch/_build/``) is inside the
checkout; the caches PyTorch and Triton would write go to fixed directories
inside it too, before torch is imported."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE = Path(__file__).resolve().parents[1] / ".portbench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
