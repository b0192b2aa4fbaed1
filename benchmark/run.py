"""Entry point of the benchmark: `python3 benchmark/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>`, from the root of a checkout."""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# One process with one compute thread, held to two cores of its own before
# any thread starts: dispatch to the card is one host thread, and its
# host-bound times read steadier when it does not migrate between cores.
os.environ["OMP_NUM_THREADS"] = "1"
os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])
# Import from the checkout's root (the script's own folder would otherwise
# come first on the path), and keep every compiler cache inside it, at a
# fixed place, so that only a checkout's first run builds.
sys.path[0] = str(ROOT)
CACHE = ROOT / "build" / "cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
