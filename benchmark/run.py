"""Run one cell of the benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs as many CUDA devices as the cell
asks for and exits with a nonzero code, printing no result, without them.
Build and kernel caches stay inside the checkout: the port's kernels in
`faithdiff_tpu_torch/_build/` (where the program puts them), Triton's,
PyTorch extensions' and the CUDA JIT's under `benchmark/.cache/`.
"""
import os
import sys
import time


def _process_start() -> float:
    """The process's start as a Unix time, from /proc where it exists."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


if __name__ == "__main__":
    t_start = _process_start()
    bench = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(bench, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, bench)
    sys.path.insert(1, os.path.dirname(bench))
    import harness

    sys.exit(harness.main(sys.argv[1:], t_start=t_start))
