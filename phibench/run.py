"""Run one cell of the benchmark once and print its result line.

    python3 phibench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the program is ``src/repro_torch``, and
its kernel build, and every cache the run may write, stay under ``build/``
there, at fixed paths.
"""
import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "phibench")


def main() -> int:
    if not os.path.isfile(os.path.join(ROOT, "src", "repro_torch", "__init__.py")):
        print("phibench: no program here (src/repro_torch is missing)", file=sys.stderr)
        return 2
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from phibench import harness

    return harness.main(sys.argv[1:], T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
