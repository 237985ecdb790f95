"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/*.cu`` has a plain C interface (no PyTorch headers), so nvcc
compiles it in seconds. The sources are compiled in parallel, one nvcc
process each, linked into one shared library under ``build/repro_torch/`` at
the repository root, and loaded on first use. The library's file name
carries a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is reused. A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("phi_fused.cu", "lif.cu", "phi_attention.cu", "matcher.cu", "phi_gather.cu",
           "phi_spmm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    "phi_fused_launch": [_P, _P, _P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, _P],
    "phi_fused_stream_launch": [_P, _P, _P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_longlong,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    "phi_fused_stream_smem_bytes": [ctypes.c_int] * 3,
    "phi_fused_prefetch_launch": [_P, _P, _P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P],
    "lif_step_launch": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                        ctypes.c_int, _P],
    "lif_sequence_launch": [_P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                            ctypes.c_float, ctypes.c_int, _P],
    "phi_attention_launch": [_P] * 7 + [ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_int, _P],
    "phi_attention_smem_bytes": [ctypes.c_int] * 6,
    "phi_attention_occupancy": [ctypes.c_int] * 6,
    "phi_fused_occupancy": [ctypes.c_int] * 6,
    "phi_fused_smem_bytes": [ctypes.c_int],
    "matcher_launch": [_P, _P, _P, _P, ctypes.c_longlong] + [ctypes.c_int] * 4 + [_P],
    "matcher_plan": [ctypes.c_int] * 3 + [_P],
    "l1_gather_launch": [_P, _P, ctypes.c_int, _P, _P, ctypes.c_longlong] + [ctypes.c_int] * 4
                        + [_P],
    "l2_spmm_launch": [_P] * 5 + [ctypes.c_int] * 6 + [_P],
    "repro_cuda_error_string": [ctypes.c_int],
}
# Return types other than the launch functions' CUDA error code.
_RESTYPES = {"phi_attention_smem_bytes": ctypes.c_longlong,
             "phi_fused_smem_bytes": ctypes.c_longlong,
             "phi_fused_stream_smem_bytes": ctypes.c_longlong,
             "repro_cuda_error_string": ctypes.c_char_p}

_lib: ctypes.CDLL | None = None
# What the last build did: seconds (0 when the library was reused) and ptxas's
# resource lines, kept beside the library.
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build "
                           "the repro_torch CUDA kernels")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (name + ".o") for name in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for name, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        for name, proc, log in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name} (exit {proc.returncode}):\n{log}")
        lib_tmp = Path(tmp) / target.name
        link = subprocess.run([nvcc, "-shared", *(str(o) for o in objs), "-o", str(lib_tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n{link.stdout}")
        os.replace(lib_tmp, target)
    ptxas = [line.strip() for log in logs for line in log.splitlines()
             if "Used" in line or "Compiling entry" in line or "spill" in line]
    target.with_suffix(".ptxas").write_text("\n".join(ptxas))
    build_info.update(seconds=time.perf_counter() - t0, ptxas=ptxas)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from the sources on first use."""
    global _lib
    if _lib is None:
        target = BUILD_DIR / f"librepro_torch_{_digest()}.so"
        if not target.exists():
            _build(target)
        else:                     # built earlier: its registers, spills, shared memory
            log = target.with_suffix(".ptxas")
            build_info.update(seconds=0.0, ptxas=log.read_text().splitlines()
                              if log.exists() else [])
        _lib = load(target)
    return _lib


def load(path: Path, *, partial: bool = False) -> ctypes.CDLL:
    """Load a built library and declare its functions' C signatures.
    ``partial``: a library built from only some of the sources; the
    functions it lacks are skipped."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None) if partial else getattr(lib, name)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
