"""Build and load the CUDA kernels of `pcfa_tpu_torch/csrc/`.

Each `csrc/<name>.cu` compiles with one `nvcc` call into its own shared
library with a plain C interface, loaded with `ctypes` (no PyTorch headers,
so a build takes seconds rather than minutes). Libraries go to
`pcfa_tpu_torch/_build/` (listed in `.gitignore`), named by a hash of the
source and the flags, so an unchanged source is built once per checkout.
`build()` starts one `nvcc` per missing source, all at once.

A failed build raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("corr_lookup", "small_conv", "local_corr", "segsum",
           "lbfgs_hist")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "pcfa_tpu_torch: nvcc not found (looked in "
            f"{cand} and on PATH); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every missing library among `names` in parallel.

    Returns {name: seconds} for the libraries built by this call. The
    compiler's output (ptxas register and spill report) is kept beside
    each library as `<library>.log`."""
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    times, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Load (building first if needed) `csrc/<name>.cu`, with `argtypes`
    set from `signatures` and every entry returning a cudaError_t int."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"pcfa_tpu_torch: {what} failed with "
                           f"cudaError {err}")
