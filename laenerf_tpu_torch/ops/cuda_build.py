"""Build and load the port's hand-written CUDA kernels.

Each `csrc/*.cu` file has a plain C interface. On first use it is compiled by
`nvcc` for Hopper (`sm_90a`) into a shared library under `_build/` (listed in
`.gitignore`), keyed by a hash of the source and the flags, and loaded with
`ctypes`. Nothing here runs at import time: CPU-only installs without `nvcc`
import the package and never build.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS = {}
# per source: seconds spent building (0.0 when the library was cached) and
# the compiler's -Xptxas=-v report (registers, shared memory, spills)
build_info = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME or put nvcc on PATH)")
    return found


def load_library(source: str) -> ctypes.CDLL:
    """Compile (once per source hash) and load csrc/<source>."""
    if source in _LIBS:
        return _LIBS[source]
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{src.stem}-{digest}.so"
    t0 = time.perf_counter()
    report = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {source} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        report = proc.stdout + proc.stderr
        # atomic: a concurrent process never loads a half-written library
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    build_info[source] = {"seconds": time.perf_counter() - t0,
                          "ptxas": report, "path": str(so)}
    _LIBS[source] = lib
    return lib
