"""Build and load the port's hand-written CUDA kernels.

Each `csrc/*.cu` file has a plain C interface. On first use it is compiled by
`nvcc` for Hopper (`sm_90a`) into a shared library under `_build/` (listed in
`.gitignore`), keyed by a hash of the source and the flags, and loaded with
`ctypes`; the key also covers the shared headers `csrc/*.cuh`. `launch` calls
one entry point on the current stream; `on_cpu` sends a wrapper's CPU tensors
to its plain version; `check_int32` checks an index argument. Nothing here runs at
import time: CPU-only installs without `nvcc` import the package and never
build.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# ctypes argument types of the entry points' plain C interface
P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_LIBS = {}
_FNS = {}  # (source, entry point) -> ctypes function, argtypes set once
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
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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


def launch(source: str, fn_name: str, argtypes, *args):
    """Call entry point `fn_name` of csrc/<source> with `args` and the
    current CUDA stream of the first tensor's device.

    Tensors pass as their data pointers, other args as they are; `argtypes`
    lists one ctypes type per arg (the stream is appended). Every entry point
    returns cudaGetLastError() after its launch; a nonzero code raises.
    """
    key = (source, fn_name)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(load_library(source), fn_name)
        fn.argtypes = list(argtypes) + [P]
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed (cudaError {err})")


def on_cpu(name: str, *tensors) -> bool:
    """True for CPU tensors (the wrapper runs its plain version); for CUDA
    tensors checks that they share the card and are contiguous; raises on
    any other device."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel needs contiguous tensors")
    return False


def check_int32(name: str, t, n: int = 0):
    """Raises unless t is a 1-D int32 tensor with at least n entries."""
    if t.dim() != 1 or t.dtype != torch.int32:
        raise TypeError(f"{name} must be a 1-D int32 tensor, got {t.dtype} "
                        f"{tuple(t.shape)}")
    if t.shape[0] < n:
        raise ValueError(f"{name} needs >= {n} entries, has {t.shape[0]}")
