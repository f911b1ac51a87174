"""Build and load the port's hand-written CUDA kernels.

The sources under `streaming_vlm_tpu_torch/csrc/` are compiled by `nvcc`
for `sm_90a` into one plain-C shared library, loaded with ctypes. The build
runs at first use into `build/torch_kernels/` at the repository root (listed
in .gitignore) and is keyed by a hash of the sources, so an edited source
rebuilds and an unchanged one loads the existing library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("prefill_attention.cu", "decode_attention.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the last nvcc run, if any


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home}/bin)")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsvt_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if no library for the current sources exists.
    Returns the library path. Raises with nvcc's output when it fails."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        so.svt_prefill_attention.argtypes = [P] * 8 + [I] * 5 + [P]
        so.svt_prefill_attention.restype = I
        so.svt_decode_attention.argtypes = [P] * 9 + [I] * 7 + [P]
        so.svt_decode_attention.restype = I
        so.svt_decode_split_size.argtypes = []
        so.svt_decode_split_size.restype = I
        so.svt_decode_max_small_rows.argtypes = []
        so.svt_decode_max_small_rows.restype = I
        # compile-time constants of the decode kernel, read once
        so.decode_split_size = so.svt_decode_split_size()
        so.decode_max_small_rows = so.svt_decode_max_small_rows()
        _lib = so
    return _lib
