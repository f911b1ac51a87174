"""Build and load the port's hand-written CUDA kernels.

The sources under `streaming_vlm_tpu_torch/csrc/` are compiled by `nvcc`
for `sm_90a` into one plain-C shared library, loaded with ctypes. The build
runs at first use into `build/torch_kernels/` at the repository root (listed
in .gitignore) and is keyed by a hash of the sources and headers, so an
edited source rebuilds and an unchanged one loads the existing library.
Each source compiles in its own nvcc process, all started together, and one
more nvcc call links the objects. The objects are kept in `obj/` there,
each keyed by its source, the headers and the flags, so a build after an
edit recompiles only the sources whose key changed (a copy of the tree
seeded with these objects compiles only what it changed).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (
    "prefill_attention.cu", "decode_attention.cu", "decode_attention_raw.cu", "int8_gemm.cu",
    "int4_gemv.cu", "verify_attention.cu", "attention_bwd.cu", "linear_ce.cu",
)
HEADERS = ("decode_common.cuh", "hopper.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
OBJ_DIR = BUILD_DIR / "obj"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the last nvcc build, if any


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home}/bin)")
    return found


def library_path() -> Path:
    return BUILD_DIR / f"libsvt_torch_kernels_{_key(*SOURCES, *HEADERS)}.so"


def _run(cmds):
    """Run nvcc commands in parallel; raise with the output of any that
    failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs) if p.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"({rc}) {' '.join(c)}\n{o}" for c, rc, o in failed))


def _key(*names: str) -> str:
    h = hashlib.sha256()
    for name in names:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def object_path(source: str) -> Path:
    """The compiled object of one source, keyed by it, the headers (any
    source may include them) and the flags."""
    return OBJ_DIR / f"{Path(source).stem}_{_key(source, *HEADERS)}.o"


def build() -> Path:
    """Compile the kernels if no library for the current sources exists:
    the sources whose object is missing, then the link. Returns the library
    path. Raises with nvcc's output when it fails."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    OBJ_DIR.mkdir(parents=True, exist_ok=True)
    objs = [object_path(s) for s in SOURCES]
    todo = [(s, o) for s, o in zip(SOURCES, objs) if not o.exists()]
    tmps = [o.with_suffix(f".{os.getpid()}.tmp.o") for _, o in todo]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(t), str(CSRC / s)]
              for (s, _), t in zip(todo, tmps)])
        for (_, o), t in zip(todo, tmps):
            os.replace(t, o)
        _run([[nvcc, *GENCODE, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for t in tmps:
            t.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return out


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    tensor (what the kernels take)."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def check_rows(name: str, t: torch.Tensor, K: int) -> None:
    """Raise unless t is a 2-d CUDA tensor of K int8 columns whose rows are
    dense, 16-byte aligned at the base and a multiple of 4 bytes apart (a
    [N, K] view of a [N, Kp] buffer qualifies: what K5 takes for a weight)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: all tensors must be on one CUDA device, got {t.device}")
    if t.dim() != 2 or t.shape[1] != K or t.stride(1) != 1 or t.stride(0) < K or t.stride(0) % 4:
        raise ValueError(f"{name}: a [rows, {K}] operand needs dense rows a multiple of 4 "
                         f"bytes apart, got shape {tuple(t.shape)} strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: tensors must be 16-byte aligned")


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (the persistent kernels' grid)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream():
    """PyTorch's current CUDA stream, as the kernels' launch argument."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        so.svt_prefill_attention.argtypes = [P] * 13 + [I] * 10 + [LL] * 2 + [P]
        so.svt_prefill_attention.restype = I
        so.svt_prefill_block_rows.argtypes = []
        so.svt_prefill_block_rows.restype = I
        so.svt_prefill_block_keys.argtypes = []
        so.svt_prefill_block_keys.restype = I
        so.svt_decode_attention.argtypes = [P] * 11 + [I] * 9 + [LL] * 2 + [P]
        so.svt_decode_attention.restype = I
        so.svt_decode_attention_raw.argtypes = [P] * 15 + [I] * 11 + [LL] * 3 + [P]
        so.svt_decode_attention_raw.restype = I
        so.svt_decode_partials.argtypes = [P] * 10 + [I] * 5 + [P]
        so.svt_decode_partials.restype = I
        so.svt_verify_attention.argtypes = [P] * 10 + [I] * 8 + [P]
        so.svt_verify_attention.restype = I
        so.svt_attention_bwd.argtypes = [P] * 12 + [I] * 4 + [P]
        so.svt_attention_bwd.restype = I
        so.svt_attention_bwd_block_keys.argtypes = []
        so.svt_attention_bwd_block_keys.restype = I
        so.svt_attention_bwd_tile_rows.argtypes = []
        so.svt_attention_bwd_tile_rows.restype = I
        so.svt_ce_rows.argtypes = [P] * 4 + [I, LL, I, P]
        so.svt_ce_rows.restype = I
        for fn in ("svt_decode_max_small_rows", "svt_decode_max_split", "svt_decode_max_parts",
                   "svt_decode_raw_max_split", "svt_decode_raw_max_parts",
                   "svt_verify_max_split", "svt_verify_max_parts", "svt_verify_max_queries",
                   "svt_verify_max_small_rows"):
            getattr(so, fn).argtypes = []
            getattr(so, fn).restype = I
        so.svt_int8_gemm.argtypes = [P, I, P, I, P, I, I, I, P, I, I, I, P, P, P]
        so.svt_int8_gemm.restype = I
        so.svt_qdot.argtypes = [P, I, P, I, P, P, P, I, P, I, P, I, I, I, P, I, I, I, P, P, P]
        so.svt_qdot.restype = I
        for fn in ("svt_int8_small_m", "svt_int8_block_m", "svt_int8_block_k"):
            getattr(so, fn).argtypes = []
            getattr(so, fn).restype = I
        so.svt_qdot4.argtypes = [P, I, P, I, P, I, P, P] + [I] * 9 + [P] * 3
        so.svt_qdot4.restype = I
        so.svt_int4_max_rows.argtypes = []
        so.svt_int4_max_rows.restype = I
        so.svt_int8_maps_encoded.argtypes = []
        so.svt_int8_maps_encoded.restype = ctypes.c_longlong
        # compile-time constants of the decode kernels, read once
        so.decode_max_small_rows = so.svt_decode_max_small_rows()
        so.decode_max_split = so.svt_decode_max_split()
        so.decode_max_parts = so.svt_decode_max_parts()
        so.raw_decode_max_split = so.svt_decode_raw_max_split()
        so.raw_decode_max_parts = so.svt_decode_raw_max_parts()
        so.verify_max_split = so.svt_verify_max_split()
        so.verify_max_parts = so.svt_verify_max_parts()
        so.verify_max_queries = so.svt_verify_max_queries()
        so.verify_max_small_rows = so.svt_verify_max_small_rows()
        so.int8_small_m = so.svt_int8_small_m()
        so.int4_max_rows = so.svt_int4_max_rows()
        so.int8_block = (so.svt_int8_block_m(), so.svt_int8_block_k())
        so.prefill_block = (so.svt_prefill_block_rows(), so.svt_prefill_block_keys())
        so.bwd_block = (so.svt_attention_bwd_block_keys(), so.svt_attention_bwd_tile_rows())
        _lib = so
    return _lib
