"""Video ingest: native FFmpeg reader + Qwen-style sampling/resize/patchify.

A copy of what the serve loop uses from the JAX package's
streaming_vlm_tpu/video/ingest.py: the native reader (`VideoReader`, over
the C++ library in video/native/svt_ingest.cc), `smart_resize`,
`select_chunk_frames`, `patchify_frames` and `ChunkedVideoSource`, and
`write_test_video` (a synthetic mp4 clip for the tests).
tests/test_torch_imports.py holds the pure-numpy helpers bitwise equal to
the JAX package's.

The library is compiled with g++ at first use into `build/torch_ingest/`
at the repository root (listed in .gitignore), keyed by a hash of the
source, never beside the source. It needs FFmpeg's development libraries;
`serve.streaming_inference_frames` takes decoded frames on machines
without them.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "svt_ingest.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ingest"
GXX_FLAGS = ("-O2", "-fPIC", "-shared")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libsvt_ingest_{h.hexdigest()[:16]}.so"


def build_native() -> Path:
    """Compile the native ingest library if no build of the current source
    exists. Returns its path. Writes a per-process temporary file and
    renames it into place, so processes that build at once never load a
    partial file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), *LIBS, "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_native()))
        lib.svt_open.restype = ctypes.c_void_p
        lib.svt_open.argtypes = [ctypes.c_char_p]
        lib.svt_n_frames.argtypes = [ctypes.c_void_p]
        lib.svt_width.argtypes = [ctypes.c_void_p]
        lib.svt_height.argtypes = [ctypes.c_void_p]
        lib.svt_avg_fps.argtypes = [ctypes.c_void_p]
        lib.svt_avg_fps.restype = ctypes.c_double
        lib.svt_timestamps.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
        lib.svt_fetch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.svt_close.argtypes = [ctypes.c_void_p]
        lib.svt_write_test_video.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 4
        _LIB = lib
    return _LIB


def write_test_video(path: str, w: int = 128, h: int = 96, n_frames: int = 60, fps: int = 10) -> None:
    """Write a synthetic mpeg4 clip of n_frames w x h frames at fps, a
    moving gradient (w and h multiples of 4), through the native library's
    `svt_write_test_video`."""
    rc = _lib().svt_write_test_video(path.encode(), w, h, n_frames, fps)
    if rc != 0:
        raise RuntimeError(f"svt_write_test_video failed: {rc}")


class VideoReader:
    """Native video reader: PTS table at open, batched resized fetches."""

    def __init__(self, path: str):
        self._lib = _lib()
        self._h = self._lib.svt_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open video: {path}")
        self.n_frames = self._lib.svt_n_frames(self._h)
        self.width = self._lib.svt_width(self._h)
        self.height = self._lib.svt_height(self._h)
        self.avg_fps = self._lib.svt_avg_fps(self._h)
        ts = np.zeros((self.n_frames, 2), np.float64)
        self._lib.svt_timestamps(self._h, ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        self.frame_ts = ts  # [n, 2] start/end seconds

    def fetch(self, indices: Sequence[int], out_w: int, out_h: int) -> np.ndarray:
        """Decode frames -> uint8 RGB [T, H, W, C], resized by swscale bicubic."""
        idx = np.asarray(indices, np.int64)
        out = np.empty((len(idx), out_h, out_w, 3), np.uint8)
        rc = self._lib.svt_fetch(
            self._h,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx),
            out_w,
            out_h,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            raise RuntimeError(f"svt_fetch failed: {rc}")
        return out

    def close(self):
        if getattr(self, "_h", None):  # absent when __init__ failed
            self._lib.svt_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


# ---------------------------------------------------------------------------
# Qwen-style geometry
# ---------------------------------------------------------------------------


def smart_resize(
    height: int,
    width: int,
    factor: int = 28,
    min_pixels: int = 100 * 28 * 28,
    max_pixels: int = 512 * 28 * 28,
) -> Tuple[int, int]:
    """Qwen2-VL pixel-budget resize: round to `factor` multiples and scale
    into [min_pixels, max_pixels]."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt(height * width / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def select_chunk_frames(
    frame_end_ts: np.ndarray,  # [n] frame END timestamps (seconds)
    video_start: Optional[float],
    video_end: Optional[float],
    *,
    fps: float,
    frame_factor: int = 2,
    max_frames: int = 480,
    only_last: Optional[int] = None,
) -> Tuple[List[int], List[float]]:
    """Strict-FPS frame selection: expected timestamps on a 1/fps grid, each
    mapped to the first frame whose end timestamp reaches it, padded to a
    multiple of frame_factor by repeating the last frame. Returns (frame
    indices, their end timestamps)."""
    pts = frame_end_ts
    idxs = np.arange(len(pts))
    if video_start is not None or video_end is not None:
        v0 = pts[0] if video_start is None else video_start
        v1 = pts[-1] if video_end is None else video_end
        keep = (v0 <= pts) & (pts <= v1)
        idxs = idxs[keep]
        pts = pts[keep]
    if len(pts) == 0:
        raise ValueError("no frames in requested range")

    expected = np.arange(pts[0], pts[-1] + 1e-6, 1.0 / fps)
    if len(expected) > max_frames:
        expected = expected[:max_frames]
    sel = (expected[:, None] <= pts[None, :]).argmax(axis=1)
    clip_idxs = idxs[sel].tolist()
    clip_pts = pts[sel].tolist()
    while len(clip_idxs) % frame_factor != 0:
        clip_idxs.append(clip_idxs[-1])
        clip_pts.append(clip_pts[-1])
    if only_last:
        clip_idxs = clip_idxs[-only_last:]
        clip_pts = clip_pts[-only_last:]
    return clip_idxs, clip_pts


# ---------------------------------------------------------------------------
# Patchify (HF Qwen2VLImageProcessor layout)
# ---------------------------------------------------------------------------


def patchify_frames(
    frames_u8: np.ndarray,  # [T, H, W, C] uint8 RGB (already smart-resized)
    *,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """uint8 frames -> (flatten_patches [S, C*tps*ps*ps] float32, grid_thw).
    Rescale 1/255 + CLIP mean/std normalisation, temporal padding by repeating
    the last frame, then the Qwen2VL patch flattening."""
    x = frames_u8.astype(np.float32) / 255.0
    x = (x - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD
    x = x.transpose(0, 3, 1, 2)  # [T, C, H, W]
    T, C, H, W = x.shape
    if T % temporal_patch_size:
        pad = temporal_patch_size - T % temporal_patch_size
        x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)
        T = x.shape[0]
    gt = T // temporal_patch_size
    gh, gw = H // patch_size, W // patch_size
    m, ps, tps = merge_size, patch_size, temporal_patch_size
    x = x.reshape(gt, tps, C, gh // m, m, ps, gw // m, m, ps)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = x.reshape(gt * gh * gw, C * tps * ps * ps)
    return np.ascontiguousarray(flat), (gt, gh, gw)


class ChunkedVideoSource:
    """Streaming chunk source: open once, fetch (chunk_duration * fps)
    frames per chunk at a fixed smart-resized geometry."""

    def __init__(
        self,
        path: str,
        *,
        fps: float = 2.0,
        frame_factor: int = 2,
        max_pixels: int = 512 * 28 * 28,
        min_pixels: int = 100 * 28 * 28,
        patch_size: int = 14,
        temporal_patch_size: int = 2,
        merge_size: int = 2,
    ):
        self.reader = VideoReader(path)
        self.fps = fps
        self.frame_factor = frame_factor
        self.patch_size = patch_size
        self.temporal_patch_size = temporal_patch_size
        self.merge_size = merge_size
        self.out_h, self.out_w = smart_resize(
            self.reader.height,
            self.reader.width,
            factor=patch_size * merge_size,
            min_pixels=min_pixels,
            max_pixels=max_pixels,
        )

    @property
    def duration(self) -> float:
        return float(self.reader.frame_ts[-1, 1]) if self.reader.n_frames else 0.0

    def read_chunk(
        self, start: float, end: float
    ) -> Tuple[np.ndarray, Tuple[int, int, int], List[float]]:
        """Fetch the chunk's frames, returning (flatten_patches, grid_thw, pts)."""
        n_last = int(round((end - start) * self.fps))
        idxs, pts = select_chunk_frames(
            self.reader.frame_ts[:, 1],
            start,
            end,
            fps=self.fps,
            frame_factor=self.frame_factor,
            only_last=n_last,
        )
        frames = self.reader.fetch(idxs, self.out_w, self.out_h)
        patches, grid = patchify_frames(
            frames,
            patch_size=self.patch_size,
            temporal_patch_size=self.temporal_patch_size,
            merge_size=self.merge_size,
        )
        return patches, grid, pts
