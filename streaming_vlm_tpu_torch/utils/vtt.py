"""WebVTT subtitle writing. A copy of the JAX package's
streaming_vlm_tpu/utils/vtt.py."""

from __future__ import annotations

import contextlib
import os


def sec2ts(seconds: float) -> str:
    """Seconds -> 'HH:MM:SS.mmm'."""
    ms = int(round((seconds - int(seconds)) * 1000))
    s = int(seconds)
    return f"{s // 3600:02d}:{(s % 3600) // 60:02d}:{s % 60:02d}.{ms:03d}"


@contextlib.contextmanager
def open_vtt(path: str):
    """Append-mode VTT writer; writes the WEBVTT header on first open."""
    fresh = not os.path.exists(path) or os.path.getsize(path) == 0
    with open(path, "a") as f:
        if fresh:
            f.write("WEBVTT\n\n")
        yield f
