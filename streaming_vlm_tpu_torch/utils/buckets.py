"""Bucketing of variable-length inputs: a chunk pads up to the smallest
configured prefill bucket that fits. A copy of the JAX package's
streaming_vlm_tpu/utils/buckets.py."""

from __future__ import annotations

from typing import Sequence

__all__ = ["bucket_for"]


def bucket_for(n: int, buckets: Sequence[int], *, what: str = "sequence",
               fix: str = "") -> int:
    """Smallest bucket >= n. Raises ValueError naming the overflow and the
    configured buckets; `fix` appends a caller-specific remedy."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"{what} of {n} tokens exceeds the largest bucket {buckets[-1]} "
        f"(buckets={tuple(buckets)}).{fix}"
    )
