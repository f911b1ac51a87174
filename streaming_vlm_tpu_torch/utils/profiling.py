"""Named-section wall timing of the serve loop (PKV/CHECK/VIDEO/INPUT/GEN/
POST). A copy of `SectionTimer` from the JAX package's
streaming_vlm_tpu/utils/profiling.py."""

from __future__ import annotations

import contextlib
import time
from typing import Dict


class SectionTimer:
    """Accumulate wall time per named section within one loop iteration."""

    def __init__(self, sections=("PKV", "CHECK", "VIDEO", "INPUT", "GEN", "POST")):
        self.names = tuple(sections)
        self.reset()

    def reset(self):
        self.acc: Dict[str, float] = {k: 0.0 for k in self.names}
        self._loop_start = time.perf_counter()

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        """`sync` is an optional callable fencing device work (e.g.
        torch.cuda.synchronize), called on entry and on exit."""
        if sync:
            sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                sync()
            self.acc[name] = self.acc.get(name, 0.0) + time.perf_counter() - t0

    @property
    def total(self) -> float:
        return time.perf_counter() - self._loop_start

    def line(self, i: int) -> str:
        body = " | ".join(f"{k}={v:.3f}s" for k, v in self.acc.items())
        return f"[Loop {i}] total={self.total:.3f}s | {body}"

    def record(self) -> Dict[str, float]:
        d = dict(self.acc)
        d["total"] = self.total
        return d
