"""Named-section wall timing of the serve loop (PKV/CHECK/VIDEO/INPUT/GEN/
POST) and whole-run traces. `SectionTimer` is a copy of the JAX package's
(streaming_vlm_tpu/utils/profiling.py); `trace` is the counterpart of its
jax.profiler trace: a torch.profiler run written as a Chrome trace."""

from __future__ import annotations

import contextlib
import os
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


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the body with torch.profiler (host ops, and the card's kernels
    when CUDA is available) and write it as a Chrome trace
    `trace_<pid>_<ns>.json` under `logdir` (created if missing; open it in
    chrome://tracing or Perfetto). A failure to create or write it raises.
    Yields the profiler."""
    import torch

    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
