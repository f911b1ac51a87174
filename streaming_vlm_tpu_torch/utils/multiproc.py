"""Thread/process pool maps with progress (I/O-bound judge/HTTP fan-out).
A copy of the JAX package's streaming_vlm_tpu/utils/multiproc.py; `tqdm`
is optional and imported where used."""

from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Iterable, List, Sequence


def local_mt(items: Sequence, func: Callable, desc: str = "", workers: int = 8) -> List:
    """Threaded map (I/O bound: API calls, file reads)."""
    try:
        from tqdm import tqdm
    except ImportError:
        tqdm = lambda x, **k: x
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(tqdm(ex.map(func, items), total=len(items), desc=desc))


def local_mp(items: Sequence, func: Callable, desc: str = "", workers: int = 8) -> List:
    """Process map (CPU bound)."""
    try:
        from tqdm import tqdm
    except ImportError:
        tqdm = lambda x, **k: x
    with ProcessPoolExecutor(max_workers=workers) as ex:
        return list(tqdm(ex.map(func, items), total=len(items), desc=desc))
