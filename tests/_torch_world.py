"""A gloo world of N CPU ranks for the port's parallel tests, spawned once
per test file (a module-scoped fixture): each rank is a process that joins
the world through a FileStore under the test's tmp dir (no ports to clash
between xdist workers), sets one torch thread, then runs the functions it
is sent, in order, and sends back each result. `World.run(fn, *args)` runs
fn(*args) on every rank and returns the ranks' results in rank order; a
rank's exception fails the call with its traceback. The functions live in
modules that import torch and the port only (never jax), so the ranks start
in a few seconds."""

from __future__ import annotations

import multiprocessing as mp
import queue
import traceback
from datetime import timedelta

TIMEOUT = 240  # seconds for one call on every rank


def _rank_main(rank: int, world: int, init_file: str, inq, outq) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=TIMEOUT - 30))
    while True:
        item = inq.get()
        if item is None:
            break
        fn, args, kwargs = item
        try:
            outq.put((rank, True, fn(*args, **kwargs)))
        except BaseException:  # noqa: BLE001  (sent back to the test, which fails)
            outq.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class World:
    def __init__(self, n: int, tmp_dir: str):
        ctx = mp.get_context("spawn")
        self.n = n
        self.outq = ctx.Queue()
        self.inqs = [ctx.Queue() for _ in range(n)]
        init_file = f"{tmp_dir}/gloo_store"
        self.procs = [ctx.Process(target=_rank_main, args=(r, n, init_file, self.inqs[r],
                                                           self.outq), daemon=True)
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, **kwargs) -> list:
        for q in self.inqs:
            q.put((fn, args, kwargs))
        results, errors = [None] * self.n, []
        for _ in range(self.n):
            try:
                rank, ok, value = self.outq.get(timeout=TIMEOUT)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"a rank did not answer {fn.__name__} in {TIMEOUT} s")
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError(f"{fn.__name__} failed on {len(errors)} rank(s):\n" +
                               "\n".join(errors))
        return results

    def close(self) -> None:
        for q in self.inqs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
