"""Multi-client serving over MultiStreamEngine's lanes.

Port of streaming_vlm_tpu/streaming/multiserve.py. Clients attach whenever they like, submit chunks at their
own pace and read their generated ids back; the server runs batched
rounds in which the lanes with a pending chunk are active and the rest
ride along idle (state frozen: streaming/multistream.py). With
`max_clients` above the lane count the server is oversubscribed: idle
streams are paged out to host snapshots (streaming/snapshot.py) and paged
back in, bitwise, when their next chunk comes up. With an `engine_factory`
a device fault mid-round is recovered: a fresh engine, every resident lane
restored from its periodic snapshot and its journal of delivered chunks
replayed, the undelivered chunks queued again.

  * the round loop is host logic: queue scans, one batched step, one
    batched fetch;
  * vision runs per active lane at its own grid (`encode_round_mixed`);
  * clients own their chunk clocks: a client attached mid-flight starts at
    its chunk 0;
  * rounds and every lane operation run on the CUDA device and stream that
    were current where the server was built (PyTorch's current stream and
    device are per thread, and the engine's buffers and the shared decode
    scratch were prepared there), whichever thread calls: the background
    thread, a client's `attach` or `snapshot`, or recovery's engine_factory.

Over an engine with a mesh of several ranks (`MultiStreamEngine(mesh=)`:
TP over 'model', lanes over 'data'), every rank runs the same server with
the same clients and submissions, and the server keeps the ranks' rounds
identical: a client attaches with a `key` that is its lane (no paging:
max_clients <= lanes), and each round's schedule is rank 0's, broadcast to
every rank, which waits for those clients' attach and chunks with the lock
released (a rank's clients may attach after rank 0 scheduled them); rank
0's stop() ends every rank's round loop. Recovery (engine_factory) is not
offered there.
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .engine import _bucket
from .multistream import MultiStreamEngine
from .segments import VISION

__all__ = ["MultiStreamServer", "StreamClient"]

# pushed into every client's result queue when the server fail-stops: wakes
# any get() blocked with no timeout so that it raises the server's error
_FAILED = object()


def _is_device_fault(exc: BaseException) -> bool:
    """A recoverable device-runtime fault, as opposed to a logic error
    (which must fail-stop: replaying it would raise it again): the JAX
    package's rule, a RuntimeError carrying a gRPC status word. A CUDA
    error is not one: a sticky CUDA error poisons the context, so no engine
    could be rebuilt on it."""
    return isinstance(exc, RuntimeError) and any(
        k in str(exc) for k in ("UNAVAILABLE", "INTERNAL", "DATA_LOSS"))


class _ClientError:
    """One rejected chunk, delivered through its client's result queue:
    get() raises the error once and the client stays usable (unlike
    _FAILED, which is fatal to the server and re-arms)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class StreamClient:
    """Handle of one attached stream: submit chunks, read results.

    `lane` is None while the client is parked (an oversubscribed server
    holds its stream as a host snapshot); the scheduler restores it into a
    lane when its next chunk is picked up."""

    def __init__(self, server: "MultiStreamServer", lane: Optional[int], key: int = -1):
        # weak: the server holds its clients, and a reference cycle would keep
        # a dropped server's engine (its arena and the model) alive until the
        # cycle collector runs
        self._server_ref = weakref.ref(server)
        self.lane = lane
        self.key = key  # a multi-rank server's name for the client (its lane)
        self.chunk_index = 0  # this client's own chunk clock
        self._pending: "queue.Queue[Dict[str, Any]]" = queue.Queue()
        self._results: "queue.Queue[Tuple[int, np.ndarray]]" = queue.Queue()
        self.closed = False
        self._parked: Optional[Dict[str, Any]] = None  # host snapshot
        self._seed: Optional[int] = None  # sampling seed until first placement
        self._last_round = -1  # LRU clock of the eviction choice
        # recovery (engine_factory): a snapshot at the last checkpointed chunk
        # boundary and the chunks delivered since
        self._recovery_snapshot: Optional[Dict[str, Any]] = None
        self._journal: List[Dict[str, Any]] = []

    @property
    def _server(self) -> "MultiStreamServer":
        server = self._server_ref()
        if server is None:
            raise RuntimeError("this client's MultiStreamServer is gone")
        return server

    def submit(
        self,
        chunk_segs: List,
        *,
        pixel_patches: Optional[np.ndarray] = None,  # [S, patch_dim]
        grid_thw: Optional[Tuple[int, int, int]] = None,
        max_new: Optional[int] = None,  # this chunk's decode budget
    ) -> None:
        """Queue one chunk (segments + optional vision patches) for the
        server's next round. A malformed chunk raises here, in the caller's
        thread: inside the round loop a failure would stop every client."""
        if self.closed:
            raise RuntimeError("client closed")
        self._server._check_alive()
        st = self._server.engine.stream
        if max_new is not None and int(max_new) < 1:
            raise ValueError(f"max_new must be >= 1 (got {max_new}); omit it for the default "
                             f"({st.max_tokens_per_chunk})")
        n_tok = sum(len(s.ids) for s in chunk_segs)
        if n_tok > max(st.prefill_buckets):
            raise ValueError(f"chunk has {n_tok} tokens, above the largest prefill bucket "
                             f"{max(st.prefill_buckets)}; split the chunk or serve with larger "
                             f"prefill_buckets")
        n_pad = sum(len(s.ids) for s in chunk_segs if s.kind == VISION)
        if pixel_patches is None:
            if n_pad:
                raise ValueError(f"chunk carries {n_pad} video_pad tokens but no pixel_patches; "
                                 f"the model would attend to placeholder embeddings")
        else:
            if grid_thw is None:
                raise ValueError("pixel_patches need their grid_thw")
            vc = self._server.engine.cfg.vision
            t_g, h_g, w_g = (int(x) for x in grid_thw)
            m = vc.spatial_merge_size
            if t_g < 1 or h_g < m or w_g < m or h_g % m or w_g % m:
                raise ValueError(f"grid {tuple(grid_thw)} is not a valid vision grid: t >= 1 and "
                                 f"h, w must be positive multiples of spatial_merge_size={m}")
            patch_dim = vc.in_channels * vc.temporal_patch_size * vc.patch_size**2
            if getattr(pixel_patches, "ndim", 0) != 2 or int(pixel_patches.shape[1]) != patch_dim:
                raise ValueError(f"pixel_patches must be [n_patches, {patch_dim}] (in_channels * "
                                 f"temporal_patch_size * patch_size^2); got shape "
                                 f"{getattr(pixel_patches, 'shape', None)}")
            n_patches = t_g * h_g * w_g
            if int(pixel_patches.shape[0]) != n_patches:
                raise ValueError(f"pixel_patches has {pixel_patches.shape[0]} rows but grid "
                                 f"{tuple(grid_thw)} implies {n_patches}")
            n_vis = n_patches // vc.spatial_merge_unit
            if n_pad != n_vis:
                raise ValueError(f"chunk carries {n_pad} video_pad tokens but grid "
                                 f"{tuple(grid_thw)} implies {n_vis}")
        self._pending.put({
            "segs": chunk_segs,
            "patches": pixel_patches,
            "grid": grid_thw,
            "max_new": max_new,
            # arrival order over all clients: the oldest head of queue goes first
            "ticket": next(self._server._ticket),
        })
        self._server._wake.set()

    def get(self, timeout: Optional[float] = None) -> Tuple[int, np.ndarray]:
        """The next (chunk_index, generated ids incl. eos). Raises
        queue.Empty on timeout, this client's rejected chunk's error once, or
        RuntimeError (chaining the cause) once the server has fail-stopped:
        a blocked get() is woken, never left hanging."""
        item = self._results.get(timeout=timeout)
        if item is _FAILED:
            self._results.put(_FAILED)  # re-arm: every later get() raises too
            self._server._check_alive()
            raise RuntimeError("server fail-stopped")
        if isinstance(item, _ClientError):
            raise item.exc
        return item

    def snapshot(self) -> Dict[str, Any]:
        """This client's live stream as a snapshot, typically right before
        close(), to move it to another server or process (`attach(snapshot=
        ...)` there) or to disk (snapshot.save_snapshot). Chunks submitted
        and not yet processed are not part of it: drain the results first."""
        if self.closed:
            raise RuntimeError("client closed")
        return self._server._snapshot(self)

    def close(self) -> None:
        """Detach: the lane is free for the next client; pending chunks are
        dropped."""
        self._server._detach(self)


class MultiStreamServer:
    """Round scheduler multiplexing clients onto `engine.n` lanes of one
    card. Rounds run by hand (`run_round_once`, deterministic) or on a
    background thread (`start` / `stop`). Clients may stream at different
    resolutions (each lane encodes at its own grid).

    `max_clients` > engine.n oversubscribes: up to max_clients streams share
    the lanes, parked streams held as host snapshots; the scheduler takes
    chunks oldest first, keeps a resident client in its lane (sticky), and
    pages out the least recently active idle resident when a parked client
    needs a lane. Paging never changes a stream's tokens.

    `engine_factory` (a zero-argument callable returning a compatible
    MultiStreamEngine) turns on recovery from device faults
    (_is_device_fault) in a round: the server builds a fresh engine,
    restores every resident lane from its snapshot (refreshed every
    `snapshot_every` delivered chunks) and replays the chunks delivered
    since, then queues the round's undelivered chunks again at the front:
    no submitted chunk is lost. After `max_recoveries` it fail-stops. Any
    other exception fail-stops the server at once."""

    def __init__(
        self,
        engine: MultiStreamEngine,
        *,
        end_bias: int = 2,
        max_clients: Optional[int] = None,
        engine_factory=None,
        snapshot_every: int = 16,
        max_recoveries: int = 3,
    ):
        self.engine = engine
        self._sync = _RankSync(engine.mesh) if _multi_rank(engine.mesh) else None
        if self._sync is not None and engine_factory is not None:
            raise ValueError("MultiStreamServer: recovery (engine_factory) under a mesh of "
                             "several ranks is not offered")
        if self._sync is not None and (max_clients or engine.n) > engine.n:
            raise ValueError("MultiStreamServer: under a mesh of several ranks each client "
                             "keeps its lane (key); max_clients must not exceed the lanes")
        self._agreed_stop = False
        self.engine_factory = engine_factory
        self.auto_recover = engine_factory is not None
        self.snapshot_every = snapshot_every
        self.max_recoveries = max_recoveries
        self.recoveries = 0
        self._inflight: Optional[List[List[Any]]] = None  # [client, work, delivered]
        self.end_bias = end_bias
        self.max_clients = engine.n if max_clients is None else max_clients
        self._lanes: List[Optional[StreamClient]] = [None] * engine.n
        self._all: List[StreamClient] = []
        self._ticket = itertools.count()
        self._round = 0  # LRU clock
        self.swaps = 0  # page-outs performed
        self._lock = threading.Lock()
        # a multi-rank round waits on it, releasing the lock, for the clients
        # that rank 0 scheduled to attach and submit here; attach notifies
        self._changed = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        # the device and stream every engine call runs on, from whichever thread
        dev = engine.device
        self._cuda = (dev, torch.cuda.current_stream(dev)) if dev.type == "cuda" else None
        # fail-stop: the first exception out of a round; a mid-round failure
        # can leave lane accounting inconsistent, so all later work is refused
        self.error: Optional[BaseException] = None

    def _on_device(self):
        """The server's CUDA device and stream as this thread's current ones
        (nothing on the CPU)."""
        if self._cuda is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self._cuda[0]))
        stack.enter_context(torch.cuda.stream(self._cuda[1]))
        return stack

    def _check_alive(self) -> None:
        if self.error is not None:
            raise RuntimeError(
                "MultiStreamServer has fail-stopped after an error in a batched round; state may "
                "be inconsistent: attach clients to a fresh server (snapshots taken before the "
                "failure remain valid)") from self.error

    def _fail(self, exc: BaseException) -> None:
        """Record the first round failure and wake every client."""
        if self.error is None:
            self.error = exc
        self._stop.set()
        for c in list(self._all):
            c._results.put(_FAILED)

    # ------------------------------------------------------------- lifecycle
    def attach(self, seed: Optional[int] = None,
               snapshot: Optional[Dict[str, Any]] = None,
               key: Optional[int] = None) -> StreamClient:
        """Admit a client: placed at once on a free lane, else (when
        oversubscribed) parked until first scheduled. With `snapshot` the
        client resumes that stream (moved from another server, process or
        card) and its chunk clock continues at the snapshot's chunk_index.
        An incompatible snapshot (config, geometry, or a foreign "rng" on a
        sampling server) raises ValueError here: placement may happen later
        inside a round, where a failure would stop every client. Raises
        RuntimeError once max_clients are attached. Under a mesh of several
        ranks `key` is required: the client's lane, the same on every
        rank."""
        self._check_alive()
        if self._sync is not None and (key is None or not 0 <= key < self.engine.n):
            raise ValueError(f"attach: under a mesh of several ranks a client needs a key, its "
                             f"lane in [0, {self.engine.n}), got {key!r}")
        if snapshot is not None:
            from .snapshot import check_geometry, check_rng, validate_snapshot

            validate_snapshot(snapshot, self.engine.stream)
            check_geometry(self.engine.cfg, snapshot)
            check_rng(snapshot, self.engine.generators[0], self.engine.sampling.do_sample)
        with self._lock, self._on_device():
            if len(self._all) >= self.max_clients:
                raise RuntimeError(f"all {self.max_clients} client slots taken "
                                   f"({self.engine.n} lanes); detach a client, raise "
                                   f"max_clients, or serve with a larger n_streams")
            client = StreamClient(self, None, -1 if key is None else int(key))
            client._seed = seed
            if snapshot is not None:
                client._parked = snapshot
                client.chunk_index = int(snapshot["chunk_index"])
            lane = self._free_lane() if self._sync is None else key
            if lane is not None and self._lanes[lane] is not None:
                raise RuntimeError(f"attach: lane {lane} (key) is taken")
            if lane is not None:
                self._place(client, lane)
            self._all.append(client)
            self._changed.notify_all()
            return client

    def _free_lane(self) -> Optional[int]:
        return next((b for b, c in enumerate(self._lanes) if c is None), None)

    def _place(self, client: StreamClient, lane: int) -> None:
        """Put a client's stream into a free lane (caller holds the lock)."""
        if client._parked is not None:
            self.engine.restore_lane(lane, client._parked)
            if self.auto_recover:  # the parked snapshot is the current state
                client._recovery_snapshot = client._parked
                client._journal.clear()
            client._parked = None
        else:
            self.engine.reset_lane(lane, seed=client._seed)
            if self.auto_recover:
                client._recovery_snapshot = self.engine.snapshot_lane(lane)
                client._journal.clear()
        client.lane = lane
        self._lanes[lane] = client

    def _evict(self, client: StreamClient) -> None:
        """Page a resident client out to a host snapshot, freeing its lane
        (between rounds, so at a chunk boundary)."""
        client._parked = self.engine.snapshot_lane(client.lane)
        if self.auto_recover:
            client._recovery_snapshot = client._parked
            client._journal.clear()
        self._lanes[client.lane] = None
        client.lane = None
        self.swaps += 1

    def _snapshot(self, client: StreamClient) -> Dict[str, Any]:
        with self._lock, self._on_device():
            # checked under the lock: the round thread may have popped a just
            # submitted chunk, whose turn would then be duplicated on replay
            if not (client._pending.empty() and client._results.empty()):
                raise RuntimeError("snapshot with submitted chunks pending or results "
                                   "undrained; drain get() first")
            if client.lane is None:
                if client._parked is None:
                    raise RuntimeError("snapshot of a never-scheduled client; submit a chunk "
                                       "first or attach(snapshot=...)")
                return dict(client._parked)  # the caller's dict outlives this client
            return self.engine.snapshot_lane(client.lane)

    def _detach(self, client: StreamClient) -> None:
        with self._lock:
            if client.closed:  # a second close(): the lane may be another client's now
                return
            client.closed = True
            if client.lane is not None:
                self._lanes[client.lane] = None
            client._parked = None
            client._recovery_snapshot = None
            client._journal.clear()
            if client in self._all:
                self._all.remove(client)

    def _admission_error(self, client: StreamClient, w: Dict[str, Any]) -> Optional[ValueError]:
        """The chunk against its lane's live state, after the round's
        eviction (so at the occupancy the round's own pre-pass certifies):
        its own bucket (with the lane's uncached tail) and budget. The
        error to deliver to this client, or None to admit. Cross-lane
        pressure is _shared_admission's."""
        st = self.engine.stream
        e = self.engine.engines[client.lane]
        n_real = e.uncached_tail + sum(len(s.ids) for s in w["segs"])
        try:
            t_pad = _bucket(n_real, st.prefill_buckets)
        except ValueError as exc:
            return exc
        max_new = st.max_tokens_per_chunk if w["max_new"] is None else int(w["max_new"])
        if max(e.cached + t_pad, e.cached + n_real + max_new) > st.kv_capacity:
            return ValueError(
                f"chunk of {n_real} tokens (incl. {e.uncached_tail} uncached tail) at "
                f"cached={e.cached} would overflow kv_capacity {st.kv_capacity}; shorten the "
                f"chunk or serve with a larger kv_capacity")
        return None

    def _shared_admission(self, work: List[Optional[Dict[str, Any]]],
                          admitted: List[StreamClient]) -> List[StreamClient]:
        """The round's shared capacity: every lane, idle residents too, pays
        the round's prefill bucket and its largest decode budget
        (MultiStreamEngine.round_capacity_error). While a lane would
        overflow, reject the admitted chunk that exerts the binding
        pressure (the largest own bucket if the bucket term binds, else the
        largest budget) to its own client, and look again; with everything
        rejected the round is skipped. The server never fail-stops over a
        capacity conflict between clients that are each valid."""
        st = self.engine.stream
        C = st.kv_capacity
        engines = self.engine.engines
        while admitted:
            n_reals = [e.uncached_tail + (0 if work[b] is None else
                                          sum(len(s.ids) for s in work[b]["segs"]))
                       for b, e in enumerate(engines)]
            buckets = [_bucket(n, st.prefill_buckets) for n in n_reals]
            t_shared = max(buckets)
            budgets = [st.max_tokens_per_chunk if work[b] is None or work[b]["max_new"] is None
                       else int(work[b]["max_new"]) for b in range(self.engine.n)]
            mx = max(budgets)
            over = next((b for b, e in enumerate(engines)
                         if max(e.cached + t_shared, e.cached + n_reals[b] + mx) > C), None)
            if over is None:
                return admitted
            e = engines[over]
            if e.cached + t_shared >= e.cached + n_reals[over] + mx:
                victim = max(admitted, key=lambda c: buckets[c.lane])
                cause = f"shared prefill bucket {t_shared}"
            else:
                victim = max(admitted, key=lambda c: budgets[c.lane])
                cause = f"round decode budget {mx}"
            victim._results.put(_ClientError(ValueError(
                f"chunk rejected: joining this batched round would impose {cause} on every "
                f"lane, overflowing kv_capacity {C} at lane {over} (cached={e.cached}); raise "
                f"kv_capacity, lower the chunk's size/max_new, or align stream protocols "
                f"across clients")))
            work[victim.lane] = None
            admitted = [c for c in admitted if c is not victim]
        return admitted

    # ----------------------------------------------------------------- round
    def run_round_once(self) -> int:
        """Take at most one pending chunk per client and run one batched
        round; returns the number of active lanes (0: nothing to do, or a
        fault was recovered and the round's chunks queued again). Holds the
        lock for the whole round, but for a multi-rank round's wait for its
        scheduled clients (_await_chunks). An exception fail-stops the
        server and is raised, unless recovery takes it."""
        self._check_alive()
        with self._lock, self._on_device():
            try:
                return self._round_locked()
            except BaseException as exc:
                if (self.auto_recover and _is_device_fault(exc)
                        and self.recoveries < self.max_recoveries):
                    try:
                        self._recover()
                    except BaseException as rexc:
                        rexc.__cause__ = exc
                        self._fail(rexc)
                        raise
                    self.recoveries += 1
                    return 0
                self._fail(exc)
                raise

    def _round_locked(self) -> int:
        # schedule: the oldest head-of-queue chunks first, one per client
        ready = [c for c in self._all if not c._pending.empty()]
        ready.sort(key=lambda c: c._pending.queue[0]["ticket"])
        chosen = ready[: self.engine.n]
        if self._sync is not None:  # rank 0's schedule on every rank
            keys, self._agreed_stop = self._sync.agree([c.key for c in chosen],
                                                       self._stop.is_set(), self.engine.n)
            chosen = [] if self._agreed_stop else self._await_chunks(keys)
        if not chosen:
            return 0

        # place parked chosen clients: free lanes first, then page out the
        # least recently active residents that are not in this round
        incoming = [c for c in chosen if c.lane is None]
        if incoming:
            chosen_ids = set(map(id, chosen))
            victims = sorted((c for c in self._lanes if c is not None and id(c) not in chosen_ids),
                             key=lambda c: c._last_round)
            for c in incoming:
                lane = self._free_lane()
                if lane is None:
                    self._evict(victims.pop(0))
                    lane = self._free_lane()
                self._place(c, lane)

        self._round += 1
        # evict first (idempotent; the round runs it again as a no-op), so that
        # admission sees the occupancy the round's own pre-pass certifies
        self.engine.evict_round()
        work: List[Optional[Dict[str, Any]]] = [None] * self.engine.n
        admitted: List[StreamClient] = []
        for c in chosen:
            w = c._pending.get_nowait()
            exc = self._admission_error(c, w)
            if exc is not None:  # this chunk to this client; the round goes on
                c._results.put(_ClientError(exc))
                continue
            work[c.lane] = w
            admitted.append(c)
            c._last_round = self._round
        admitted = self._shared_admission(work, admitted)
        if not admitted:
            return 0
        clients = list(self._lanes)
        self._inflight = [[c, work[c.lane], False] for c in admitted]
        by_lane = {entry[0].lane: entry for entry in self._inflight}

        grids = [None if w is None else w["grid"] for w in work]
        patches = [None if w is None else w["patches"] for w in work]
        ve = None
        if any(p is not None for p in patches):
            ve = self.engine.encode_round_mixed(patches, grids)
        segs = [None if w is None else w["segs"] for w in work]
        budgets = [None if w is None else w.get("max_new") for w in work]
        outs = self.engine.process_round(
            segs, vis_embeds=ve,
            grid_thw=grids if any(g is not None for g in grids) else None,
            max_new=budgets if any(m is not None for m in budgets) else None,
        )
        for b, (c, out) in enumerate(zip(clients, outs)):
            if out is None or c is None:
                continue
            gen, _n = out
            self.engine.engines[b].commit_assistant(gen, self.end_bias, c.chunk_index)
            c._results.put((c.chunk_index, np.asarray(gen)))
            c.chunk_index += 1
            if b in by_lane:
                by_lane[b][2] = True  # delivered: replays from the journal
        if self.auto_recover:
            # journal before clearing _inflight, so that a fault in the
            # snapshot refresh below cannot journal delivered work twice
            for c, w, delivered in self._inflight:
                if delivered:
                    c._journal.append(w)
            self._inflight = None
            for c in admitted:
                if len(c._journal) >= self.snapshot_every:
                    c._recovery_snapshot = self.engine.snapshot_lane(c.lane)
                    c._journal.clear()
        else:
            self._inflight = None
        return len(admitted)

    def _await_chunks(self, keys: List[int]) -> List[StreamClient]:
        """The clients with `keys` once each is attached here and has its
        next chunk queued (rank 0 scheduled them; this rank's attach or
        submission may come later). The caller holds the lock; the wait
        releases it, so that those attaches can run, and takes it back
        before the check. Submissions are seen by the wait's timeout."""

        def ready() -> bool:
            return all(self._lanes[k] is not None and not self._lanes[k]._pending.empty()
                       for k in keys)

        while not ready():
            self._changed.wait(timeout=0.001)
        return [self._lanes[k] for k in keys]

    # ------------------------------------------------------------ recovery
    def _recover(self) -> None:
        """Rebuild the engine after a device fault and reconstruct every
        resident lane bitwise (caller holds the lock): undelivered chunks of
        the failed round go back to the front of their clients' queues, and
        each lane's snapshot is restored and its journal replayed (the
        generator's state rides the snapshot, so the replay is exact)."""
        inflight = self._inflight or []
        self._inflight = None
        for c, w, delivered in inflight:
            if delivered:
                c._journal.append(w)
            else:  # one entry per client a round: the ticket order stays
                c._pending.queue.appendleft(w)
        self.engine = self.engine_factory()
        assert self.engine.n == len(self._lanes), "engine_factory must keep the lane count"
        for c in self._all:
            if c.lane is None:
                continue  # parked: already a host snapshot
            assert c._recovery_snapshot is not None
            self.engine.restore_lane(c.lane, c._recovery_snapshot)
            for j, w in enumerate(c._journal):
                self._replay_one(c, c.chunk_index - len(c._journal) + j, w)
            c._recovery_snapshot = self.engine.snapshot_lane(c.lane)  # a 2nd fault replays nothing
            c._journal.clear()

    def _replay_one(self, client: StreamClient, rnd: int, w: Dict[str, Any]) -> None:
        """Run one journaled chunk again for one lane, the others idle (an
        idle lane's only change, its uncached tail becoming cached, is what
        its next real chunk would do anyway)."""
        n = self.engine.n
        segs: List[Optional[Any]] = [None] * n
        grids: List[Optional[Any]] = [None] * n
        patches: List[Optional[Any]] = [None] * n
        budgets: List[Optional[Any]] = [None] * n
        b = client.lane
        segs[b], grids[b], patches[b], budgets[b] = w["segs"], w["grid"], w["patches"], \
            w.get("max_new")
        self.engine.evict_round()
        ve = self.engine.encode_round_mixed(patches, grids) if patches[b] is not None else None
        outs = self.engine.process_round(
            segs, vis_embeds=ve, grid_thw=grids if grids[b] is not None else None,
            max_new=budgets if budgets[b] is not None else None)
        self.engine.engines[b].commit_assistant(outs[b][0], self.end_bias, rnd)

    # ------------------------------------------------------------ background
    def start(self, poll_s: float = 0.002) -> None:
        """Drive rounds on a background thread until stop()."""
        assert self._thread is None

        def loop():
            # several ranks: every call agrees with rank 0's, whose stop ends all
            while not (self._agreed_stop if self._sync else self._stop.is_set()):
                try:
                    n = self.run_round_once()
                except BaseException:  # recorded, clients woken: the thread ends
                    return
                if n == 0 and not self._agreed_stop:
                    self._wake.wait(timeout=poll_s)
                    self._wake.clear()

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """End the round loop (several ranks: rank 0's stop ends every
        rank's loop; another rank's waits for it)."""
        if self._thread is not None:
            self._stop.set()
            self._wake.set()
            self._thread.join()
            self._thread = None


def _multi_rank(mesh) -> bool:
    return mesh is not None and int(np.prod(list(mesh.shape.values()))) > 1


class _RankSync:
    """Rank 0's round schedule on every rank of the mesh: [stop, n, keys...]
    broadcast as an int64 tensor (on the card under NCCL, on the host
    under gloo)."""

    def __init__(self, mesh):
        import torch.distributed as dist

        axes = tuple(mesh.axis_names)
        self.group, self.src = mesh.group(axes), mesh.ranks(axes)[0]
        nccl = dist.get_backend(self.group) == "nccl"
        self.device = torch.device("cuda", torch.cuda.current_device()) if nccl else "cpu"

    def agree(self, keys: List[int], stop: bool, n: int) -> Tuple[List[int], bool]:
        from ..parallel.distributed import broadcast

        msg = torch.full((n + 2,), -1, dtype=torch.int64)
        msg[0], msg[1] = int(stop), len(keys)
        msg[2:2 + len(keys)] = torch.tensor(keys, dtype=torch.int64)
        got = broadcast(msg.to(self.device), self.src, self.group).cpu()
        return [int(k) for k in got[2:2 + int(got[1])]], bool(got[0])
