"""The port's MultiStreamServer (streaming/multiserve.py), mirroring
tests/test_multiserve.py and tests/test_multiserve_matrix.py without the
data-parallel mesh case: deterministic rounds equal solo engines (across
attach mid-flight, migration between servers, mixed resolutions and
budgets, oversubscription with paging), and the oversubscribed server's
per-client greedy tokens equal the JAX package's server's; sticky
residency, parked snapshots and close; admission (per client, the round's
shared bucket and budget, post-evict occupancy); fail-stop waking a
blocked get(); automatic recovery from an injected device fault (no chunk
lost, tokens unchanged), logic errors not caught, max_recoveries kept.

Tiny f32 model on the CPU, both packages' weights from one JAX tree
through the bridge; tokens are compared exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_cpu_thread, warm_cpu_math  # noqa: F401  (autouse fixtures)

from streaming_vlm_tpu.config import SamplingConfig, StreamConfig, qwen25_vl_tiny
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.streaming.multiserve import MultiStreamServer as JaxServer
from streaming_vlm_tpu.streaming.multistream import MultiStreamEngine as JaxMS
from streaming_vlm_tpu.streaming.protocol import FakeTokenizer
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.streaming.engine import StreamingEngine, _bucket
from streaming_vlm_tpu_torch.streaming.multiserve import MultiStreamServer, _is_device_fault
from streaming_vlm_tpu_torch.streaming.multistream import MultiStreamEngine
from streaming_vlm_tpu_torch.streaming.protocol import PromptBuilder

CFG = qwen25_vl_tiny()
TOK = CFG.tokens
GRID = (1, 4, 4)
GRID_B = (1, 6, 4)  # a second resolution: 6 merged vision tokens
PATCH_DIM = CFG.vision.in_channels * CFG.vision.temporal_patch_size * CFG.vision.patch_size**2
END_BIAS = 2
GREEDY = SamplingConfig(do_sample=False, repetition_penalty=1.05)


def _stream(**kw):
    d = dict(text_round=3, window_size=2, chunk_duration=1, text_sink=8, text_sliding_window=8,
             max_tokens_per_chunk=6, kv_capacity=1024, prefill_buckets=(64, 128))
    d.update(kw)
    return StreamConfig(**d)


@pytest.fixture(scope="module")
def both():
    params = jm.init_params(CFG, jax.random.PRNGKey(11), dtype=jnp.float32)
    return params, from_jax_params(CFG, jax.tree_util.tree_map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def model(both):
    return both[1]


def _builder():
    return PromptBuilder(TOK, FakeTokenizer(TOK))


def _n_vid(grid):
    return grid[0] * (grid[1] // 2) * (grid[2] // 2)


def _chunk(builder, i, query, seed, grid=GRID):
    patches = (np.random.default_rng(seed).normal(size=(int(np.prod(grid)), PATCH_DIM))
               * 0.1).astype(np.float32)
    segs = []
    if i == 0:
        segs.append(builder.system_segment())
        segs.extend(builder.previous_text_segments("prev " + query))
        segs.extend(builder.user_turn_segments(0, 0.0, 1.0, _n_vid(grid), grid, 1.0,
                                               query=query))
    else:
        segs.extend(builder.user_turn_segments(i, float(i), float(i + 1), _n_vid(grid), grid,
                                               1.0))
    return segs + builder.assistant_open_segments(i), patches


_SOLO = {}


def _solo(model, query, n, seed0, grid=GRID, max_new=None, stream=None):
    """A solo port engine's generations (memoised: many tests share them)."""
    key = (query, n, seed0, grid, max_new, stream)
    if key not in _SOLO:
        eng = StreamingEngine(CFG, model, stream or _stream(), GREEDY, dtype=torch.float32)
        b = _builder()
        gens = []
        for i in range(n):
            segs, patches = _chunk(b, i, query, seed0 + i, grid)
            gen, _ = eng.process_chunk(segs, pixel_patches=patches, grid_thw=grid,
                                       max_new=max_new)
            eng.commit_assistant(gen, END_BIAS, i)
            gens.append(np.asarray(gen))
        _SOLO[key] = gens
    return _SOLO[key]


def _server(model, n=2, stream=None, **kw):
    ms = MultiStreamEngine(CFG, model, stream or _stream(), GREEDY, n_streams=n,
                           dtype=torch.float32)
    return MultiStreamServer(ms, end_bias=END_BIAS, **kw)


def test_server_rounds_match_solo(model):
    """Client A streams 4 chunks; B attaches at A's chunk 2 and streams 2;
    every delivered generation equals the solo engines'; close frees the
    lane for a third client."""
    srv = _server(model)
    solo_a = _solo(model, "narrate the game", 4, 100)
    solo_b = _solo(model, "describe the scene", 2, 500)
    a, ba = srv.attach(), _builder()
    b = bb = None
    got_a, got_b = [], []
    for rnd in range(4):
        segs, patches = _chunk(ba, rnd, "narrate the game", 100 + rnd)
        a.submit(segs, pixel_patches=patches, grid_thw=GRID)
        if rnd == 2:
            b, bb = srv.attach(), _builder()
        if b is not None:
            segs, patches = _chunk(bb, rnd - 2, "describe the scene", 500 + rnd - 2)
            b.submit(segs, pixel_patches=patches, grid_thw=GRID)
        assert srv.run_round_once() == (1 if rnd < 2 else 2)
        got_a.append(a.get(timeout=1))
        if rnd >= 2:
            got_b.append(b.get(timeout=1))
    for want, got in ((solo_a, got_a), (solo_b, got_b)):
        for i, (idx, gen) in enumerate(got):
            assert idx == i
            np.testing.assert_array_equal(want[i], gen)
    a.close()
    assert srv.attach().lane == a.lane


def test_server_to_server_migration(model):
    """A client snapshots off one server and attaches to another (a fresh
    engine, an unrelated client on lane 0): it continues where it left
    off, chunk clock included."""
    solo = _solo(model, "narrate the game", 5, 100)
    srv1 = _server(model)
    a, ba = srv1.attach(), _builder()
    for i in range(3):
        segs, patches = _chunk(ba, i, "narrate the game", 100 + i)
        a.submit(segs, pixel_patches=patches, grid_thw=GRID)
        srv1.run_round_once()
        np.testing.assert_array_equal(solo[i], a.get(timeout=1)[1])
    snap = a.snapshot()
    a.close()
    srv2 = _server(model)
    other, bo = srv2.attach(), _builder()
    m = srv2.attach(snapshot=snap)
    assert m.chunk_index == 3 and m.lane == 1
    for j in range(2):
        segs, patches = _chunk(ba, 3 + j, "narrate the game", 103 + j)
        m.submit(segs, pixel_patches=patches, grid_thw=GRID)
        segs, patches = _chunk(bo, j, "other stream", 700 + j)
        other.submit(segs, pixel_patches=patches, grid_thw=GRID)
        assert srv2.run_round_once() == 2
        idx, gen = m.get(timeout=1)
        assert idx == 3 + j
        np.testing.assert_array_equal(solo[3 + j], gen)
        other.get(timeout=1)


def test_server_lane_exhaustion_and_double_close(model):
    """attach beyond the lanes raises; a second close() on a handle whose
    lane was handed on must not free the new owner's lane."""
    srv = _server(model)
    srv.attach(), srv.attach()
    with pytest.raises(RuntimeError, match="client slots taken"):
        srv.attach()
    srv = _server(model)
    a = srv.attach()
    lane = a.lane
    a.close()
    b = srv.attach()
    assert b.lane == lane
    a.close()
    assert srv._lanes[lane] is b
    assert srv.attach().lane != lane


def test_server_background_thread(model):
    """The background thread delivers every chunk of two concurrent
    clients."""
    srv = _server(model)
    srv.start()
    try:
        clients = [srv.attach(), srv.attach()]
        builders = [_builder() for _ in clients]
        for i in range(3):
            for c, bld, q in zip(clients, builders, ("alpha", "beta")):
                segs, patches = _chunk(bld, i, q, 900 + 10 * c.lane + i)
                c.submit(segs, pixel_patches=patches, grid_thw=GRID)
        for c in clients:
            for i in range(3):
                idx, gen = c.get(timeout=60)
                assert idx == i and len(gen) >= 1
    finally:
        srv.stop()
    for e in srv.engine.engines:
        assert e.cached + e.uncached_tail == e.table.total_len()


def test_server_threads_stress(model):
    """Eight client threads (more than the lanes, with a short switch
    interval) attach, submit and read concurrently with the background
    round thread on an oversubscribed server: every client gets its chunks
    in order and equal to its solo engine, and a closed client's submit
    raises."""
    import sys
    import threading

    srv = _server(model, max_clients=8)
    errors, results = [], {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        srv.start()

        def client(k):
            try:
                c, b = srv.attach(), _builder()
                for i in range(2):
                    segs, patches = _chunk(b, i, f"q{k}", 40 * k + i)
                    c.submit(segs, pixel_patches=patches, grid_thw=GRID)
                results[k] = [c.get(timeout=120) for _ in range(2)]
                c.close()
                with pytest.raises(RuntimeError, match="closed"):
                    c.submit(segs, pixel_patches=patches, grid_thw=GRID)
            except BaseException as exc:  # reported by the main thread
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.stop()
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert srv.error is None and srv.swaps > 0
    for k in range(8):
        assert [i for i, _ in results[k]] == [0, 1]
        for i, (_, gen) in enumerate(results[k]):
            np.testing.assert_array_equal(_solo(model, f"q{k}", 2, 40 * k)[i], gen)


def test_server_mixed_resolution_clients(model):
    """Two clients at different resolutions in the same rounds; each equals
    a solo engine at its own grid."""
    solo_a = _solo(model, "narrate the game", 3, 700)
    solo_b = _solo(model, "describe the scene", 3, 900, GRID_B)
    srv = _server(model)
    a, b = srv.attach(), srv.attach()
    ba, bb = _builder(), _builder()
    for rnd in range(3):
        segs, patches = _chunk(ba, rnd, "narrate the game", 700 + rnd)
        a.submit(segs, pixel_patches=patches, grid_thw=GRID)
        segs, patches = _chunk(bb, rnd, "describe the scene", 900 + rnd, GRID_B)
        b.submit(segs, pixel_patches=patches, grid_thw=GRID_B)
        assert srv.run_round_once() == 2
        np.testing.assert_array_equal(solo_a[rnd], a.get(timeout=5)[1])
        np.testing.assert_array_equal(solo_b[rnd], b.get(timeout=5)[1])


QUERIES = ["alpha", "beta", "gamma", "delta"]
SEEDS = [100, 500, 900, 1300]


def _drive_oversubscribed(srv, n_chunks=3):
    """Four clients on two lanes: each wave of 4 chunks takes two rounds."""
    clients = [srv.attach() for _ in QUERIES]
    assert [c.lane for c in clients] == [0, 1, None, None]  # parked until scheduled
    builders = [_builder() for _ in QUERIES]
    got = [[] for _ in QUERIES]
    for i in range(n_chunks):
        for c, bld, q, s in zip(clients, builders, QUERIES, SEEDS):
            segs, patches = _chunk(bld, i, q, s + i)
            c.submit(segs, pixel_patches=patches, grid_thw=GRID)
        assert srv.run_round_once() == 2
        assert srv.run_round_once() == 2
        for k, c in enumerate(clients):
            idx, gen = c.get(timeout=1)
            assert idx == i
            got[k].append(np.asarray(gen))
    assert srv.swaps > 0
    return got


def test_server_oversubscription_matches_solo_and_jax(both):
    """Four clients share two lanes (max_clients=4): idle streams page out
    to host snapshots and back. Every client's generations equal its solo
    engine's and the JAX package's server's, client by client."""
    params, model = both
    got = _drive_oversubscribed(_server(model, max_clients=4))
    jsrv = JaxServer(JaxMS(CFG, params, _stream(), GREEDY, n_streams=2, dtype=jnp.float32),
                     end_bias=END_BIAS, max_clients=4)
    want = _drive_oversubscribed(jsrv)
    for k, (q, s) in enumerate(zip(QUERIES, SEEDS)):
        solo = _solo(model, q, 3, s)
        for i in range(3):
            np.testing.assert_array_equal(got[k][i], solo[i], err_msg=f"client {k} chunk {i}")
            np.testing.assert_array_equal(got[k][i], want[k][i], err_msg=f"client {k} chunk {i}")


def test_server_oversubscription_sticky_residency(model):
    """Two chatty residents and two silent parked clients: no swap."""
    srv = _server(model, max_clients=4)
    clients = [srv.attach() for _ in range(4)]
    builders = [_builder() for _ in range(2)]
    for i in range(3):
        for c, bld in zip(clients[:2], builders):
            segs, patches = _chunk(bld, i, "busy", 40 + i)
            c.submit(segs, pixel_patches=patches, grid_thw=GRID)
        assert srv.run_round_once() == 2
        for c in clients[:2]:
            c.get(timeout=1)
    assert srv.swaps == 0


def test_server_oversubscription_parked_snapshot_and_close(model):
    """A parked client snapshots and closes; closing it touches no lane."""
    srv = _server(model, max_clients=3)
    a, b = srv.attach(), srv.attach()
    for client, q, seed in ((a, "one", 77), (b, "two", 99)):
        segs, patches = _chunk(_builder(), 0, q, seed)
        client.submit(segs, pixel_patches=patches, grid_thw=GRID)
        srv.run_round_once()
        client.get(timeout=1)
    snap = a.snapshot()
    c = srv.attach()
    segs, patches = _chunk(_builder(), 0, "three", 88)
    c.submit(segs, pixel_patches=patches, grid_thw=GRID)
    srv.run_round_once()
    c.get(timeout=1)
    assert a.lane is None and srv.swaps == 1  # a, the least recently active, paged out
    parked = a.snapshot()
    assert parked["chunk_index"] == snap["chunk_index"] == 1
    lanes = list(srv._lanes)
    a.close()
    assert srv._lanes == lanes
    with pytest.raises(RuntimeError, match="client slots"):
        srv.attach(), srv.attach(), srv.attach()


def test_oversubscribed_mixed_grid_budgeted_clients(model):
    """Three clients (two resolutions, two decode budgets) on two lanes:
    rounds mix paged-in and resident lanes; every client equals its solo
    engine and the budgets bound the emission."""
    specs = [("narrate the game", 700, GRID, None), ("describe the scene", 900, GRID_B, 3),
             ("watch the crowd", 1100, GRID, 5)]
    solos = [_solo(model, q, 3, s, g, mn) for q, s, g, mn in specs]
    srv = _server(model, max_clients=3)
    clients = [srv.attach() for _ in specs]
    builders = [_builder() for _ in specs]
    for i in range(3):
        for c, bld, (q, s, g, mn) in zip(clients, builders, specs):
            segs, patches = _chunk(bld, i, q, s + i, g)
            c.submit(segs, pixel_patches=patches, grid_thw=g, max_new=mn)
        assert srv.run_round_once() == 2
        assert srv.run_round_once() == 1
        for k, c in enumerate(clients):
            idx, gen = c.get(timeout=1)
            assert idx == i
            np.testing.assert_array_equal(solos[k][i], gen, err_msg=f"client {k} chunk {i}")
            if specs[k][3] is not None:
                assert len(gen) <= specs[k][3] + 1
    assert srv.swaps > 0


def test_submit_validation(model):
    """Malformed submissions raise in the caller's thread (bad patch rows,
    counts, missing patches, an oversized chunk, max_new 0, a grid the
    tower cannot merge, a wrong patch width); nothing reaches the queue and
    the server goes on serving."""
    srv = _server(model)
    a, bld = srv.attach(), _builder()
    segs, patches = _chunk(bld, 0, "narrate the game", 100)
    with pytest.raises(ValueError, match="rows but"):
        a.submit(segs, pixel_patches=patches[:-1], grid_thw=GRID)
    with pytest.raises(ValueError, match="video_pad tokens"):
        a.submit(segs, pixel_patches=np.concatenate([patches, patches]),
                 grid_thw=(1, GRID[1] * 2, GRID[2]))
    with pytest.raises(ValueError, match="pixel_patches"):
        a.submit(segs)
    with pytest.raises(ValueError, match="prefill"):
        a.submit([bld.system_segment() for _ in range(40)])
    with pytest.raises(ValueError, match="max_new must be >= 1"):
        a.submit(segs, pixel_patches=patches, grid_thw=GRID, max_new=0)
    bad = (1, 7, 7)
    bsegs = bld.user_turn_segments(0, 0.0, 1.0, 12, bad, 1.0) + bld.assistant_open_segments(0)
    with pytest.raises(ValueError, match="valid vision grid"):
        a.submit(bsegs, pixel_patches=np.zeros((49, PATCH_DIM), np.float32), grid_thw=bad)
    with pytest.raises(ValueError, match="pixel_patches must be"):
        a.submit(segs, pixel_patches=patches[:, :-1], grid_thw=GRID)
    a.submit(segs, pixel_patches=patches, grid_thw=GRID)
    assert srv.run_round_once() == 1
    np.testing.assert_array_equal(_solo(model, "narrate the game", 1, 100)[0], a.get(timeout=1)[1])
    assert srv.error is None


def test_server_fail_stop_wakes_blocked_get(model):
    """A failure inside a round fail-stops the server: every get() raises
    (b never submitted), repeatedly, and attach / submit / run_round_once
    refuse with the original error chained."""
    srv = _server(model)
    srv.start()
    try:
        a, b = srv.attach(), srv.attach()
        boom = RuntimeError("injected round failure")

        def explode(*args, **kwargs):
            raise boom

        srv.engine.process_round = explode
        segs, patches = _chunk(_builder(), 0, "narrate the game", 100)
        a.submit(segs, pixel_patches=patches, grid_thw=GRID)
        for c in (a, b, a):
            with pytest.raises(RuntimeError, match="fail-stopped"):
                c.get(timeout=30)
        assert srv.error is boom
        for call in (lambda: a.submit(segs, pixel_patches=patches, grid_thw=GRID),
                     srv.attach, srv.run_round_once):
            with pytest.raises(RuntimeError, match="fail-stopped"):
                call()
    finally:
        srv.stop()


def test_attach_rejects_incompatible_snapshot(model):
    """attach(snapshot=...) validates in the caller's thread: a config
    mismatch, a missing field, and (on a sampling server) an "rng" that is
    not a state of its generators; the good snapshot still attaches."""
    srv = _server(model)
    a = srv.attach()
    segs, patches = _chunk(_builder(), 0, "narrate the game", 100)
    a.submit(segs, pixel_patches=patches, grid_thw=GRID)
    srv.run_round_once()
    a.get(timeout=1)
    snap = a.snapshot()
    with pytest.raises(ValueError, match="kv_quant"):
        srv.attach(snapshot=dict(snap, kv_quant="int8"))
    with pytest.raises(ValueError, match="missing field"):
        srv.attach(snapshot={k: v for k, v in snap.items() if k != "table"})
    sampled = MultiStreamServer(MultiStreamEngine(
        CFG, model, _stream(), SamplingConfig(do_sample=True, seed=3), n_streams=2,
        dtype=torch.float32))
    with pytest.raises(ValueError, match="'rng'"):
        sampled.attach(snapshot=dict(snap, rng=np.zeros(2, np.uint32)))
    m = srv.attach(snapshot=snap)
    assert m.chunk_index == 1 and srv.error is None


def test_round_admission_rejects_per_client(model):
    """A chunk that passes submit but cannot fit its lane's live state (a
    huge decode budget) is rejected to its own client once; the other
    client's round is unaffected and the rejected client goes on."""
    srv = _server(model)
    a, b = srv.attach(), srv.attach()
    ba, bb = _builder(), _builder()
    solo_b = _solo(model, "describe the scene", 2, 500)
    segs_a, patches_a = _chunk(ba, 0, "narrate the game", 100)
    a.submit(segs_a, pixel_patches=patches_a, grid_thw=GRID, max_new=10**6)
    segs, patches = _chunk(bb, 0, "describe the scene", 500)
    b.submit(segs, pixel_patches=patches, grid_thw=GRID)
    assert srv.run_round_once() == 1
    with pytest.raises(ValueError, match="kv_capacity"):
        a.get(timeout=1)
    np.testing.assert_array_equal(solo_b[0], b.get(timeout=1)[1])
    assert srv.error is None
    a.submit(segs_a, pixel_patches=patches_a, grid_thw=GRID)
    segs, patches = _chunk(bb, 1, "describe the scene", 501)
    b.submit(segs, pixel_patches=patches, grid_thw=GRID)
    assert srv.run_round_once() == 2
    idx, gen = a.get(timeout=1)
    assert idx == 0
    np.testing.assert_array_equal(_solo(model, "narrate the game", 1, 100)[0], gen)
    assert b.get(timeout=1)[0] == 1


def test_shared_admission_rejects_round_budget_conflict(model):
    """Two individually valid chunks that cannot share a round: B's budget,
    fine alone, overflows lane A as the round's decode length; B's chunk is
    rejected to B only, A's runs, and B streams on."""
    C = _stream().kv_capacity
    srv = _server(model)
    a, b = srv.attach(), srv.attach()
    segs_a, patches_a = _chunk(_builder(), 0, "narrate the game", 100)
    tiny = _builder().assistant_open_segments(0)
    mx = C - sum(len(s.ids) for s in tiny) - 1
    assert sum(len(s.ids) for s in segs_a) + mx > C
    a.submit(segs_a, pixel_patches=patches_a, grid_thw=GRID)
    b.submit(tiny, max_new=mx)
    assert srv.run_round_once() == 1
    with pytest.raises(ValueError, match="round decode budget"):
        b.get(timeout=1)
    idx, gen = a.get(timeout=1)
    assert idx == 0
    np.testing.assert_array_equal(_solo(model, "narrate the game", 1, 100)[0], gen)
    segs, patches = _chunk(_builder(), 0, "describe the scene", 500)
    b.submit(segs, pixel_patches=patches, grid_thw=GRID)
    assert srv.run_round_once() == 1
    np.testing.assert_array_equal(_solo(model, "describe the scene", 1, 500)[0], b.get(timeout=1)[1])


def test_shared_admission_rejects_round_bucket_conflict(model):
    """Lane A fills up (no eviction); B's chunk buckets at 128 where A's
    take 64: each alone fits, together the shared 128 bucket overflows A,
    so B's chunk is rejected and A's round runs untouched."""
    C = 320
    stream = StreamConfig(text_round=100, window_size=100, chunk_duration=1, text_sink=None,
                          text_sliding_window=None, max_tokens_per_chunk=6, kv_capacity=C,
                          prefill_buckets=(64, 128))
    srv = _server(model, stream=stream)
    a, b = srv.attach(), srv.attach()
    ba = _builder()
    solo = StreamingEngine(CFG, model, stream, GREEDY, dtype=torch.float32)
    sb = _builder()
    i = 0
    while True:
        e = srv.engine.engines[a.lane]
        segs, patches = _chunk(ba, i, "narrate the game", 100 + i)
        s_segs, s_patches = _chunk(sb, i, "narrate the game", 100 + i)
        if e.cached + 128 > C:
            break
        a.submit(segs, pixel_patches=patches, grid_thw=GRID)
        assert srv.run_round_once() == 1
        gen = a.get(timeout=1)[1]
        s_gen, _ = solo.process_chunk(s_segs, pixel_patches=s_patches, grid_thw=GRID)
        solo.commit_assistant(s_gen, END_BIAS, i)
        np.testing.assert_array_equal(s_gen, gen)
        i += 1
        assert i < 8, "the config never reached the conflict"
    e = srv.engine.engines[a.lane]
    assert e.cached + max(64, sum(len(s.ids) for s in segs) + e.uncached_tail + 6) <= C
    base = sum(len(s.ids) for s in _chunk(_builder(), 0, "", 900)[0])
    segs_b, patches_b = _chunk(_builder(), 0, "x" * max(0, (65 - base + 1) // 2), 900)
    assert 64 < sum(len(s.ids) for s in segs_b) <= 128
    a.submit(segs, pixel_patches=patches, grid_thw=GRID)
    b.submit(segs_b, pixel_patches=patches_b, grid_thw=GRID)
    assert srv.run_round_once() == 1
    with pytest.raises(ValueError, match="shared prefill bucket"):
        b.get(timeout=1)
    assert a.get(timeout=1)[0] == i
    assert srv.error is None


def test_admission_sees_post_evict_occupancy(model):
    """kv_capacity sized to the post-evict high-water mark streams through
    the server (admission runs after the round's eviction)."""
    n = 6
    eng = StreamingEngine(CFG, model, _stream(), GREEDY, dtype=torch.float32)
    bld = _builder()
    hw_post = hw_pre = 0
    for i in range(n):
        segs, patches = _chunk(bld, i, "narrate the game", 100 + i)
        n_tok = sum(len(s.ids) for s in segs)

        def hw(e):
            n_real = e.uncached_tail + n_tok
            return e.cached + max(_bucket(n_real, (64, 128)), n_real + 6)

        hw_pre = max(hw_pre, hw(eng))
        eng.evict()
        hw_post = max(hw_post, hw(eng))
        gen, _ = eng.process_chunk(segs, pixel_patches=patches, grid_thw=GRID)
        eng.commit_assistant(gen, END_BIAS, i)
    assert hw_pre > hw_post, "the config never evicted"
    solo = _solo(model, "narrate the game", n, 100, stream=_stream(kv_capacity=hw_post))
    srv = _server(model, n=1, stream=_stream(kv_capacity=hw_post))
    a, bld = srv.attach(), _builder()
    for i in range(n):
        segs, patches = _chunk(bld, i, "narrate the game", 100 + i)
        a.submit(segs, pixel_patches=patches, grid_thw=GRID)
        assert srv.run_round_once() == 1
        idx, gen = a.get(timeout=1)
        assert idx == i
        np.testing.assert_array_equal(solo[i], gen)
    assert srv.error is None


def _recovering(model, **kw):
    def factory():
        return MultiStreamEngine(CFG, model, _stream(), GREEDY, n_streams=2, dtype=torch.float32)

    return MultiStreamServer(factory(), end_bias=END_BIAS, engine_factory=factory, **kw)


def _inject_fault_once(srv, msg="UNAVAILABLE: injected device fault (test)"):
    """The current engine's next process_round raises (the rebuilt engine
    is unaffected)."""

    def boom(*a, **k):
        raise RuntimeError(msg)

    srv.engine.process_round = boom


def test_auto_recovery_injected_fault(model):
    """A device fault mid-round: the engine is rebuilt, every lane restored
    from its snapshot and its journal replayed, the round's chunks queued
    again: no chunk is lost and both clients' 5 chunks equal the solo
    runs."""
    srv = _recovering(model, snapshot_every=2)
    solo_a = _solo(model, "narrate the game", 5, 100)
    solo_b = _solo(model, "describe the scene", 5, 500)
    a, b = srv.attach(), srv.attach()
    ba, bb = _builder(), _builder()
    got_a, got_b = [], []
    for rnd in range(5):
        segs, patches = _chunk(ba, rnd, "narrate the game", 100 + rnd)
        a.submit(segs, pixel_patches=patches, grid_thw=GRID)
        segs, patches = _chunk(bb, rnd, "describe the scene", 500 + rnd)
        b.submit(segs, pixel_patches=patches, grid_thw=GRID)
        if rnd == 3:
            _inject_fault_once(srv)
        n = srv.run_round_once()
        if n == 0:
            assert srv.recoveries == 1
            n = srv.run_round_once()
        assert n == 2
        got_a.append(a.get(timeout=5))
        got_b.append(b.get(timeout=5))
    assert srv.recoveries == 1 and srv.error is None
    for solo, got in ((solo_a, got_a), (solo_b, got_b)):
        for i, (idx, gen) in enumerate(got):
            assert idx == i
            np.testing.assert_array_equal(solo[i], gen)


def test_auto_recovery_does_not_catch_logic_errors(model):
    srv = _recovering(model)
    a = srv.attach()
    segs, patches = _chunk(_builder(), 0, "q", 1)
    a.submit(segs, pixel_patches=patches, grid_thw=GRID)

    def boom(*a_, **k_):
        raise ValueError("logic bug, not a device fault")

    srv.engine.process_round = boom
    with pytest.raises(ValueError):
        srv.run_round_once()
    assert srv.error is not None and srv.recoveries == 0
    with pytest.raises(RuntimeError):
        srv.attach()


def test_auto_recovery_respects_max_recoveries(model):
    srv = _recovering(model, max_recoveries=1)
    a, builder = srv.attach(), _builder()
    segs, patches = _chunk(builder, 0, "q", 1)
    a.submit(segs, pixel_patches=patches, grid_thw=GRID)
    _inject_fault_once(srv)
    assert srv.run_round_once() == 0 and srv.recoveries == 1
    assert srv.run_round_once() == 1
    a.get(timeout=5)
    segs, patches = _chunk(builder, 1, "q", 2)
    a.submit(segs, pixel_patches=patches, grid_thw=GRID)
    _inject_fault_once(srv)
    with pytest.raises(RuntimeError):
        srv.run_round_once()
    assert srv.error is not None


def test_device_fault_rule():
    """The JAX package's rule: a RuntimeError with a gRPC status word is a
    device fault; a CUDA error or any other exception is not."""
    assert _is_device_fault(RuntimeError("UNAVAILABLE: socket closed"))
    assert _is_device_fault(RuntimeError("INTERNAL: x")) and _is_device_fault(
        RuntimeError("DATA_LOSS: y"))
    assert not _is_device_fault(RuntimeError("CUDA error: an illegal memory access"))
    assert not _is_device_fault(ValueError("UNAVAILABLE"))
