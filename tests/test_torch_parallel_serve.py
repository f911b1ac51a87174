"""The port's tensor- and lane-parallel serving (streaming_vlm_tpu_torch/
parallel/tp.py, `StreamingEngine(mesh=)`, `MultiStreamEngine(mesh=)`)
against the JAX engines on conftest's virtual CPU devices with the same
meshes, in one gloo world of 2 CPU ranks spawned for the file
(tests/_torch_world.py). As tests/test_mesh.py: greedy tokens, surviving
ids, cached / uncached_tail and positions equal over 4 chunks with an
eviction, for the float and the int8 arena, on every rank; each W8A8 product
under TP equals `qdot_plain`'s unsharded product bitwise (row-parallel:
MAX-reduced absmax, K5's int32 partials summed, then the rescale;
column-parallel: its columns), and the W8A8 engine's logits equal the
unsharded port's; the multi-rank MultiStreamServer and
MultiLiveCaptionServer, with one rank's clients attaching after rank 0
scheduled them, against the JAX server and demo; the mesh builders'
shapes; and the refusals that stay true under a mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_parallel_cases as C
from _torch_cpu import numpy_params
from _torch_world import World
from streaming_vlm_tpu.config import SamplingConfig, StreamConfig, VideoConfig, qwen25_vl_tiny
from streaming_vlm_tpu.parallel.distributed import batch_spec as jbatch_spec
from streaming_vlm_tpu.parallel.mesh import make_mesh, shard_params, shard_params_serving
from streaming_vlm_tpu.streaming.engine import StreamingEngine as JaxEngine
from streaming_vlm_tpu.streaming.multiserve import MultiStreamServer as JaxServer
from streaming_vlm_tpu.streaming.multistream import MultiStreamEngine as JaxMS
from streaming_vlm_tpu.streaming.protocol import FakeTokenizer, PromptBuilder

CFG = qwen25_vl_tiny()
GREEDY = SamplingConfig(do_sample=False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


@pytest.fixture(scope="module")
def tree():
    return numpy_params(CFG)


@pytest.fixture(scope="module")
def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jax_stream(**kw):
    base = dict(text_round=2, window_size=2, chunk_duration=1, text_sink=4,
                text_sliding_window=3, max_tokens_per_chunk=4, kv_capacity=1024,
                prefill_buckets=(64, 128, 256))
    base.update(kw)
    return StreamConfig(**base)


def _jax_drive(params, mesh, n_chunks, **stream_kw):
    eng = JaxEngine(CFG, params, _jax_stream(**stream_kw), GREEDY, dtype=jnp.float32, mesh=mesh)
    b = PromptBuilder(CFG.tokens, FakeTokenizer(CFG.tokens))
    _, end_bias = b.measure_biases()
    out = []
    for i, px in enumerate(C.chunk_pixels(n_chunks)):
        g, _ = eng.process_chunk(C.chunk_segs(b, i), px, C.GRID)
        eng.commit_assistant(g, end_bias, i)
        out.append((np.asarray(g), np.asarray(eng.table.token_ids()), eng.cached,
                    eng.uncached_tail, np.asarray(eng._positions())))
    return out


def test_mesh_builders(world):
    """make_mesh / make_slice_mesh / make_multislice_mesh: JAX's axis names,
    order and shape, row-major ranks, and batch_spec's axes as JAX's."""
    got = world.run(C.mesh_shapes)
    for rank, r in enumerate(got):
        assert r["rank"] == rank
        shape, coords, spec = r["slice"]
        assert list(shape.items()) == [("data", 1), ("model", 2)]
        assert coords == {"data": 0, "model": rank}
        jmesh = make_mesh({"data": 1, "model": 2})
        assert tuple(spec) == tuple(jbatch_spec(jmesh))
        shape, coords, data_line, model_line, both = r["mesh"]
        assert list(shape.items()) == [("data", 2), ("model", 1)]
        assert coords == {"data": rank, "model": 0}
        assert (data_line, model_line, both) == ([0, 1], [rank], [0, 1])


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_tp_engine_matches_jax(world, tree, jparams, kv_quant):
    """StreamingEngine(mesh={"model": 2}) against the JAX engine on a
    ("model",) mesh of 2 devices (weights by shard_params, arena over kv
    heads): 4 chunks, an eviction, every rank equal to JAX."""
    jmesh = make_mesh({"data": 1, "model": 2})  # JAX's rules name both axes
    sharded, _ = shard_params(jparams, jmesh)
    want = _jax_drive(sharded, jmesh, 4, kv_quant=kv_quant)
    got = world.run(C.drive_engine, tree, {"model": 2}, {"kv_quant": kv_quant}, 4)
    assert any(c[5] for c in got[0]), "no eviction in 4 chunks"
    for rank, chunks in enumerate(got):
        for i, (g, w) in enumerate(zip(chunks, want)):
            np.testing.assert_array_equal(g[0], w[0], err_msg=f"rank {rank} chunk {i}: tokens")
            np.testing.assert_array_equal(g[1], w[1], err_msg=f"rank {rank} chunk {i}: ids")
            assert (g[2], g[3]) == (w[2], w[3]), (rank, i)
            np.testing.assert_allclose(g[4], w[4], atol=1e-5)


def test_w8a8_products_under_tp_are_bitwise(world):
    """Row-parallel (1, 7, 40 and 3 rows; 18 contract columns a rank, which
    K5 takes padded to 20) and column-parallel W8A8 products on {"model": 2}
    equal qdot_plain's unsharded product bit for bit."""
    assert world.run(C.w8a8_products, {"model": 2}) == [8, 8]


def test_w8a8_engine_logits_equal_unsharded(world, tree):
    """The W8A8 engine (int8 arena) under {"model": 2}: chunk 0's logits
    equal the unsharded port's to f32 roundoff on both ranks."""
    ref = C.chunk0_logits(tree, None, quantize=8)
    for got in world.run(C.chunk0_logits, tree, {"model": 2}, 8):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shape,lanes", [({"data": 2}, 4), ({"model": 2}, 2)],
                         ids=["data2-4lanes", "model2-2lanes"])
def test_multistream_matches_jax(world, tree, jparams, shape, lanes):
    """MultiStreamEngine(mesh=) against the JAX MultiStreamEngine on the same
    mesh (weights by shard_params_serving): 3 greedy rounds, every lane's
    tokens and host state equal JAX's on every rank; with data=2 each rank
    runs its half of the lanes."""
    jmesh = make_mesh({"data": shape.get("data", 1), "model": shape.get("model", 1)})
    sharded, _ = shard_params_serving(jparams, jmesh)
    jms = JaxMS(CFG, sharded, _jax_stream(), GREEDY, n_streams=lanes, dtype=jnp.float32,
                mesh=jmesh)
    bs = [PromptBuilder(CFG.tokens, FakeTokenizer(CFG.tokens)) for _ in range(lanes)]
    _, end_bias = bs[0].measure_biases()
    want = []
    for i, ve in enumerate(C.round_embeds(lanes, 3)):
        res = jms.process_round([C.chunk_segs(b, i) for b in bs], vis_embeds=jnp.asarray(ve),
                                grid_thw=C.GRID)
        jms.commit_assistant([g for g, _ in res], end_bias, i)
        want.append([(np.asarray(g), np.asarray(e.table.token_ids()), e.cached, e.uncached_tail,
                      np.asarray(e._positions())) for (g, _), e in zip(res, jms.engines)])
    got = world.run(C.drive_multistream, tree, shape, lanes, 3)
    spans = [g[1] for g in got]
    assert spans == ([(0, 2), (2, 4)] if "data" in shape else [(0, 2), (0, 2)])
    for rank, (rounds, _) in enumerate(got):
        for i, (gr, wr) in enumerate(zip(rounds, want)):
            for b, (g, w) in enumerate(zip(gr, wr)):
                msg = f"rank {rank} round {i} lane {b}"
                np.testing.assert_array_equal(g[0], w[0], err_msg=msg)
                np.testing.assert_array_equal(g[1], w[1], err_msg=msg)
                assert (g[2], g[3]) == (w[2], w[3]), msg
                np.testing.assert_allclose(g[4], w[4], atol=1e-5, err_msg=msg)


@pytest.mark.parametrize("shape", [{"data": 2}, {"model": 2}], ids=["data2", "model2"])
def test_multiserver_late_attach_matches_jax(world, tree, jparams, shape):
    """MultiStreamServer over MultiStreamEngine(mesh=), 2 lanes: the round
    loop starts first, then one feeder thread a lane; rank 1's clients
    attach 0.3 and 0.6 s after rank 0 scheduled their first chunks, so that
    rank 1's round waits for an attach (the wait must free the server's
    lock). Each lane's tokens, chunk by chunk, on every rank, equal the JAX
    server's over a JAX MultiStreamEngine on the same mesh."""
    n_lanes, n_chunks = 2, 3
    jmesh = make_mesh({"data": shape.get("data", 1), "model": shape.get("model", 1)})
    sharded, _ = shard_params_serving(jparams, jmesh)
    jms = JaxMS(CFG, sharded, _jax_stream(), GREEDY, n_streams=n_lanes, dtype=jnp.float32,
                mesh=jmesh)
    bs = [PromptBuilder(CFG.tokens, FakeTokenizer(CFG.tokens)) for _ in range(n_lanes)]
    _, end_bias = bs[0].measure_biases()
    jserver = JaxServer(jms, end_bias=end_bias)
    clients = [jserver.attach(seed=b) for b in range(n_lanes)]
    pixels = [C.lane_pixels(b, n_chunks) for b in range(n_lanes)]
    want = [[] for _ in range(n_lanes)]
    for i in range(n_chunks):
        for b, c in enumerate(clients):
            c.submit(C.chunk_segs(bs[b], i), pixel_patches=pixels[b][i], grid_thw=C.GRID)
        assert jserver.run_round_once() == n_lanes
        for b, c in enumerate(clients):
            want[b].append(np.asarray(c.get(timeout=5)[1]))
    got = world.run(C.drive_server, tree, shape, n_lanes, n_chunks, late=0.3)
    for rank, lanes in enumerate(got):
        for b in range(n_lanes):
            assert len(lanes[b]) == n_chunks, (rank, b)
            for i in range(n_chunks):
                np.testing.assert_array_equal(lanes[b][i], want[b][i],
                                              err_msg=f"rank {rank} lane {b} chunk {i}")


DEMO_STREAM = dict(fps=2.0, chunk_duration=1.0, window_size=2, text_round=2, text_sink=4,
                   text_sliding_window=4, max_tokens_per_chunk=4, kv_capacity=2048,
                   prefill_buckets=(128, 256))
DEMO_VIDEO = dict(fps=2.0, video_min_pixels=28 * 28, video_max_pixels=16 * 28 * 28)


def test_multiapp_on_a_mesh_matches_jax(world, tree, jparams, tmp_path):
    """MultiLiveCaptionServer(mesh={"data": 2}) over two videos of different
    resolutions, rank 1's clients attaching late: each lane's caption
    segments, on both ranks, equal the JAX demo's stream_segments on its
    video (greedy); only rank 0 answers HTTP."""
    from streaming_vlm_tpu.demo import app as japp
    from streaming_vlm_tpu.video import ingest as jingest
    from streaming_vlm_tpu_torch.video import ingest

    jingest.build_native()
    ingest.build_native()  # here, so that the ranks do not both build it
    videos = [str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")]
    jingest.write_test_video(videos[0], w=84, h=56, n_frames=40, fps=10)
    jingest.write_test_video(videos[1], w=56, h=56, n_frames=40, fps=10)
    want = [list(japp.stream_segments(
        cfg=CFG, params=jparams, tokenizer=FakeTokenizer(CFG.tokens), video_path=v,
        stream=StreamConfig(**DEMO_STREAM), sampling=GREEDY, video=VideoConfig(**DEMO_VIDEO),
        duration=3.0, dtype=jnp.float32)) for v in videos]
    assert all(len(w) == 3 for w in want)
    got = world.run(C.drive_multiapp, tree, {"data": 2}, videos, DEMO_STREAM, DEMO_VIDEO,
                    3.0, late=0.3)
    (feeds0, port0), (feeds1, port1) = got
    assert port0 and port1 is None
    assert feeds0 == want and feeds1 == want


def test_refusals_that_stay_true(world, tree):
    """Under a mesh: a 'model' axis that does not divide the heads, W4A8
    scale groups that a row split would straddle, and spec decode raise
    ValueError."""
    got = dict(world.run(C.refusals, tree)[0])
    assert set(got) == {"heads", "int4", "spec"}
    assert "does not divide" in got["heads"]
    assert "straddle" in got["int4"]
    assert "spec decode under a mesh" in got["spec"]
