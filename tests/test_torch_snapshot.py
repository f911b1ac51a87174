"""Live-stream snapshots in the port (streaming/snapshot.py), mirroring
tests/test_snapshot.py, and against the JAX package's snapshots:

* the port's snapshot dict equals the JAX engine's after the same chunks
  (table, accounting, positions and ids exactly; the arena prefix within
  f32 noise: 1e-5 for a float arena, one quantization step of an int8 one);
* restore into a fresh engine continues bitwise (the uninterrupted port
  engine's tokens) over {float, int8} arenas x {shrink, append}
  positions, with the pre-rotated copy off (kernel K3's plain version) and
  requantized (rot_quant="int8"), at several cut points; sampled, after a
  file round trip and into a larger capacity; a mismatched representation
  and a sampling restore of a foreign "rng" are refused by name;
* `resume_snapshot` through `streaming_inference_frames`; a session in
  recompute mode refuses to snapshot;
* solo -> multi-stream lane -> solo migration;
* a file written by the JAX package's save_snapshot restores into the port
  and continues with the JAX engine's greedy tokens.

Tiny f32 model on the CPU (the kernels' plain versions); vision embeddings
are given, not encoded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_cpu_thread, warm_cpu_math  # noqa: F401  (autouse fixtures)

from streaming_vlm_tpu.config import SamplingConfig, StreamConfig, qwen25_vl_tiny
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.streaming.engine import StreamingEngine as JaxEngine
from streaming_vlm_tpu.streaming.protocol import FakeTokenizer, PromptBuilder
from streaming_vlm_tpu.streaming.snapshot import save_snapshot as jax_save_snapshot
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.serve import StreamingSession, streaming_inference_frames
from streaming_vlm_tpu_torch.streaming import protocol as tp
from streaming_vlm_tpu_torch.streaming.engine import StreamingEngine
from streaming_vlm_tpu_torch.streaming.multistream import MultiStreamEngine
from streaming_vlm_tpu_torch.streaming.snapshot import (
    SNAPSHOT_VERSION,
    load_snapshot,
    save_snapshot,
    validate_snapshot,
)

CFG = qwen25_vl_tiny()
TOK = CFG.tokens
GRID = (1, 4, 4)
N_VID = 4
N_TOTAL = 6  # past text_round=3 / window_size=2: evictions run
N_CUT = 3
GREEDY = SamplingConfig(do_sample=False, repetition_penalty=1.05)
SAMPLED = SamplingConfig(do_sample=True, temperature=0.9, repetition_penalty=1.05, seed=3)


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
def vis():
    rng = np.random.default_rng(5)
    return rng.normal(size=(N_TOTAL, 2, N_VID, CFG.text.hidden_size)).astype(np.float32) * 0.1


def _segs(builder, i):
    out = []
    if i == 0:
        out.append(builder.system_segment())
        out.extend(builder.previous_text_segments("prev text"))
        out.extend(builder.user_turn_segments(0, 0.0, 1.0, N_VID, GRID, 1.0, query="describe"))
    else:
        out.extend(builder.user_turn_segments(i, float(i), float(i + 1), N_VID, GRID, 1.0))
    return out + builder.assistant_open_segments(i)


def _drive(engine, builder, end_bias, i0, i1, vis, b=0, jax_side=False):
    gens = []
    for i in range(i0, i1):
        ve = jnp.asarray(vis[i, b]) if jax_side else torch.from_numpy(vis[i, b])
        gen, _ = engine.process_chunk(_segs(builder, i), grid_thw=GRID, vis_embeds=ve)
        engine.commit_assistant(gen, end_bias, i)
        assert engine.cached + engine.uncached_tail == engine.table.total_len()
        gens.append(np.asarray(gen).tolist())
    return gens


def _fresh(model, stream, sampling=GREEDY):
    eng = StreamingEngine(CFG, model, stream, sampling, dtype=torch.float32)
    builder = tp.PromptBuilder(TOK, FakeTokenizer(TOK))
    return eng, builder, builder.measure_biases()[1]


@pytest.fixture(scope="module")
def jax_run(both, vis, tmp_path_factory):
    """The JAX engine over N_CUT chunks, float and int8 arenas: its snapshot
    dict, the file its save_snapshot wrote, and its greedy tail to
    N_TOTAL."""
    params, _ = both
    out = {}
    for kv in ("none", "int8"):
        eng = JaxEngine(CFG, params, _stream(kv_quant=kv), GREEDY, dtype=jnp.float32)
        builder = PromptBuilder(TOK, FakeTokenizer(TOK))
        eb = builder.measure_biases()[1]
        head = _drive(eng, builder, eb, 0, N_CUT, vis, jax_side=True)
        snap = eng.snapshot()
        path = str(tmp_path_factory.mktemp("jax") / f"stream_{kv}.npz")
        jax_save_snapshot(snap, path)
        out[kv] = dict(head=head, snap=snap, path=path,
                       tail=_drive(eng, builder, eb, N_CUT, N_TOTAL, vis, jax_side=True))
    return out


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_snapshot_dict_matches_jax(both, vis, jax_run, kv):
    _, model = both
    eng, builder, eb = _fresh(model, _stream(kv_quant=kv))
    assert _drive(eng, builder, eb, 0, N_CUT, vis) == jax_run[kv]["head"]
    got, want = eng.snapshot(), jax_run[kv]["snap"]
    assert set(got) == set(want)
    for k in ("version", "kv_quant", "pos_mode", "all_text", "cached", "uncached_tail",
              "chunk_index", "next_pos"):
        assert got[k] == want[k], k
    assert got["version"] == SNAPSHOT_VERSION
    np.testing.assert_array_equal(got["ids"], np.asarray(want["ids"]))
    assert got["ids"].dtype == np.int32
    np.testing.assert_allclose(got["pos"], np.asarray(want["pos"]), atol=1e-5)
    assert len(got["table"]) == len(want["table"])
    for g, w in zip(got["table"], want["table"]):
        assert (g["kind"], g["round"], g["grid_thw"], g["second_per_grid_t"]) == (
            w["kind"], w["round"], w["grid_thw"], w["second_per_grid_t"])
        np.testing.assert_array_equal(g["ids"], w["ids"])
    for name in ("k", "v"):
        if kv == "int8":
            gq, wq = got[name], {k: np.asarray(v) for k, v in want[name].items()}
            assert gq["q"].dtype == np.int8 and gq["q"].shape == wq["q"].shape
            step = float(wq["s"].max())
            np.testing.assert_allclose(gq["q"] * gq["s"][..., None], wq["q"] * wq["s"][..., None],
                                       atol=1.01 * step)
        else:
            np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=1e-5)
    validate_snapshot(got, _stream(kv_quant=kv))


RESTORE_CASES = [  # kv_quant, pos_mode, prerotate_arena, rot_quant, cut
    ("none", "shrink", True, "none", 1),
    ("none", "shrink", True, "none", 3),
    ("none", "shrink", True, "none", 5),
    ("none", "append", True, "none", 3),
    ("none", "shrink", False, "none", 3),
    ("int8", "shrink", True, "none", 3),
    ("int8", "append", True, "none", 3),
    ("int8", "append", False, "none", 3),
    ("int8", "shrink", True, "int8", 3),
]


@pytest.mark.parametrize("kv,pos_mode,prerotate,rot_quant,cut", RESTORE_CASES,
                         ids=["-".join(map(str, c)) for c in RESTORE_CASES])
def test_restore_continues_bitwise(both, vis, kv, pos_mode, prerotate, rot_quant, cut):
    """Snapshot at chunk `cut`, restore into a fresh engine, continue: the
    tail equals the uninterrupted engine's (before eviction starts, when it
    starts, in steady eviction)."""
    _, model = both
    stream = _stream(kv_quant=kv, pos_mode=pos_mode, prerotate_arena=prerotate,
                     rot_quant=rot_quant)
    eng, builder, eb = _fresh(model, stream)
    head = _drive(eng, builder, eb, 0, cut, vis)
    snap = eng.snapshot()
    ref_tail = _drive(eng, builder, eb, cut, N_TOTAL, vis)
    eng2, builder2, eb2 = _fresh(model, stream)
    eng2.restore(snap)
    assert eng2.chunk_index == cut and eng2.cached == snap["cached"]
    assert eng2.cached + eng2.uncached_tail == eng2.table.total_len()
    assert _drive(eng2, builder2, eb2, cut, N_TOTAL, vis) == ref_tail
    assert head


def test_snapshot_is_a_copy(both, vis):
    """A snapshot does not alias the engine's arena (on the CPU a tensor's
    .numpy() shares its memory): streaming on leaves it unchanged."""
    _, model = both
    for kv in ("none", "int8"):
        eng, builder, eb = _fresh(model, _stream(kv_quant=kv))
        _drive(eng, builder, eb, 0, 2, vis)
        snap = eng.snapshot()
        frozen = {k: ({kk: np.array(vv) for kk, vv in v.items()} if isinstance(v, dict)
                      else np.array(v)) for k, v in snap.items() if k in ("k", "v", "ids", "pos")}
        eng.restore(snap)  # and restoring reads it without writing it
        _drive(eng, builder, eb, 2, N_TOTAL, vis)
        for k, want in frozen.items():
            got = snap[k]
            for a, b in ((got, want),) if not isinstance(want, dict) else (
                    (got[x], want[x]) for x in want):
                np.testing.assert_array_equal(a, b, err_msg=f"{kv} {k}")


def test_restore_sampled_continuation(both, vis):
    """do_sample: the generator's state rides the snapshot, so the restored
    continuation is token for token the uninterrupted one."""
    _, model = both
    eng, builder, eb = _fresh(model, _stream(), SAMPLED)
    _drive(eng, builder, eb, 0, N_CUT, vis)
    snap = eng.snapshot()
    assert snap["rng"].dtype == np.uint8
    ref_tail = _drive(eng, builder, eb, N_CUT, N_TOTAL, vis)
    eng2, builder2, eb2 = _fresh(model, _stream(), SAMPLED)
    eng2.restore(snap)
    assert _drive(eng2, builder2, eb2, N_CUT, N_TOTAL, vis) == ref_tail


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_file_roundtrip(both, vis, tmp_path, kv):
    """save_snapshot -> load_snapshot (.npz, no pickle) is lossless for the
    continuation."""
    _, model = both
    eng, builder, eb = _fresh(model, _stream(kv_quant=kv))
    _drive(eng, builder, eb, 0, N_CUT, vis)
    path = str(tmp_path / "stream.npz")
    save_snapshot(eng.snapshot(), path)
    ref_tail = _drive(eng, builder, eb, N_CUT, N_TOTAL, vis)
    eng2, builder2, eb2 = _fresh(model, _stream(kv_quant=kv))
    eng2.restore(load_snapshot(path))
    assert _drive(eng2, builder2, eb2, N_CUT, N_TOTAL, vis) == ref_tail


def test_restore_into_larger_capacity(both, vis):
    _, model = both
    eng, builder, eb = _fresh(model, _stream())
    _drive(eng, builder, eb, 0, N_CUT, vis)
    snap = eng.snapshot()
    ref_tail = _drive(eng, builder, eb, N_CUT, N_TOTAL, vis)
    eng2, builder2, eb2 = _fresh(model, _stream(kv_capacity=2048))
    eng2.restore(snap)
    assert _drive(eng2, builder2, eb2, N_CUT, N_TOTAL, vis) == ref_tail


def test_restore_refusals(both, vis, jax_run):
    """A mismatched arena representation or position mode is refused by
    name; so is a sampling restore of an "rng" that is not this generator's
    state (the JAX package's PRNG key), which a greedy engine takes."""
    _, model = both
    eng, builder, eb = _fresh(model, _stream())
    _drive(eng, builder, eb, 0, 1, vis)
    snap = eng.snapshot()
    with pytest.raises(ValueError, match="kv_quant"):
        _fresh(model, _stream(kv_quant="int8"))[0].restore(snap)
    with pytest.raises(ValueError, match="pos_mode"):
        _fresh(model, _stream(pos_mode="append"))[0].restore(snap)
    with pytest.raises(ValueError, match="missing field 'table'"):
        _fresh(model, _stream())[0].restore({k: v for k, v in snap.items() if k != "table"})
    jsnap = jax_run["none"]["snap"]
    with pytest.raises(ValueError, match="'rng'"):
        _fresh(model, _stream(), SAMPLED)[0].restore(jsnap)
    _fresh(model, _stream())[0].restore(jsnap)  # greedy: taken
    sess = StreamingSession(CFG, model, FakeTokenizer(TOK), stream=_stream(), recompute=True,
                            dtype=torch.float32)
    with pytest.raises(ValueError, match="recompute"):
        sess.snapshot()


def test_jax_file_resumes_in_the_port(both, vis, jax_run):
    """A snapshot file written by the JAX package restores into the port's
    engine and continues with the JAX engine's greedy tokens (float and
    int8 arenas)."""
    _, model = both
    for kv in ("none", "int8"):
        eng, builder, eb = _fresh(model, _stream(kv_quant=kv))
        eng.restore(load_snapshot(jax_run[kv]["path"]))
        assert eng.chunk_index == N_CUT
        assert _drive(eng, builder, eb, N_CUT, N_TOTAL, vis) == jax_run[kv]["tail"], kv


def test_streaming_inference_frames_resume(both, tmp_path):
    """resume_snapshot through streaming_inference_frames: the resumed
    responses equal the uninterrupted run's, the VTT keeps every cue, and
    the same frames iterable (the whole stream's) is passed both times."""
    _, model = both
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (2, 56, 56, 3), dtype=np.uint8) for _ in range(6)]
    stream = _stream(prefill_buckets=(64, 128, 256))
    kw = dict(cfg=CFG, model=model, tokenizer=FakeTokenizer(TOK), stream=stream, quiet=True,
              dtype=torch.float32)
    full = streaming_inference_frames(frames=frames, output_dir=str(tmp_path / "full.vtt"), **kw)
    vtt = str(tmp_path / "resumed.vtt")
    streaming_inference_frames(frames=frames[:3], output_dir=vtt, **kw)
    sess = StreamingSession(CFG, model, FakeTokenizer(TOK), stream=stream, dtype=torch.float32)
    from streaming_vlm_tpu_torch.video.ingest import patchify_frames

    for i in range(3):
        v = CFG.vision
        patches, grid = patchify_frames(frames[i], patch_size=v.patch_size,
                                        temporal_patch_size=v.temporal_patch_size,
                                        merge_size=v.spatial_merge_size)
        sess.run_chunk(i, float(i), pixel_patches=patches, grid_thw=grid)
    snap = sess.snapshot()
    tail = streaming_inference_frames(frames=frames, output_dir=vtt, resume_snapshot=snap, **kw)
    assert [r["response"] for r in tail] == [r["response"] for r in full[3:]]
    assert [r["start_time"] for r in tail] == [3.0, 4.0, 5.0]
    assert open(vtt).read().count(" --> ") == 6


def test_migrate_solo_to_lane_and_back(both, vis):
    """A solo stream moves into lane 1 of a 2-lane engine next to a fresh
    client on lane 0, continues bitwise, then moves back out to a solo
    engine and still matches the never-moved control; the other lane and
    the arena rows it owns are untouched by the restore."""
    _, model = both
    stream = _stream(kv_quant="int8")
    ctrl, cb, eb = _fresh(model, stream)
    ctrl_all = _drive(ctrl, cb, eb, 0, N_TOTAL, vis)
    solo, sb, _ = _fresh(model, stream)
    _drive(solo, sb, eb, 0, N_CUT, vis)
    snap = solo.snapshot()

    ms = MultiStreamEngine(CFG, model, stream, GREEDY, n_streams=2, dtype=torch.float32)
    fresh_b = tp.PromptBuilder(TOK, FakeTokenizer(TOK))
    outs = ms.process_round([_segs(fresh_b, 0), None], vis_embeds=torch.from_numpy(
        np.stack([vis[0, 1], vis[0, 1]])), grid_thw=GRID)
    ms.engines[0].commit_assistant(outs[0][0], eb, 0)
    lane0 = (ms.k_arena.q[0].clone(), ms.ids_arena[0].clone())
    ms.restore_lane(1, snap)
    assert torch.equal(ms.k_arena.q[0], lane0[0]) and torch.equal(ms.ids_arena[0], lane0[1])
    lane_b = tp.PromptBuilder(TOK, FakeTokenizer(TOK))
    lane_gens = []
    for j in range(N_TOTAL - N_CUT - 1):
        outs = ms.process_round(
            [_segs(fresh_b, j + 1), _segs(lane_b, N_CUT + j)],
            vis_embeds=torch.from_numpy(np.stack([vis[j + 1, 1], vis[N_CUT + j, 0]])),
            grid_thw=GRID)
        ms.engines[0].commit_assistant(outs[0][0], eb, j + 1)
        ms.engines[1].commit_assistant(outs[1][0], eb, N_CUT + j)
        lane_gens.append(np.asarray(outs[1][0]).tolist())
    assert lane_gens == ctrl_all[N_CUT: N_TOTAL - 1]

    solo2, s2b, _ = _fresh(model, stream)
    solo2.restore(ms.snapshot_lane(1))
    assert _drive(solo2, s2b, eb, N_TOTAL - 1, N_TOTAL, vis) == ctrl_all[N_TOTAL - 1:]


def test_lane_snapshot_carries_the_lane_generator(both, vis):
    """A sampled lane's snapshot holds the lane's generator (not its lane
    engine's unused one): restored into a solo engine, the stream draws
    what the lane would have."""
    _, model = both
    stream = _stream()
    ms = MultiStreamEngine(CFG, model, stream, SAMPLED, n_streams=2, dtype=torch.float32)
    b0, b1 = (tp.PromptBuilder(TOK, FakeTokenizer(TOK)) for _ in range(2))
    eb = b0.measure_biases()[1]
    for i in range(N_CUT):
        outs = ms.process_round([_segs(b0, i), _segs(b1, i)], vis_embeds=torch.from_numpy(
            vis[i]), grid_thw=GRID)
        ms.commit_assistant([o[0] for o in outs], eb, i)
    snap = ms.snapshot_lane(1)
    np.testing.assert_array_equal(snap["rng"], ms.generators[1].get_state().numpy())
    outs = ms.process_round([_segs(b0, N_CUT), _segs(b1, N_CUT)],
                            vis_embeds=torch.from_numpy(vis[N_CUT]), grid_thw=GRID)
    solo, sb, _ = _fresh(model, stream, SAMPLED)
    solo.restore(snap)
    assert _drive(solo, sb, eb, N_CUT, N_CUT + 1, vis, b=1) == [np.asarray(outs[1][0]).tolist()]
