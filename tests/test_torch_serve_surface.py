"""The rest of the single-stream serving surface, on the port's session and
the JAX package's side by side (qwen25_vl_tiny, f32, CPU, greedy, one set of
weights through the bridge), replaying tests/test_serve.py's scenarios: qa
injection, ground-truth forcing with a question, uint8 frames patchified on
the device, recompute mode (against the JAX session and against a
full-forward oracle, the property of tests/test_streaming.py's
test_recompute_mode_matches_full_forward), `skip_first_chunk`, `emit_json`,
`trace_dir`, `eos_threshold`, `prewarm` (single and multi-stream) and
`caption_clip`."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu import serve as jserve
from streaming_vlm_tpu.config import SamplingConfig, StreamConfig, VideoConfig, qwen25_vl_tiny
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.streaming.engine import StreamingEngine as JaxEngine
from streaming_vlm_tpu.streaming.multistream import MultiStreamEngine as JaxMultiStream
from streaming_vlm_tpu.streaming.protocol import FakeTokenizer, PromptBuilder
from streaming_vlm_tpu.video import ingest as jingest
from streaming_vlm_tpu_torch import serve
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.models.qwen25_vl import model as tm
from streaming_vlm_tpu_torch.streaming import protocol as tp
from streaming_vlm_tpu_torch.streaming.engine import StreamingEngine
from streaming_vlm_tpu_torch.streaming.multistream import MultiStreamEngine
from streaming_vlm_tpu_torch.video.ingest import patchify_frames

CFG = qwen25_vl_tiny()
TOK = CFG.tokens
GRID = (1, 4, 4)
N_VID = 4
PATCH_DIM = CFG.vision.in_channels * CFG.vision.temporal_patch_size * CFG.vision.patch_size**2
GREEDY = SamplingConfig(do_sample=False, repetition_penalty=1.05)
# eviction from chunk 2 on; one bucket switch when a question lands
STREAM = StreamConfig(window_size=2, text_round=2, text_sink=8, text_sliding_window=8,
                      max_tokens_per_chunk=4, kv_capacity=1024, prefill_buckets=(64, 128, 256))
QUESTION = " what exactly is happening in this scene right now please?"
VIDEO = VideoConfig(fps=2.0, video_min_pixels=28 * 28, video_max_pixels=16 * 28 * 28)


@pytest.fixture(scope="module")
def both():
    params = jm.init_params(CFG, jax.random.PRNGKey(2), dtype=jnp.float32)
    return params, from_jax_params(CFG, jax.tree_util.tree_map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(9)
    return [rng.integers(0, 256, (2, 56, 56, 3), dtype=np.uint8) for _ in range(5)]


@pytest.fixture(scope="module")
def video_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("surface") / "clip.mp4")
    jingest.build_native()
    jingest.write_test_video(path, w=84, h=56, n_frames=60, fps=10)
    return path


def _sessions(both, stream=STREAM, **kw):
    params, model = both
    js = jserve.StreamingSession(CFG, params, FakeTokenizer(TOK), stream=stream, sampling=GREEDY,
                                 dtype=jnp.float32, **kw)
    ts = serve.StreamingSession(CFG, model, FakeTokenizer(TOK), stream=stream, sampling=GREEDY,
                                dtype=torch.float32, **kw)
    return js, ts


def _drive(session, frames, *, route="patches", questions=None, forced=None):
    """Chunk by chunk through session.run_chunk: (generated ids, table ids,
    cached) after each chunk."""
    out = []
    for i, f in enumerate(frames):
        kw = dict(question=(questions or {}).get(i, ""))
        if forced and i in forced:
            kw["forced_response_ids"] = np.asarray(session.builder.encode(forced[i]), np.int32)
        if route == "frames":
            kw.update(frames_u8=f, grid_thw=GRID)
        else:
            px, grid = patchify_frames(f, patch_size=14, temporal_patch_size=2, merge_size=2)
            kw.update(pixel_patches=px, grid_thw=grid)
        _, gen = session.run_chunk(i, float(i), **kw)
        out.append((np.asarray(gen).tolist(), session.engine.table.token_ids().tolist(),
                    session.engine.cached))
    return out


@pytest.mark.parametrize("route", ["patches", "frames"])
def test_qa_injection_matches_jax(both, frames, route):
    """A question at chunk 2 (which moves it from the 64 to the 128 bucket):
    the same prompt ids in the table and the same greedy tokens, with the
    chunk's video as host patches or as uint8 frames patchified on the
    device (frames_u8)."""
    js, ts = _sessions(both)
    got = _drive(ts, frames, route=route, questions={2: QUESTION})
    want = _drive(js, frames, route=route, questions={2: QUESTION})
    assert got == want
    q_ids = FakeTokenizer(TOK)(QUESTION)
    ids = got[2][1]
    assert any(ids[j : j + len(q_ids)] == q_ids for j in range(len(ids)))


def test_gt_forcing_with_a_question_matches_jax(both, frames):
    js, ts = _sessions(both)
    kw = dict(questions={1: QUESTION, 3: " and now?"}, forced={1: "a goal<|im_end|>",
                                                              3: "wide<|im_end|>"})
    got, want = _drive(ts, frames, **kw), _drive(js, frames, **kw)
    assert got == want
    forced = FakeTokenizer(TOK)("a goal<|im_end|>")
    assert got[1][0] == forced


RECOMPUTE = StreamConfig(text_round=2, window_size=2, chunk_duration=1, text_sink=None,
                         text_sliding_window=None, max_tokens_per_chunk=4, kv_capacity=1024,
                         prefill_buckets=(64, 128, 256, 512))


@pytest.mark.parametrize("route", ["patches", "frames"])
def test_recompute_matches_jax_session(both, frames, route):
    """Recompute mode: the cache is dropped each chunk and the window's
    videos re-encoded; the same tokens and tables as the JAX session (the
    JAX session re-encodes host patches; the port also keeps frames)."""
    js, ts = _sessions(both, stream=RECOMPUTE, recompute=True)
    got = _drive(ts, frames, route=route)
    want = _drive(js, frames)
    assert got == want
    assert len(ts._recent_videos) == RECOMPUTE.visual_round


def test_recompute_matches_full_forward(both, frames):
    """The port's recompute session against a naive oracle that runs the
    port's forward_full over the surviving ids and every surviving video
    for each decoded token (greedy with the repetition penalty)."""
    _, model = both
    ts = serve.StreamingSession(CFG, model, FakeTokenizer(TOK), stream=RECOMPUTE,
                                sampling=GREEDY, dtype=torch.float32, recompute=True)
    recent = []
    for i, f in enumerate(frames[:4]):
        px, grid = patchify_frames(f, patch_size=14, temporal_patch_size=2, merge_size=2)
        _, gen = ts.run_chunk(i, float(i), pixel_patches=px, grid_thw=grid)
        recent = (recent + [px])[-RECOMPUTE.visual_round:]
        ids_full = ts.engine.table.token_ids()
        cur = ids_full[: len(ids_full) - len(gen)]
        pix = torch.from_numpy(np.concatenate(recent))
        out = []
        for _ in range(RECOMPUTE.max_tokens_per_chunk):
            logits = tm.forward_full(
                CFG, model, cur, pixel_patches=pix, video_grid_thw=np.array([list(GRID)] * len(recent)),
                second_per_grid_ts=[1.0] * len(recent))[-1].numpy()
            presence = np.zeros(CFG.text.vocab_size, bool)
            presence[cur] = True
            scores = np.where(logits > 0, logits / 1.05, logits * 1.05)
            tok = int(np.argmax(np.where(presence, scores, logits)))
            out.append(tok)
            cur = np.concatenate([cur, [tok]]).astype(np.int32)
            if tok == TOK.im_end:
                break
        if out[-1] != TOK.im_end:
            out.append(TOK.im_end)
        assert np.asarray(gen).tolist() == out, f"chunk {i}"
    assert ts.engine.cached > 0


def test_recompute_entry_point_matches_jax_session(both, frames):
    """streaming_inference_frames(recompute=True) == the JAX recompute
    session fed the same patches."""
    params, model = both
    responses = serve.streaming_inference_frames(
        cfg=CFG, model=model, tokenizer=FakeTokenizer(TOK), frames=frames, stream=RECOMPUTE,
        sampling=GREEDY, quiet=True, recompute=True)
    js, _ = _sessions(both, stream=RECOMPUTE, recompute=True)
    for i, f in enumerate(frames):
        px, grid = patchify_frames(f, patch_size=14, temporal_patch_size=2, merge_size=2)
        text, _ = js.run_chunk(i, float(i), pixel_patches=px, grid_thw=grid)
        assert responses[i]["response"] == (text[:-4] if text.endswith(" ...") else text)


@pytest.fixture(scope="module")
def video_runs(both, video_path):
    """streaming_inference over the clip on both sides, starting 1.5 chunks
    in, with NDJSON on stdout: (port responses, its stdout, JAX responses,
    JAX stdout)."""
    import contextlib
    import io

    params, model = both
    kw = dict(cfg=CFG, tokenizer=FakeTokenizer(TOK), video_path=video_path, stream=STREAM,
              sampling=GREEDY, video=VIDEO, duration=3.0, skip_first_chunk=1.5, quiet=True,
              emit_json=True)
    runs = []
    for fn, extra in ((serve.streaming_inference, dict(model=model)),
                      (jserve.streaming_inference, dict(params=params, dtype=jnp.float32))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runs.append(fn(**kw, **extra))
        runs.append(buf.getvalue())
    return runs


def test_skip_first_chunk_start_times(video_runs):
    got, _, want, _ = video_runs
    assert [r["start_time"] for r in got] == [1.5, 2.5, 3.5]
    assert got == want


def test_emit_json_lines_byte_equal(video_runs):
    _, got, _, want = video_runs
    assert got == want and got.count("\n") == 3
    first = json.loads(got.splitlines()[0])
    assert first["type"] == "segment" and first["start"] == 1.5 and first["end"] == 2.5


def test_trace_dir_writes_a_trace(both, video_runs, video_path, tmp_path):
    """The whole run under torch.profiler, written as a Chrome trace; the
    responses are those of the untraced run. A trace that cannot be
    written raises."""
    _, model = both
    kw = dict(cfg=CFG, model=model, tokenizer=FakeTokenizer(TOK), video_path=video_path,
              stream=STREAM, sampling=GREEDY, video=VIDEO, duration=3.0, skip_first_chunk=1.5,
              quiet=True)
    d = tmp_path / "trace"
    got = serve.streaming_inference(trace_dir=str(d), **kw)
    assert got == video_runs[0]
    (path,) = glob.glob(str(d / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    with pytest.raises(OSError):
        serve.streaming_inference(trace_dir=str(blocker / "sub"), **kw)


def _first_chunk(builder):
    segs = [builder.system_segment()]
    segs += builder.previous_text_segments("hello prev")
    segs += builder.user_turn_segments(0, 0.0, 1.0, N_VID, GRID, 1.0, query="watch this")
    return segs + builder.assistant_open_segments(0)


def test_eos_threshold_matches_jax(both):
    """The threshold gate (token suppressed while its probability <= base +
    step * decode_step): gating the token that the ungated chunk emits first
    changes the chunk's tokens, and both engines emit the same ones, for a
    fixed and a growing threshold."""
    params, model = both
    px = (np.random.default_rng(3).normal(size=(16, PATCH_DIM)) * 0.1).astype(np.float32)

    def run(eos_threshold, side):
        if side == "jax":
            eng = JaxEngine(CFG, params, STREAM, GREEDY, dtype=jnp.float32)
            b = PromptBuilder(TOK, FakeTokenizer(TOK))
        else:
            eng = StreamingEngine(CFG, model, STREAM, GREEDY, dtype=torch.float32)
            b = tp.PromptBuilder(TOK, FakeTokenizer(TOK))
        gen, _ = eng.process_chunk(_first_chunk(b), px, GRID, max_new=8,
                                   eos_threshold=eos_threshold)
        return np.asarray(gen).tolist()

    plain = run(None, "port")
    assert plain == run(None, "jax") and len(plain) >= 2
    # a fixed threshold over the first token: suppressed from step 0 on
    gate = (plain[0], 0.5, 0.0)
    got = run(gate, "port")
    assert got == run(gate, "jax") and got[0] != plain[0] and plain[0] not in got
    # a threshold growing from 0 over the second token: free at step 0,
    # suppressed from step 1 on
    gate = (plain[1], 0.0, 0.5)
    got = run(gate, "port")
    assert got == run(gate, "jax") and got[0] == plain[0] and plain[1] not in got[1:]
    assert got != plain
    # a zero threshold suppresses nothing
    assert run((plain[0], 0.0, 0.0), "port") == plain


def _drive_engine(engine, builder, n, question_at=None):
    rng = np.random.default_rng(0)
    _, end_bias = builder.measure_biases()
    for i in range(n):
        px = (rng.normal(size=(16, PATCH_DIM)) * 0.1).astype(np.float32)
        q = QUESTION if i == question_at else ""
        segs = []
        if i == 0:
            segs.append(builder.system_segment())
            segs.extend(builder.previous_text_segments("prev"))
            segs.extend(builder.user_turn_segments(0, 0.0, 1.0, N_VID, GRID, 1.0, query="watch",
                                                   question=q))
        else:
            segs.extend(builder.user_turn_segments(i, float(i), i + 1.0, N_VID, GRID, 1.0,
                                                   question=q))
        segs.extend(builder.assistant_open_segments(i))
        gen, _ = engine.process_chunk(segs, px, GRID)
        engine.commit_assistant(gen, end_bias, i)
    return engine.table.token_ids()


PREWARM = dict(grids=(GRID,), vision="patches", include_no_vision=True, buckets=(64, 128),
               max_new_list=(4,))


def test_prewarm_equals_a_cold_start(both):
    """A prewarmed engine (frames and patches encodes, every bucket and
    vision variant run at cached 0) streams exactly what a cold one does,
    across evictions and a bucket switch; its sampling generator is
    untouched; the variant count equals the JAX engine's."""
    params, model = both
    sampled = SamplingConfig(do_sample=True, seed=5)

    def engine():
        return StreamingEngine(CFG, model, STREAM, sampled, dtype=torch.float32)

    warm = engine()
    state = warm.generator.get_state()
    n = warm.prewarm(**dict(PREWARM, vision="both"))
    assert torch.equal(warm.generator.get_state(), state)
    assert warm.cached == 0 and warm.uncached_tail == 0 and warm.table.total_len() == 0
    jn = JaxEngine(CFG, params, STREAM, GREEDY, dtype=jnp.float32).prewarm(**PREWARM)
    assert n == jn == 4
    b = tp.PromptBuilder(TOK, FakeTokenizer(TOK))
    np.testing.assert_array_equal(_drive_engine(warm, b, 5, question_at=3),
                                  _drive_engine(engine(), b, 5, question_at=3))


def test_upload_frames_stays_on_the_engine_device(both):
    _, model = both
    eng = StreamingEngine(CFG, model, STREAM, GREEDY, dtype=torch.float32)
    f = np.zeros((2, 56, 56, 3), np.uint8)
    t = eng.upload_frames(f)
    assert t.device == eng.device and t.dtype == torch.uint8 and t.shape == f.shape


def test_multistream_prewarm(both):
    """MultiStreamEngine.prewarm: the JAX engine's variant count, the lanes'
    generators untouched, and rounds after it equal to a cold engine's."""
    params, model = both
    sampled = SamplingConfig(do_sample=True, seed=5)
    kw = dict(grids=(GRID,), include_no_vision=True, buckets=(64,), max_new_list=(4,))
    warm = MultiStreamEngine(CFG, model, STREAM, sampled, n_streams=2, dtype=torch.float32)
    states = [g.get_state() for g in warm.generators]
    n = warm.prewarm(**kw)
    assert all(torch.equal(g.get_state(), s) for g, s in zip(warm.generators, states))
    jms = JaxMultiStream(CFG, params, STREAM, GREEDY, n_streams=2, dtype=jnp.float32)
    assert n == jms.prewarm(**kw) == 2
    cold = MultiStreamEngine(CFG, model, STREAM, sampled, n_streams=2, dtype=torch.float32)
    rng = np.random.default_rng(1)
    builders = [tp.PromptBuilder(TOK, FakeTokenizer(TOK)) for _ in range(2)]
    _, end_bias = builders[0].measure_biases()
    for i in range(3):
        px = (rng.normal(size=(2, 16, PATCH_DIM)) * 0.1).astype(np.float32)
        segs = [(([b.system_segment()] + b.previous_text_segments("prev")
                  + b.user_turn_segments(0, 0.0, 1.0, N_VID, GRID, 1.0, query="go"))
                 if i == 0 else b.user_turn_segments(i, float(i), i + 1.0, N_VID, GRID, 1.0))
                + b.assistant_open_segments(i) for b in builders]
        outs = [ms.process_round(segs, vis_embeds=ms.encode_round(px, GRID), grid_thw=GRID)
                for ms in (warm, cold)]
        assert [o[0].tolist() for o in outs[0]] == [o[0].tolist() for o in outs[1]]
        for ms, out in zip((warm, cold), outs):
            ms.commit_assistant([o[0] for o in out], end_bias, i)


def test_multistream_eos_threshold_gates_each_lane(both):
    """process_round_async(eos_threshold=...) on two lanes: each lane's
    tokens are those of a solo engine with the same gate (whose tokens
    test_eos_threshold_matches_jax holds to the JAX engine's), and the gate
    changes them."""
    _, model = both
    px = (np.random.default_rng(4).normal(size=(2, 16, PATCH_DIM)) * 0.1).astype(np.float32)

    def lanes(gate):
        ms = MultiStreamEngine(CFG, model, STREAM, GREEDY, n_streams=2, dtype=torch.float32)
        bs = [tp.PromptBuilder(TOK, FakeTokenizer(TOK)) for _ in range(2)]
        out = ms.process_round([_first_chunk(b) for b in bs], vis_embeds=ms.encode_round(px, GRID),
                               grid_thw=GRID, max_new=6, eos_threshold=gate)
        return [np.asarray(o[0]).tolist() for o in out]

    def solo(gate, b):
        eng = StreamingEngine(CFG, model, STREAM, GREEDY, dtype=torch.float32)
        gen, _ = eng.process_chunk(_first_chunk(tp.PromptBuilder(TOK, FakeTokenizer(TOK))), px[b],
                                   GRID, max_new=6, eos_threshold=gate)
        return np.asarray(gen).tolist()

    plain = lanes(None)
    gate = (plain[0][0], 0.5, 0.0)
    got = lanes(gate)
    assert got == [solo(gate, 0), solo(gate, 1)] and got != plain
    assert all(gate[0] not in g for g in got)


def test_caption_clip_matches_jax(both, video_path):
    params, model = both
    kw = dict(cfg=CFG, tokenizer=FakeTokenizer(TOK), video_path=video_path, query="describe",
              fps=1.0, max_frames=4, max_new_tokens=4,
              video=VideoConfig(fps=1.0, video_min_pixels=28 * 28, video_max_pixels=16 * 28 * 28))
    got = serve.caption_clip(model=model, **kw)
    want = jserve.caption_clip(params=params, **kw)
    assert got == want and len(got.split()) >= 1
