"""The slice: the port's streaming engine and serve loop against the JAX
package's on qwen25_vl_tiny with greedy sampling, both built from one set
of weights through the bridge (f32, CPU; the kernels' plain versions)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu.config import SamplingConfig, StreamConfig, qwen25_vl_tiny
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.serve import StreamingSession as JaxSession
from streaming_vlm_tpu.streaming.engine import StreamingEngine as JaxEngine
from streaming_vlm_tpu.streaming.protocol import FakeTokenizer, PromptBuilder
from streaming_vlm_tpu.video.ingest import patchify_frames
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.serve import streaming_inference_frames
from streaming_vlm_tpu_torch.streaming import protocol as tp
from streaming_vlm_tpu_torch.streaming.engine import StreamingEngine

CFG = qwen25_vl_tiny()
TOK = CFG.tokens
GRID = (1, 4, 4)  # 4 llm tokens per chunk
PATCH_DIM = CFG.vision.in_channels * CFG.vision.temporal_patch_size * CFG.vision.patch_size**2
GREEDY = SamplingConfig(do_sample=False, repetition_penalty=1.05)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def both():
    params = jm.init_params(CFG, jax.random.PRNGKey(7), dtype=jnp.float32)
    return params, from_jax_params(CFG, jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("pos_mode", ["shrink", "append"])
def test_engine_matches_jax_across_evictions(both, pos_mode):
    """7 chunks, text/visual rounds of 2 and a 4+3 previous-text sink/window:
    relocation, vision pruning and the sink/window cut all fire. Greedy
    tokens, surviving ids, cached / uncached_tail and positions must agree."""
    params, model = both
    stream = StreamConfig(
        text_round=2, window_size=2, chunk_duration=1, text_sink=4, text_sliding_window=3,
        max_tokens_per_chunk=8, kv_capacity=1024, prefill_buckets=(64, 128, 256),
        pos_mode=pos_mode,
    )
    jeng = JaxEngine(CFG, params, stream, GREEDY, dtype=jnp.float32)
    teng = StreamingEngine(CFG, model, stream, GREEDY, dtype=torch.float32)
    ftok = FakeTokenizer(TOK)
    jb, tb = PromptBuilder(TOK, ftok), tp.PromptBuilder(TOK, ftok)
    _, end_bias = jb.measure_biases()
    n_vid = GRID[0] * (GRID[1] // 2) * (GRID[2] // 2)
    rng = np.random.default_rng(3)
    evictions = 0
    for i in range(7):
        px = (rng.normal(size=(int(np.prod(GRID)), PATCH_DIM)) * 0.1).astype(np.float32)

        def segs(b):
            out = []
            if i == 0:
                out.append(b.system_segment())
                out.extend(b.previous_text_segments("hello prev"))
                out.extend(b.user_turn_segments(0, i, i + 1, n_vid, GRID, 1.0, query="watch this"))
            else:
                out.extend(b.user_turn_segments(i, i, i + 1, n_vid, GRID, 1.0))
            return out + b.assistant_open_segments(i)

        gj, _ = jeng.process_chunk(segs(jb), px, GRID)
        gt, _ = teng.process_chunk(segs(tb), px, GRID)
        np.testing.assert_array_equal(gt, gj, err_msg=f"generation diverged at chunk {i}")
        jeng.commit_assistant(gj, end_bias, i)
        teng.commit_assistant(gt, end_bias, i)
        evictions += teng.cached_after_evict < teng.cached_before_evict
        np.testing.assert_array_equal(teng.table.token_ids(), jeng.table.token_ids())
        assert (teng.cached, teng.uncached_tail) == (jeng.cached, jeng.uncached_tail)
        np.testing.assert_allclose(teng._positions(), jeng._positions(), atol=1e-5)
    assert evictions >= 2


def test_frames_entry_point_matches_jax_session(both, tmp_path):
    """streaming_inference_frames over uint8 frames == the JAX session fed
    the same patches chunk by chunk (greedy), with kv bounded by eviction
    and one chunk's answer forced to ground truth (rollback + re-prefill)."""
    params, model = both
    stream = StreamConfig(
        window_size=3, text_round=3, text_sink=8, text_sliding_window=8,
        max_tokens_per_chunk=6, kv_capacity=512, prefill_buckets=(64, 128),
    )
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (2, 56, 56, 3), dtype=np.uint8) for _ in range(6)]
    gt = {"Time=2.0-3.0s": "a goal"}
    vtt = str(tmp_path / "out.vtt")
    responses, times = streaming_inference_frames(
        cfg=CFG, model=model, tokenizer=FakeTokenizer(TOK), frames=frames, stream=stream,
        sampling=GREEDY, output_dir=vtt, time_test=True, quiet=True, gt_lookup=gt,
    )
    sess = JaxSession(CFG, params, FakeTokenizer(TOK), stream=stream, sampling=GREEDY,
                      dtype=jnp.float32)
    for i, f in enumerate(frames):
        px, grid = patchify_frames(f, patch_size=14, temporal_patch_size=2, merge_size=2)
        forced = None
        if i == 2:
            forced = np.asarray(sess.builder.encode("a goal<|im_end|>"), np.int32)
        text, _ = sess.run_chunk(i, float(i), pixel_patches=px, grid_thw=grid,
                                 forced_response_ids=forced)
        clean = text[:-4] if text.endswith(" ...") else text
        assert responses[i]["response"] == clean, f"chunk {i}"
        assert times[i]["kv"] == sess.engine.cached
    assert len(responses) == 6
    assert max(t["kv"] for t in times) <= stream.kv_capacity
    assert any(t["kv_post_evict"] < t["kv_pre_evict"] for t in times)
    assert open(vtt).read().startswith("WEBVTT")


def test_video_entry_point_matches_jax(both, tmp_path):
    """streaming_inference over a video file (native FFmpeg ingest) == the
    JAX package's streaming_inference on the same file (greedy)."""
    from streaming_vlm_tpu.serve import streaming_inference as jax_streaming_inference
    from streaming_vlm_tpu.video import ingest
    from streaming_vlm_tpu_torch.serve import streaming_inference

    params, model = both
    path = str(tmp_path / "clip.mp4")
    ingest.write_test_video(path, w=64, h=48, n_frames=40, fps=10)
    stream = StreamConfig(window_size=2, text_round=2, text_sink=8, text_sliding_window=8,
                          max_tokens_per_chunk=4, kv_capacity=2048, prefill_buckets=(256,))
    kw = dict(cfg=CFG, tokenizer=FakeTokenizer(TOK), video_path=path, stream=stream,
              sampling=GREEDY, duration=4.0, quiet=True)
    ref = jax_streaming_inference(params=params, dtype=jnp.float32, **kw)
    got = streaming_inference(model=model, **kw)
    assert [r["response"] for r in got] == [r["response"] for r in ref]
    assert len(got) == 4


def test_capacity_guard_leaves_engine_usable(both):
    _, model = both
    stream = StreamConfig(max_tokens_per_chunk=4, kv_capacity=60, prefill_buckets=(64,))
    eng = StreamingEngine(CFG, model, stream, GREEDY, dtype=torch.float32)
    b = tp.PromptBuilder(TOK, FakeTokenizer(TOK))
    segs = [b.system_segment()] + b.assistant_open_segments(0)
    with pytest.raises(ValueError, match="capacity exceeded"):
        eng.process_chunk(segs)  # the 64-slot prefill block alone exceeds 60
    assert eng.cached == 0 and eng.table.total_len() == 0


def test_serve_imports_without_jax():
    code = (
        "import sys; import streaming_vlm_tpu_torch.serve, streaming_vlm_tpu_torch.models.bridge; "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)
