"""The port's streaming SFT dataset (streaming_vlm_tpu_torch/data/dataset.py)
against the JAX package's on the same annotation and clip: examples, turns,
ground truths and the retry path bit for bit; the port's write_test_video
against the JAX package's; and dataset-driven streaming inference with
ground-truth forcing, which must give the JAX function's responses."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import numpy_params, one_cpu_thread  # noqa: F401  (autouse fixture)
from streaming_vlm_tpu import serve as jserve
from streaming_vlm_tpu.config import SamplingConfig as JSampling
from streaming_vlm_tpu.config import StreamConfig as JStream
from streaming_vlm_tpu.config import VideoConfig as JVideo
from streaming_vlm_tpu.config import qwen25_vl_tiny as j_tiny
from streaming_vlm_tpu.data import dataset as jds
from streaming_vlm_tpu.streaming.protocol import FakeTokenizer as JFakeTokenizer
from streaming_vlm_tpu.streaming.segments import scan_token_ranges as j_scan
from streaming_vlm_tpu_torch import serve as tserve
from streaming_vlm_tpu_torch.config import (
    SamplingConfig,
    StreamConfig,
    VideoConfig,
    qwen25_vl_tiny,
)
from streaming_vlm_tpu_torch.data import dataset as tds
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer
from streaming_vlm_tpu_torch.streaming.segments import scan_token_ranges
from streaming_vlm_tpu_torch.video import ingest

JCFG, CFG = j_tiny(), qwen25_vl_tiny()
PIX = dict(fps=2.0, video_min_pixels=28 * 28, video_max_pixels=16 * 28 * 28)

TEXT_STREAM = [
    [0.0, 0.4, "hello"], [0.5, 0.9, "world"], [1.0, 1.4, "this"], [1.5, 1.9, "is"],
    [2.0, 2.4, "a"], [2.5, 2.9, "test"], [3.0, 3.4, "of"], [3.5, 3.9, "streams"],
    [4.0, 4.4, "ok"],
]
QA_STREAM = [[1.0, 2.0, " What is shown?", "A moving gradient."]]


def _conv(video, previous="earlier context words", end=5.0, qa=QA_STREAM):
    return [
        {"role": "user", "content": [{"type": "video", "video": video, "video_start": 0.0,
                                      "video_end": end, "previous": previous}]},
        {"role": "assistant", "content": [{"type": "text", "text_stream": TEXT_STREAM,
                                           "qa_stream": qa}]},
    ]


@pytest.fixture(scope="module")
def annotation(tmp_path_factory):
    """Two lines over one mp4 clip (84x56, 6 s at 10 fps): one with a qa
    injection and previous text, one without either."""
    d = tmp_path_factory.mktemp("data")
    vid = str(d / "clip.mp4")
    ingest.write_test_video(vid, w=84, h=56, n_frames=60, fps=10)
    ann = str(d / "train.jsonl")
    with open(ann, "w") as f:
        f.write(json.dumps(_conv(vid)) + "\n")
        f.write(json.dumps(_conv(vid, previous="", end=3.0, qa=[])) + "\n")
    return ann


def _pair(ann, **kw):
    j = jds.StreamDataset([ann], cfg=JCFG, encode=JFakeTokenizer(JCFG.tokens),
                          video=JVideo(**PIX), **kw)
    t = tds.StreamDataset([ann], cfg=CFG, encode=FakeTokenizer(CFG.tokens),
                          video=VideoConfig(**PIX), **kw)
    return j, t


def _assert_examples_equal(a, b):
    for name in ("input_ids", "labels", "positions", "vision_slots"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.grids == b.grids
    assert len(a.frames) == len(b.frames)
    for x, y in zip(a.frames, b.frames):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("kw", [dict(), dict(text_sink=4, text_sliding_window=4),
                                dict(initial_fps_frames=4, streaming_fps_frames=2)],
                         ids=["plain", "sink_window", "initial4"])
def test_examples_equal_the_jax_dataset(annotation, kw):
    j, t = _pair(annotation, **kw)
    assert len(j) == len(t) == 2
    for i in range(2):
        _assert_examples_equal(j[i], t[i])
    _assert_examples_equal(jds.data_collator([j[0]]), tds.data_collator([t[0]]))


def test_turns_ground_truth_and_helpers_equal(annotation, tmp_path):
    j, t = _pair(annotation)
    jt, jf, jp, jv = j.get_stream(0)
    tt, tf, tp, tv = t.get_stream(0)
    assert [vars(x) for x in jt] == [vars(x) for x in tt]
    assert np.array_equal(jf, tf) and jp == tp and jv == tv
    assert jds.get_ground_truth(j, 0) == tds.get_ground_truth(t, 0)
    for ts, start in ((1.0, 0), (2.2, 1), (9.0, 3), (0.1, 0)):
        assert tds.get_phrase_before_timestamp(TEXT_STREAM, ts, start) == \
            jds.get_phrase_before_timestamp(TEXT_STREAM, ts, start)
    turns = dict(fps=2.0, initial_fps_frames=2, streaming_fps_frames=2)
    for n_frames in (1, 2, 7, 10):
        a = jds.synthesize_stream_turns(TEXT_STREAM, QA_STREAM, 0.5, n_frames, **turns)
        b = tds.synthesize_stream_turns(TEXT_STREAM, QA_STREAM, 0.5, n_frames, **turns)
        assert [vars(x) for x in a] == [vars(x) for x in b]
    ja = jds.build_seek_index(annotation, str(tmp_path / "j_seeks.jsonl"))
    ta = tds.build_seek_index(annotation, str(tmp_path / "t_seeks.jsonl"))
    assert open(ja).read() == open(ta).read()
    ids = t[0].input_ids
    for label in ("user", "assistant", "previous text", "vision", "user_text"):
        assert scan_token_ranges(ids, label, CFG.tokens) == j_scan(ids, label, JCFG.tokens)


def test_retry_and_resample_equal(annotation, tmp_path):
    """A broken sample resamples to the same healthy one on both sides; an
    all-broken dataset raises on both."""
    with open(annotation) as f:
        good = f.readline()
    broken = json.loads(good)
    broken[0]["content"][0]["video"] = "/nonexistent/missing.mp4"
    mixed = str(tmp_path / "mixed.jsonl")
    with open(mixed, "w") as f:
        for line in (json.dumps(broken) + "\n", good, json.dumps(broken) + "\n"):
            f.write(line)
    j, t = _pair(mixed)
    for i in range(3):
        _assert_examples_equal(j[i], t[i])
    allbad = str(tmp_path / "allbad.jsonl")
    with open(allbad, "w") as f:
        f.write(json.dumps(broken) + "\n")
    j, t = _pair(allbad)
    for ds in (j, t):
        with pytest.raises(RuntimeError, match="every resample failed"):
            ds[0]


def test_write_test_video_equals_jax(tmp_path):
    """The port's write_test_video writes the clip the JAX package's does:
    the same frames and timestamps through the port's reader."""
    from streaming_vlm_tpu.video import ingest as jingest

    a, b = str(tmp_path / "port.mp4"), str(tmp_path / "jax.mp4")
    ingest.write_test_video(a, w=56, h=56, n_frames=30, fps=10)
    jingest.write_test_video(b, w=56, h=56, n_frames=30, fps=10)
    ra, rb = ingest.VideoReader(a), ingest.VideoReader(b)
    assert (ra.n_frames, ra.width, ra.height) == (rb.n_frames, rb.width, rb.height) == (30, 56, 56)
    np.testing.assert_array_equal(ra.frame_ts, rb.frame_ts)
    idx = [0, 3, 10, 17, 28]
    np.testing.assert_array_equal(ra.fetch(idx, 56, 56), rb.fetch(idx, 56, 56))
    with pytest.raises(RuntimeError, match="svt_write_test_video failed"):
        ingest.write_test_video(str(tmp_path / "no_dir" / "x.mp4"), w=56, h=56)


def test_dataset_inference_with_gt_equals_jax(annotation):
    """streaming_inference_from_dataset(use_gt=True) on the same weights:
    the same responses and ground truths as the JAX function."""
    np_params = numpy_params(JCFG)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    model = from_jax_params(CFG, np_params, device="cpu")
    kw = dict(fps=2.0, chunk_duration=1.0, window_size=2, text_round=2, text_sink=4,
              text_sliding_window=4, max_tokens_per_chunk=4, kv_capacity=2048,
              prefill_buckets=(128, 256))
    j, t = _pair(annotation)
    jr, jg = jserve.streaming_inference_from_dataset(
        cfg=JCFG, params=params, tokenizer=JFakeTokenizer(JCFG.tokens), dataset=j, index=1,
        stream=JStream(**kw), sampling=JSampling(do_sample=False), use_gt=True, dtype=jnp.float32)
    tr, tg = tserve.streaming_inference_from_dataset(
        cfg=CFG, model=model, tokenizer=FakeTokenizer(CFG.tokens), dataset=t, index=1,
        stream=StreamConfig(**kw), sampling=SamplingConfig(do_sample=False), use_gt=True,
        dtype=torch.float32)
    assert len(tr) == 3
    assert tr == jr and tg == jg
