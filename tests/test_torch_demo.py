"""The port's live-caption demo (demo/app.py, demo/multiapp.py,
demo/render.py) on qwen25_vl_tiny in f32 on the CPU: the SSE server over
HTTP (page, events, range requests, the suffix form and 416), the live
segment source against the JAX package's under greedy sampling (one set of
numpy weights through the bridge), the caption bubble's layout and pixels
and the rendered video's frames equal to the JAX renderer's, the TTS mux
and its gate, and the multi-stream server matching solo runs (with
`mesh=` refused)."""

import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import numpy_params, one_cpu_thread, warm_cpu_math  # noqa: F401  (autouse fixtures)

import streaming_vlm_tpu.config as jcfg
import streaming_vlm_tpu_torch.config as tcfg
from streaming_vlm_tpu.demo import app as japp
from streaming_vlm_tpu.demo import multiapp as jmultiapp
from streaming_vlm_tpu.demo import render as jrender
from streaming_vlm_tpu.streaming.protocol import FakeTokenizer
from streaming_vlm_tpu.video import ingest as jingest
from streaming_vlm_tpu_torch.demo import app, multiapp, render
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.video import ingest

CFG = jcfg.qwen25_vl_tiny()
TOK = FakeTokenizer(CFG.tokens)
STREAM = dict(fps=2.0, chunk_duration=1.0, window_size=2, text_round=2, text_sink=4,
              text_sliding_window=4, max_tokens_per_chunk=4, kv_capacity=2048,
              prefill_buckets=(128, 256))
VIDEO = dict(fps=2.0, video_min_pixels=28 * 28, video_max_pixels=16 * 28 * 28)


@pytest.fixture(scope="module")
def both():
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(CFG, seed=11))
    return params, from_jax_params(CFG, jax.tree_util.tree_map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    jingest.build_native()
    # two resolutions: the multi-stream lanes carry different grids in one round
    jingest.write_test_video(str(d / "a.mp4"), w=84, h=56, n_frames=60, fps=10)
    jingest.write_test_video(str(d / "b.mp4"), w=56, h=56, n_frames=60, fps=10)
    return [str(d / "a.mp4"), str(d / "b.mp4")]


def _segments(side, weights, path, duration=4.0):
    mod, c, dt = (japp, jcfg, jnp.float32) if side == "jax" else (app, tcfg, torch.float32)
    kw = {"params" if side == "jax" else "model": weights}
    return list(mod.stream_segments(
        cfg=CFG, tokenizer=TOK, video_path=path, stream=c.StreamConfig(**STREAM),
        sampling=c.SamplingConfig(do_sample=False), video=c.VideoConfig(**VIDEO),
        duration=duration, dtype=dt, **kw))


def test_page_and_sse_roundtrip(videos):
    assert app.PAGE == japp.PAGE and multiapp.DASHBOARD == jmultiapp.DASHBOARD
    segs = [{"start": 0.0, "end": 1.0, "text": "hello"},
            {"start": 1.0, "end": 2.0, "text": "wörld <b>"}]
    srv = app.LiveCaptionServer(videos[0], lambda: iter(segs), port=0)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        assert urllib.request.urlopen(f"{base}/").read().decode() == app.PAGE
        got = []
        for raw in urllib.request.urlopen(f"{base}/events"):
            line = raw.decode().strip()
            if line.startswith("data:"):
                got.append(json.loads(line[5:]))
            if len(got) == 3:
                break
        assert got[:2] == segs and got[2] == {}  # the done event's payload
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nothing")
        assert e.value.code == 404
    finally:
        srv.shutdown()


def test_range_requests_suffix_and_416(videos):
    path = videos[0]
    size = os.path.getsize(path)
    blob = open(path, "rb").read()
    srv = app.LiveCaptionServer(path, lambda: iter([]), port=0)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        for rng, status, want, crange in (
                ("bytes=0-99", 206, blob[:100], f"bytes 0-99/{size}"),
                ("bytes=-500", 206, blob[-500:], f"bytes {size - 500}-{size - 1}/{size}"),
                (f"bytes={size - 10}-", 206, blob[-10:], f"bytes {size - 10}-{size - 1}/{size}"),
                ("bytes=x-y", 200, blob, None)):
            resp = urllib.request.urlopen(urllib.request.Request(
                f"{base}/video", headers={"Range": rng}))
            assert resp.status == status and resp.read() == want
            assert resp.headers["Content-Range"] == crange
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                f"{base}/video", headers={"Range": f"bytes={size + 5}-"}))
        assert e.value.code == 416 and e.value.headers["Content-Range"] == f"bytes */{size}"
    finally:
        srv.shutdown()


def test_segment_feed_replays_to_late_subscribers():
    feed = app.SegmentFeed()
    first = feed.subscribe()
    feed.push({"i": 0})
    assert next(first) == {"i": 0}
    feed.push({"i": 1})
    feed.finish()
    assert list(first) == [{"i": 1}] and list(feed.subscribe()) == [{"i": 0}, {"i": 1}]


def test_servers_free_their_engines_without_the_collector(both):
    """A demo server dropped after use frees its engine's arena by
    reference counting alone, the cycle collector off: its HTTP handler
    class, which only the collector frees, must hold no reference to the
    server. A LiveCaptionServer whose caption source closes over a session
    that ran a chunk, served in the background and shut down; a
    MultiLiveCaptionServer (its own 2-lane engine), built and closed."""
    import gc
    import weakref

    _, model = both
    from streaming_vlm_tpu_torch.serve import StreamingSession

    def live():
        session = StreamingSession(CFG, model, TOK, stream=tcfg.StreamConfig(**STREAM),
                                   dtype=torch.float32)
        frames = np.random.default_rng(0).integers(0, 256, (2, 56, 56, 3), dtype=np.uint8)
        session.run_chunk(0, 0.0, frames_u8=session.engine.upload_frames(frames),
                          grid_thw=(1, 4, 4))
        srv = app.LiveCaptionServer("unused.mp4", lambda: iter([session.previous_text]), port=0)
        srv.start_background()
        srv.shutdown()
        return weakref.ref(session.engine.k_arena)

    def multi():
        srv = multiapp.MultiLiveCaptionServer(CFG, model, TOK, ["a.mp4", "b.mp4"], port=0,
                                              stream=tcfg.StreamConfig(**STREAM),
                                              dtype=torch.float32)
        srv.httpd.server_close()
        return weakref.ref(srv.engine.k_arena)

    gc.collect()
    gc.disable()
    try:
        for make in (live, multi):
            assert make()() is None, make.__name__
    finally:
        gc.enable()


def test_stream_segments_equals_the_jax_package(both, videos):
    params, model = both
    want = _segments("jax", params, videos[0])
    assert _segments("port", model, videos[0]) == want
    assert len(want) == 4 and [s["start"] for s in want] == [0.0, 1.0, 2.0, 3.0]


def test_bubble_layout_and_pixels_bitwise():
    texts = ["hi there", "", "a " * 80, "second one, long enough to wrap across multiple lines"]
    for t in texts:
        for w in (56, 84, 448):
            assert render._bubble_layout(t, w) == jrender._bubble_layout(t, w)
    frame = np.random.default_rng(0).integers(0, 255, (56, 84, 3), dtype=np.uint8)
    for t in texts:
        np.testing.assert_array_equal(render.draw_bubble(frame, t), jrender.draw_bubble(frame, t))
    assert render.draw_bubble(np.zeros((56, 84, 3), np.uint8), "hi").sum() > 0


def test_rendered_frames_equal_the_jax_renderer(videos, tmp_path):
    segs = [{"start": 0.0, "end": 2.0, "text": "first caption bubble"},
            {"start": 3.0, "end": 5.0, "text": "second one, long enough to wrap across lines"}]
    rate = 24000

    def synth(text):  # a 0.5 s tone whose pitch depends on the text
        t = np.arange(int(0.5 * rate)) / rate
        return (0.3 * np.sin(2 * np.pi * (220 + 10 * len(text)) * t)).astype(np.float32)

    n, drawn = render.render_caption_video(videos[0], segs, str(tmp_path / "t.mp4"),
                                           max_seconds=5.0)
    assert (n, drawn) == jrender.render_caption_video(videos[0], segs, str(tmp_path / "j.mp4"),
                                                      max_seconds=5.0)
    assert n > 20 and drawn == 2
    rt, rj = ingest.VideoReader(str(tmp_path / "t.mp4")), ingest.VideoReader(str(tmp_path / "j.mp4"))
    assert rt.n_frames == rj.n_frames >= n - 1
    idx = list(range(rt.n_frames))
    np.testing.assert_array_equal(rt.fetch(idx, rt.width, rt.height),
                                  rj.fetch(idx, rj.width, rj.height))
    raw = ingest.VideoReader(videos[0]).fetch([5], rt.width, rt.height)[0]
    assert np.abs(rt.fetch([5], rt.width, rt.height)[0].astype(int) - raw.astype(int)).mean() > 1
    # the TTS mux: an AAC track at the requested rate; no synth, no track
    out = str(tmp_path / "tts.mp4")
    assert render.render_caption_video(videos[0], segs, out, max_seconds=4.0, synth=synth,
                                       audio_rate=rate)[1] == 2
    assert ingest.audio_rate(out) == jingest.audio_rate(out) == rate
    assert ingest.audio_rate(str(tmp_path / "t.mp4")) == 0


def test_tts_gated(tmp_path):
    for fn in (lambda: render.synth_speech("hello", str(tmp_path / "x.wav")),
               lambda: render.kokoro_synth("hello")):
        with pytest.raises(RuntimeError, match="kokoro"):
            fn()


def _sse(base, i, timeout=300.0):
    got = []
    with urllib.request.urlopen(f"{base}/events/{i}", timeout=timeout) as events:
        for raw in events:
            line = raw.decode().strip()
            if line == "event: done":
                break
            if line.startswith("data:"):
                got.append(json.loads(line[5:]))
    return got


def test_multiapp_matches_solo_runs_and_refuses_a_mesh(both, videos):
    """Two lanes of different resolutions batched in one server's rounds:
    each lane's segments over HTTP equal a solo stream_segments run on its
    video (greedy); the pages and ranges are served. The server runs on a
    mesh (mesh={"model": 1}: the parallel path's modules and engine, a world
    of one), and a mesh of more ranks than the world raises."""
    import copy

    _, model = both
    kw = dict(stream=tcfg.StreamConfig(**STREAM), sampling=tcfg.SamplingConfig(do_sample=False),
              video=tcfg.VideoConfig(**VIDEO), duration=4.0, port=0, dtype=torch.float32)
    with pytest.raises(ValueError, match="needs 2 ranks, the world has 1"):
        multiapp.MultiLiveCaptionServer(CFG, copy.deepcopy(model), TOK, videos,
                                        mesh={"model": 2}, **kw)
    srv = multiapp.MultiLiveCaptionServer(CFG, copy.deepcopy(model), TOK, videos,
                                          mesh={"model": 1}, **kw)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        assert "const N = 2" in urllib.request.urlopen(f"{base}/", timeout=30).read().decode()
        player = urllib.request.urlopen(f"{base}/stream/1", timeout=30).read().decode()
        assert "/video/1" in player and "/events/1" in player
        resp = urllib.request.urlopen(urllib.request.Request(
            f"{base}/video/1", headers={"Range": "bytes=0-99"}), timeout=30)
        assert resp.status == 206 and len(resp.read()) == 100
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/video/7", timeout=30)
        got = [_sse(base, i) for i in range(2)]
        assert srv.wait(timeout=600.0)
    finally:
        srv.shutdown()
    for i, path in enumerate(videos):
        solo = _segments("port", model, path)
        assert got[i] == solo and len(solo) == 4
