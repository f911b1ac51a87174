"""The port's serve loop under a failed chunk read or vision encode, for both
entry points (qwen25_vl_tiny, f32, CPU, greedy): as the JAX package's loop
(streaming_vlm_tpu/serve.py), a read that raises at chunk i ends the stream
with chunks 0..i-1's responses and prints `Error reading chunk i`; an early
encode of chunk i+1 that raises keeps its frames, which chunk i+1's own step
encodes, so every chunk's tokens equal the fault-free run's."""

import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu_torch import serve
from streaming_vlm_tpu_torch.config import SamplingConfig, StreamConfig, qwen25_vl_tiny
from streaming_vlm_tpu_torch.models.qwen25_vl.model import init_params
from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer
from streaming_vlm_tpu_torch.video.ingest import ChunkedVideoSource

CFG = qwen25_vl_tiny()
GREEDY = SamplingConfig(do_sample=False, repetition_penalty=1.05)
STREAM = StreamConfig(window_size=2, text_round=2, text_sink=8, text_sliding_window=8,
                      max_tokens_per_chunk=4, kv_capacity=1024, prefill_buckets=(64, 128, 256))
N_CHUNKS = 4
FAIL_AT = 2  # the chunk whose read raises


@pytest.fixture(scope="module")
def model():
    return init_params(CFG, torch.Generator().manual_seed(11), device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(6)
    return [rng.integers(0, 256, (2, 56, 56, 3), dtype=np.uint8) for _ in range(N_CHUNKS)]


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    from streaming_vlm_tpu.video import ingest  # the test clip's writer

    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    ingest.write_test_video(path, w=64, h=48, n_frames=10 * N_CHUNKS, fps=10)
    return path


def _frames_run(model, frames, **kw):
    return serve.streaming_inference_frames(
        cfg=CFG, model=model, tokenizer=FakeTokenizer(CFG.tokens), frames=frames,
        stream=STREAM, sampling=GREEDY, quiet=True, time_test=True, **kw)


def _video_run(model, path, **kw):
    return serve.streaming_inference(
        cfg=CFG, model=model, tokenizer=FakeTokenizer(CFG.tokens), video_path=path,
        stream=STREAM, sampling=GREEDY, duration=float(N_CHUNKS), quiet=True, time_test=True,
        **kw)


@pytest.fixture(scope="module")
def clean_frames(model, frames):
    return _frames_run(model, frames)


@pytest.fixture(scope="module")
def clean_video(model, video):
    return _video_run(model, video)


def _raising_frames(frames):
    for i, f in enumerate(frames):
        if i == FAIL_AT:
            raise OSError(f"frame source lost at chunk {i}")
        yield f


def _texts(responses):
    return [r["response"] for r in responses]


@pytest.mark.parametrize("entry", ["frames", "video"])
def test_failed_read_ends_the_stream_with_the_responses_so_far(
        entry, model, frames, video, clean_frames, clean_video, monkeypatch, capsys, tmp_path):
    """A read that raises at chunk 2: exactly chunks 0-1's responses, equal
    to the fault-free run's first two, written to the VTT file too, and
    `Error reading chunk 2` on stderr."""
    vtt = str(tmp_path / "out.vtt")
    if entry == "frames":
        clean = clean_frames
        got, times = _frames_run(model, _raising_frames(frames), output_dir=vtt)
    else:
        clean = clean_video
        read = ChunkedVideoSource.read_chunk

        def read_chunk(src, t0, t1):
            if int(round(t0 / STREAM.chunk_duration)) == FAIL_AT:
                raise OSError("decoder lost the file")
            return read(src, t0, t1)

        monkeypatch.setattr(ChunkedVideoSource, "read_chunk", read_chunk)
        got, times = _video_run(model, video, output_dir=vtt)
    assert len(clean[0]) == N_CHUNKS
    assert len(got) == len(times) == FAIL_AT
    assert got == clean[0][:FAIL_AT]
    assert [t["decoded_tokens"] for t in times] == [t["decoded_tokens"] for t in clean[1][:FAIL_AT]]
    assert f"Error reading chunk {FAIL_AT}" in capsys.readouterr().err
    assert open(vtt).read().count(" --> ") == FAIL_AT


@pytest.mark.parametrize("entry", ["frames", "video"])
def test_failed_early_encode_keeps_the_frames(
        entry, model, frames, video, clean_frames, clean_video, monkeypatch):
    """The first early encode (chunk 1's, behind chunk 0's step) raises: the
    loop keeps chunk 1's frames and its step encodes them, so every chunk
    gives the fault-free run's tokens, with each chunk's own timestamp."""
    encode = serve.StreamingSession.encode_patches
    calls = []

    def encode_patches(session, patches, grid):
        calls.append(len(patches))
        if len(calls) == 1:
            raise RuntimeError("transient device fault")
        return encode(session, patches, grid)

    monkeypatch.setattr(serve.StreamingSession, "encode_patches", encode_patches)
    if entry == "frames":
        clean = clean_frames
        got = _frames_run(model, frames)
    else:
        clean = clean_video
        got = _video_run(model, video)
    assert len(calls) == N_CHUNKS - 1  # chunks 1..3 were encoded early (the first failed)
    assert _texts(got[0]) == _texts(clean[0])
    assert [(r["start_time"], r["end_time"]) for r in got[0]] == [
        (r["start_time"], r["end_time"]) for r in clean[0]]
    assert [t["decoded_tokens"] for t in got[1]] == [t["decoded_tokens"] for t in clean[1]]
