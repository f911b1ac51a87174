"""The port's soak and efficiency harnesses (streaming_vlm_tpu_torch/eval)
on qwen25_vl_tiny, CPU, f32, held to tests/test_eval_harnesses.py's
expectations: constant KV occupancy once the window is saturated with a
latency slope reported, and the paper's four policies (a)-(d) end to end
through the port's streaming_inference, in the JSON schema of the JAX
package's harness (the same keys at every level)."""

import jax
import jax.numpy as jnp
import math
import numpy as np
import pytest
import torch

from _torch_cpu import one_cpu_thread, warm_cpu_math  # noqa: F401  (autouse fixtures)

from streaming_vlm_tpu.config import VideoConfig as JaxVideoConfig
from streaming_vlm_tpu.config import qwen25_vl_tiny
from streaming_vlm_tpu.eval.efficiency import run_efficiency as jax_run_efficiency
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.video import ingest  # the test video's writer
from streaming_vlm_tpu_torch.config import StreamConfig, VideoConfig
from streaming_vlm_tpu_torch.eval.efficiency import run_efficiency
from streaming_vlm_tpu_torch.eval.soak import run_soak
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer

CFG = qwen25_vl_tiny()
FTOK = FakeTokenizer(CFG.tokens)
TINY_VIDEO = dict(fps=2.0, video_min_pixels=28 * 28, video_max_pixels=16 * 28 * 28)
OVERRIDES = dict(kv_capacity=2048, prefill_buckets=(128, 256, 512), max_tokens_per_chunk=3)


@pytest.fixture(scope="module")
def both():
    params = jm.init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return params, from_jax_params(CFG, jax.tree_util.tree_map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def video_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("evalv") / "clip.mp4")
    ingest.build_native()
    ingest.write_test_video(path, w=84, h=56, n_frames=80, fps=10)
    return path


def test_soak_constant_kv_and_slope(both):
    """Constant occupancy past the window, a finite slope in the report."""
    _, model = both
    stream = StreamConfig(
        fps=2.0, chunk_duration=1.0, window_size=3, text_round=3, text_sink=4,
        text_sliding_window=4, max_tokens_per_chunk=3, kv_capacity=1024, prefill_buckets=(128,),
    )
    report = run_soak(cfg=CFG, model=model, stream=stream, n_chunks=12, grid=(1, 4, 4),
                      dtype=torch.float32)
    assert report.kv_constant, report.kv_occupancy
    assert report.p50_ms > 0 and report.p95_ms >= report.p50_ms
    assert math.isfinite(report.latency_slope_ms_per_chunk)
    assert report.steady_start == max(stream.visual_round + 2, 2 * 12 // 3)
    assert len(report.kv_occupancy) == len(report.chunk_seconds) == 12
    assert max(report.kv_occupancy) <= stream.kv_capacity
    assert '"latency_slope_ms_per_chunk"' in report.to_json()


@pytest.fixture(scope="module")
def jax_payload(both, video_path, tmp_path_factory):
    """One JAX run of the harness (policy d): the schema the port's keeps."""
    params, _ = both
    return jax_run_efficiency(
        cfg=CFG, params=params, tokenizer=FTOK, video_path=video_path, baseline_mode="d",
        duration=3.0, output_dir=str(tmp_path_factory.mktemp("jeff")),
        stream_overrides=OVERRIDES, video=JaxVideoConfig(**TINY_VIDEO), dtype=jnp.float32,
    )


@pytest.mark.parametrize("mode", ["a", "b", "c", "d"])
def test_efficiency_configs_end_to_end(both, video_path, jax_payload, tmp_path, mode):
    """Each policy serves 3 chunks, decodes tokens every chunk, and writes
    the JAX harness's JSON keys (meta, per_chunk records, summary)."""
    _, model = both
    payload = run_efficiency(
        cfg=CFG, model=model, tokenizer=FTOK, video_path=video_path, baseline_mode=mode,
        duration=3.0, output_dir=str(tmp_path / "eff"), stream_overrides=OVERRIDES,
        video=VideoConfig(**TINY_VIDEO), dtype=torch.float32,
    )
    assert payload["summary"]["num_chunks"] == 3
    assert payload["meta"]["recompute"] == (mode == "c")
    for rec in payload["per_chunk"]:
        assert rec["decoded_tokens"] >= 1
        assert rec["gen_time_per_token"] is not None
    assert payload.keys() == jax_payload.keys()
    for part in ("meta", "summary"):
        assert payload[part].keys() == jax_payload[part].keys(), part
    assert payload["per_chunk"][0].keys() == jax_payload["per_chunk"][0].keys()
    if mode == "d":  # the same window bookkeeping as the JAX harness's
        for k in ("window_size", "text_round", "text_sink", "text_sliding_window"):
            assert payload["meta"][k] == jax_payload["meta"][k], k
    (out,) = list((tmp_path / "eff").iterdir())
    assert out.name.startswith({"d": "streaming"}.get(mode, f"baseline_{mode}"))
