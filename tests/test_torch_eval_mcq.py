"""The port's MCQ scoring (eval/mcq.py) and OVO-Bench harness
(eval/ovobench.py) against the JAX package's, on qwen25_vl_tiny in f32 on
the CPU, both sides built from one set of numpy weights through the bridge:
the batched forward (the decoder's lane form at visible 0, K1's plain
version here) gives the JAX predictions, each option score within 1e-4 of
the largest |logit| of the JAX `forward_full` oracle's last row, with a
shared grid, mixed grids and text only; the OVO-Bench formatters give the
same records and `evaluate_ovobench` writes the same predictions file over
a synthesized clip, one question at a time and batched."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import numpy_params, one_cpu_thread, warm_cpu_math  # noqa: F401  (autouse fixtures)

from streaming_vlm_tpu.config import VideoConfig as JaxVideoConfig
from streaming_vlm_tpu.config import qwen25_vl_tiny
from streaming_vlm_tpu.eval import mcq as jmcq
from streaming_vlm_tpu.eval import ovobench as jovo
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.streaming.protocol import FakeTokenizer
from streaming_vlm_tpu.video import ingest as jingest
from streaming_vlm_tpu_torch.config import VideoConfig
from streaming_vlm_tpu_torch.eval import mcq, ovobench
from streaming_vlm_tpu_torch.models.bridge import from_jax_params

CFG = qwen25_vl_tiny()
FTOK = FakeTokenizer(CFG.tokens)
PATCH_DIM = CFG.vision.in_channels * CFG.vision.temporal_patch_size * CFG.vision.patch_size**2
TINY_VIDEO = dict(fps=2.0, video_min_pixels=28 * 28, video_max_pixels=16 * 28 * 28)
QUESTIONS = [
    "Is the ball red or blue or green?",
    "Short q?",
    "Which of the following describes the scene best given everything that happened so far "
    "in this very long question string?",
]
OPTIONS = ["A", "B", "C", "D"]


@pytest.fixture(scope="module")
def both():
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(CFG, seed=3))
    return params, from_jax_params(CFG, jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _oracle_scores(params, ids, opt_ids, patches=None, grid=None, spg=None):
    """The JAX oracle: forward_full's last-row logits at the option ids."""
    logits = jm.forward_full(
        CFG, params, ids,
        pixel_patches=None if patches is None else jnp.asarray(patches),
        video_grid_thw=None if grid is None else np.asarray([grid]),
        second_per_grid_ts=None if spg is None else np.asarray([spg], np.float32),
    )
    last = np.asarray(logits[-1])
    return last[list(opt_ids)], float(np.abs(last).max())


def _case(kind):
    """(ids, patches, grids, spg) per question of a batch kind."""
    rng = np.random.default_rng({"text": 1, "shared": 2, "mixed": 3}[kind])
    grids = {"text": [None] * 3, "shared": [(1, 4, 4)] * 3,
             "mixed": [(1, 4, 4), (1, 6, 4), None]}[kind]
    ids, patches, spg = [], [], []
    for q, g in zip(QUESTIONS, grids):
        n_vis = 0 if g is None else int(np.prod(g)) // CFG.vision.spatial_merge_unit
        ids.append(jmcq.build_mcq_prompt_ids(CFG, FTOK, q, n_vis))
        patches.append(None if g is None else
                       (0.1 * rng.normal(size=(int(np.prod(g)), PATCH_DIM))).astype(np.float32))
        spg.append(None if g is None else 1.0)
    return ids, patches, grids, spg


@pytest.mark.parametrize("kind", ["text", "shared", "mixed"])
def test_option_scores_match_the_jax_oracle(both, kind):
    """Every question's option logits from the batched lane forward equal
    the JAX forward_full's last row within 1e-4 of its largest |logit|."""
    params, model = both
    ids, patches, grids, spg = _case(kind)
    opt = mcq.option_token_ids(FTOK, OPTIONS)
    vis = [None if p is None else mcq._encode(CFG, model, p, np.asarray([g]))
           for p, g in zip(patches, grids)]
    got = mcq._mcq_scores(CFG, model, ids, [opt] * 3, vis,
                          [None if g is None else np.asarray([g]) for g in grids],
                          [None if s is None else [s] for s in spg], bucket=128).numpy()
    assert got.shape == (3, len(OPTIONS)) and got.dtype == np.float32
    for b in range(3):
        want, scale = _oracle_scores(params, ids[b], opt, patches[b], grids[b], spg[b])
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("kind", ["text", "shared", "mixed"])
def test_predictions_equal_the_jax_package(both, kind):
    """mcq_predict_batch (shared grid: one [B, S, patch_dim] array and one
    grid; mixed: per-question lists) and mcq_predict_one give the JAX
    package's predictions."""
    params, model = both
    ids, patches, grids, spg = _case(kind)
    opt = mcq.option_token_ids(FTOK, OPTIONS)
    if kind == "shared":
        kw = dict(pixel_patches=np.stack(patches), video_grid_thw=grids[0],
                  second_per_grid_ts=spg)
    elif kind == "mixed":
        kw = dict(pixel_patches=patches, video_grid_thw=grids, second_per_grid_ts=spg)
    else:
        kw = {}
    want = jmcq.mcq_predict_batch(CFG, params, ids, [opt] * 3, **kw,
                                  **({"vis_bucket": 8} if kind == "mixed" else {}))
    assert mcq.mcq_predict_batch(CFG, model, ids, [opt] * 3, **kw) == want
    for b in range(3):
        one = dict(pixel_patches=patches[b],
                   video_grid_thw=None if grids[b] is None else np.asarray([grids[b]]),
                   second_per_grid_ts=None if spg[b] is None else np.asarray([spg[b]], np.float32))
        assert mcq.mcq_predict_one(CFG, model, ids[b], opt, **one) == want[b]
    assert mcq.shard_indices(7, 1, 3) == jmcq.shard_indices(7, 1, 3) == [1, 4]


def test_prompt_and_option_ids_equal_the_jax_package():
    for q in QUESTIONS:
        for n in (0, 4):
            np.testing.assert_array_equal(mcq.build_mcq_prompt_ids(CFG, FTOK, q, n),
                                          jmcq.build_mcq_prompt_ids(CFG, FTOK, q, n))
    assert mcq.option_token_ids(FTOK, OPTIONS) == jmcq.option_token_ids(FTOK, OPTIONS)
    assert (mcq.QUESTION_POSTFIX, mcq.ANSWER_PREFIX) == (jmcq.QUESTION_POSTFIX,
                                                          jmcq.ANSWER_PREFIX)


def _raw_annotations(video_path):
    return [
        {"id": 1, "task": "CRR", "question": "Is it red?", "ask_time": 0,
         "video": video_path, "test_info": [{"realtime": 3.0, "type": 1},
                                            {"realtime": 4.0, "type": 0}]},
        {"id": 2, "task": "REC", "activity": "jump", "video": video_path,
         "test_info": [{"realtime": 4.0, "count": 2}]},
        {"id": 3, "task": "SSR", "video": video_path,
         "test_info": [{"realtime": 2.0, "type": 0, "step": "stir"}]},
        {"id": 4, "task": "OCR", "question": "What letter?", "realtime": 3.0,
         "video": video_path, "options": ["x", "y", "z"], "gt": 1},
        {"id": 5, "task": "EPM", "question": "What came first?", "realtime": 2.5,
         "video": "clip.mp4", "options": ["a", "b"], "gt": 0},
    ]


def test_ovobench_formatters_bitwise(tmp_path):
    raw = _raw_annotations("v.mp4")
    for fmt in ("format_crr", "format_rec", "format_ssr"):
        for d in raw[:3]:
            if d["task"].lower() == fmt[-3:]:
                assert getattr(ovobench, fmt)(d) == getattr(jovo, fmt)(d)
    for d in raw[3:]:
        assert ovobench.format_other(d) == jovo.format_other(d)
    src = tmp_path / "ovo.json"
    src.write_text(json.dumps(raw))
    n = ovobench.transfer_annotations(str(src), str(tmp_path / "t.jsonl"))
    assert n == jovo.transfer_annotations(str(src), str(tmp_path / "j.jsonl")) == 6
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    results = [{"task": "CRR", "response": "Yes", "answer": "Yes"},
               {"task": "CRR", "response": "No ", "answer": "Yes"},
               {"task": "EPM", "response": "A", "answer": "A"},
               {"task": "REC", "response": "10", "answer": "1"},
               {"task": "OCR", "error": "unreadable"}]
    assert ovobench.evaluate_results(results) == jovo.evaluate_results(results)
    assert (ovobench.REALTIME_TASKS, ovobench.BACKWARD_TASKS) == (jovo.REALTIME_TASKS,
                                                                  jovo.BACKWARD_TASKS)


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ovo")
    jingest.build_native()
    jingest.write_test_video(str(d / "clip.mp4"), w=84, h=56, n_frames=80, fps=10)
    return d


@pytest.mark.parametrize("batch_size", [1, 3])
def test_evaluate_ovobench_writes_the_jax_predictions(both, video_dir, tmp_path, batch_size):
    """Over a synthesized clip (a question whose video is given relative to
    video_root among them), one question at a time and batched (mixed grids
    and option counts: 2, 11, 3 and 2): the same predictions file as the
    JAX harness, and again unchanged when resumed."""
    params, model = both
    raw_path = tmp_path / "ovo.json"
    raw_path.write_text(json.dumps(_raw_annotations(str(video_dir / "clip.mp4"))))
    fmt = str(tmp_path / "mcq.jsonl")
    jovo.transfer_annotations(str(raw_path), fmt)
    outs = {}
    for side, (fn, weights, video) in {
        "jax": (jovo.evaluate_ovobench, params, JaxVideoConfig(**TINY_VIDEO)),
        "port": (ovobench.evaluate_ovobench, model, VideoConfig(**TINY_VIDEO)),
    }.items():
        out = tmp_path / f"{side}.jsonl"
        kw = {"params" if side == "jax" else "model": weights}
        res = fn(cfg=CFG, encode=FTOK, benchmark_path=fmt, video_root=str(video_dir), fps=2.0,
                 video=video, out_path=str(out), batch_size=batch_size, **kw)
        assert len(res) == 6 and all("error" not in r for r in res), res
        outs[side] = out.read_bytes()
        assert fn(cfg=CFG, encode=FTOK, benchmark_path=fmt, video_root=str(video_dir), fps=2.0,
                  video=video, out_path=str(out), batch_size=batch_size, **kw) == []
    assert outs["port"] == outs["jax"]
