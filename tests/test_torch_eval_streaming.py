"""The port's streaming harnesses against the JAX package's, on
qwen25_vl_tiny in f32 on the CPU, one set of numpy weights through the
bridge, greedy (each harness's SamplingConfig made do_sample=False on both
sides) and with injected judge callables: Inf-Stream-Eval (generate, a
resume from a partial jsonl, merge, score, aggregate), LiveSports-3K-CC
(the streaming, livecc and caption generators, judge_events,
judge_competitors, merge_event_outputs), `LiveCCInfer` itself and the GPT
competitor with a fake client write the same files, text included."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import numpy_params, one_cpu_thread, warm_cpu_math  # noqa: F401  (autouse fixtures)

import streaming_vlm_tpu.config as jcfg
import streaming_vlm_tpu_torch.config as tcfg
from streaming_vlm_tpu.baselines import livecc as jlivecc
from streaming_vlm_tpu.eval import gpt_competitor as jgpt
from streaming_vlm_tpu.eval import infstream as jinf
from streaming_vlm_tpu.eval import judge as jjudge
from streaming_vlm_tpu.eval import livesports as jls
from streaming_vlm_tpu.streaming.protocol import FakeTokenizer
from streaming_vlm_tpu.video import ingest as jingest
from streaming_vlm_tpu_torch.baselines import livecc
from streaming_vlm_tpu_torch.eval import gpt_competitor, infstream, judge, livesports
from streaming_vlm_tpu_torch.models.bridge import from_jax_params

CFG = jcfg.qwen25_vl_tiny()
FTOK = FakeTokenizer(CFG.tokens)
STREAM = dict(fps=2.0, chunk_duration=1.0, window_size=2, text_round=2, text_sink=4,
              text_sliding_window=4, max_tokens_per_chunk=4, kv_capacity=2048,
              prefill_buckets=(128, 256))
VIDEO = dict(fps=2.0, video_min_pixels=28 * 28, video_max_pixels=16 * 28 * 28)
LC = dict(fps=2.0, initial_fps_frames=2, streaming_fps_frames=2, max_new_tokens=4,
          kv_capacity=2048)


def _greedy(cls):
    def make(**kw):
        return cls(**{**kw, "do_sample": False})

    return make


@pytest.fixture(autouse=True)
def greedy(monkeypatch):
    """Every harness's SamplingConfig(...) greedy, on both sides."""
    for mod, cls in ((jcfg, jcfg.SamplingConfig), (tcfg, tcfg.SamplingConfig),
                     (jlivecc, jcfg.SamplingConfig), (livecc, tcfg.SamplingConfig)):
        monkeypatch.setattr(mod, "SamplingConfig", _greedy(cls))


@pytest.fixture(scope="module")
def both():
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(CFG, seed=7))
    return params, from_jax_params(CFG, jax.tree_util.tree_map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def video_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("evalv") / "clip.mp4")
    jingest.build_native()
    jingest.write_test_video(path, w=84, h=56, n_frames=80, fps=10)
    return path


def _sides(both):
    """(name, harness module, weight keyword, StreamConfig, VideoConfig, dtype)."""
    params, model = both
    return (("jax", {"params": params}, jcfg, jnp.float32),
            ("port", {"model": model}, tcfg, torch.float32))


def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def content_judge(system, user):
    """A position-consistent fake judge: the candidate holding 'baseline'."""
    a = user.split("Candidate A:\n")[1].split("\n\nCandidate B:")[0]
    return "A" if "baseline" in a else "B"


def test_judges_equal_the_jax_package():
    assert (judge.SYS_PROMPT, judge.USER_TEMPLATE) == (jjudge.SYS_PROMPT, jjudge.USER_TEMPLATE)
    for reply in ("A", "b", "Candidate A is better", "Candidate B", "neither", "",
                  "candidate a and candidate b"):
        fake = lambda s, u, r=reply: r  # noqa: E731
        assert judge.judge_pair(fake, "ref", "x", "y") == jjudge.judge_pair(fake, "ref", "x", "y")
        assert judge.judge_once(fake, "r", "a", "b") == jjudge.judge_once(fake, "r", "a", "b")
    for ab in ("A", "B", "tie"):
        for ba in ("A", "B", "tie"):
            assert judge.tally(ab, ba) == jjudge.tally(ab, ba)


def test_infstream_generate_resume_merge_score_aggregate(both, video_path, tmp_path):
    """Generation over a partial jsonl (4 s of 8 already there) resumes at
    4 s and a second run is a no-op; merged, scored and aggregated: every
    file equal to the JAX harness's."""
    content = [[i * 0.5, i * 0.5 + 0.5, f"w{i}"] for i in range(12)]  # ends at 6.0
    meta_part, meta = str(tmp_path / "part.jsonl"), str(tmp_path / "meta.jsonl")
    _write_jsonl(meta_part, [{"video": video_path, "content": content[:8]}])  # ends at 4.0
    _write_jsonl(meta, [{"video": video_path, "content": content}])
    files = {}
    for side, w, c, dt in _sides(both):
        mod = jinf if side == "jax" else infstream
        out = str(tmp_path / f"{side}_a.jsonl")
        for m in (meta_part, meta, meta):  # the partial run, the resume, a no-op
            mod.generate_segments(cfg=CFG, tokenizer=FTOK, eval_metadata=m, out_path=out,
                                  start_time=0, duration=2, stream=c.StreamConfig(**STREAM),
                                  video=c.VideoConfig(**VIDEO), dtype=dt, **w)
        lines = [json.loads(x) for x in open(out)]
        assert [(x["chunk_start"], x["chunk_end"]) for x in lines] == [(0, 2), (2, 4), (4, 6)]
        assert mod.latest_end_time(out, video_path.rsplit("/", 1)[1]) == 6
        merged = str(tmp_path / f"{side}_merged.jsonl")
        mod.merge_results([out], merged)
        scores = str(tmp_path / f"{side}_scores.jsonl")
        res = mod.score_segments(merged_a=merged, merged_b=merged, eval_metadata=meta,
                                 judge=content_judge, out_path=scores, seg_len=2)
        assert len(res) == 3
        files[side] = [open(p, "rb").read() for p in (out, merged, scores)]
        files[side].append(mod.merge_scores([scores, scores]))
    assert files["port"] == files["jax"]


def test_livesports_all_modes(both, video_path, tmp_path):
    """streaming, livecc and caption generators (idempotent per event),
    judge_events, judge_competitors and merge_event_outputs: the same files
    and summaries as the JAX harness."""
    events = [
        {"event_id": "e1", "video": video_path, "begin": 0.0, "end": 2.5,
         "preasr_text": "pre words", "event_cc": "baseline text", "title": "Match"},
        {"event_id": "e2", "video": video_path, "begin": 3.5, "end": 5.0,
         "preasr_text": "", "event_cc": "another baseline"},
    ]
    events_path = str(tmp_path / "events.jsonl")
    _write_jsonl(events_path, events)
    for ev in events:
        for simple in (False, True):
            assert livesports.competitor_prompt(ev, simple) == jls.competitor_prompt(ev, simple)
    got = {}
    for side, w, c, dt in _sides(both):
        mod = jls if side == "jax" else livesports
        lc_mod = jlivecc if side == "jax" else livecc
        d = tmp_path / side
        kw = dict(cfg=CFG, tokenizer=FTOK, events_path=events_path, **w)
        gens = {
            "streaming": lambda o: mod.generate_commentary(
                out_dir=o, stream=c.StreamConfig(**STREAM), video=c.VideoConfig(**VIDEO),
                dtype=dt, **kw),
            "livecc": lambda o: mod.generate_livecc_commentary(
                out_dir=o, lc=lc_mod.LiveCCConfig(**LC), video=c.VideoConfig(**VIDEO),
                dtype=dt, **kw),
            "caption": lambda o: mod.generate_plain_captions(
                out_dir=o, fps=1.0, max_frames=4, max_new_tokens=4,
                video=c.VideoConfig(**VIDEO), **kw),
        }
        out = {}
        for name, gen in gens.items():
            o = str(d / name)
            assert len(gen(o)) == 2 and gen(o) == []  # idempotent per event file
            out[name] = {e["event_id"]: open(f"{o}/{e['event_id']}.json", "rb").read()
                         for e in events}
        out["judge"] = mod.judge_events(events_path=events_path, pred_dir=str(d / "streaming"),
                                        judge=content_judge, out_path=str(d / "votes.jsonl"))
        out["compete"] = mod.judge_competitors(
            events_path=events_path, pred_dir_a=str(d / "livecc"), pred_dir_b=str(d / "caption"),
            judge=lambda s, u: "A", out_path=str(d / "h2h.jsonl"))
        assert mod.merge_event_outputs(str(d / "livecc"), str(d / "livecc.jsonl")) == 2
        out["files"] = [open(d / n, "rb").read() for n in ("votes.jsonl", "h2h.jsonl",
                                                           "livecc.jsonl")]
        got[side] = out
    assert got["port"] == got["jax"]
    assert got["port"]["judge"]["wins"]["B"] == 2


def test_livecc_infer_equals_the_jax_baseline(both):
    """Three interleaved rounds with the threshold-gated ' ...' stop: the
    JAX baseline's tokens, KV growth (LiveCC never evicts) and round count."""
    params, model = both
    cfg_kw = dict(LC, eos_base_threshold=0.0, eos_threshold_step=0.05, kv_capacity=1024)
    jinfer = jlivecc.LiveCCInfer(CFG, params, FTOK, jlivecc.LiveCCConfig(**cfg_kw),
                                 dtype=jnp.float32)
    tinfer = livecc.LiveCCInfer(CFG, model, FTOK, livecc.LiveCCConfig(**cfg_kw),
                                dtype=torch.float32)
    assert dataclasses.asdict(livecc.LiveCCConfig()) == dataclasses.asdict(jlivecc.LiveCCConfig())
    assert tinfer.streaming_eos_id == jinfer.streaming_eos_id
    rng = np.random.default_rng(0)
    grid = (1, 4, 4)
    kv = []
    for _ in range(3):
        frames = rng.integers(0, 255, size=(2, 56, 56, 3), dtype=np.uint8)
        want = jinfer.commentate(frames, grid)
        np.testing.assert_array_equal(tinfer.commentate(frames, grid), want)
        assert tinfer.engine.cached == jinfer.engine.cached
        kv.append(tinfer.engine.cached)
    assert tinfer.round == jinfer.round == 3 and kv[0] < kv[1] < kv[2]


class _FakeClient:
    """An OpenAI-style client recording each request."""

    def __init__(self):
        self.requests = []
        self.chat = self
        self.completions = self

    def create(self, **kw):
        self.requests.append(kw)
        n = len(self.requests)

        class R:
            choices = [type("C", (), {"message": type("M", (), {"content": f" line {n} "})})]

        return R()


def test_gpt_competitor_with_a_fake_client(video_path, tmp_path):
    meta = str(tmp_path / "meta.jsonl")
    _write_jsonl(meta, [{"video": video_path,
                         "content": [[i * 0.5, i * 0.5 + 0.5, f"w{i}"] for i in range(8)]}])
    got = {}
    for side, mod in (("jax", jgpt), ("port", gpt_competitor)):
        client = _FakeClient()
        out = str(tmp_path / f"{side}.jsonl")
        mod.generate_gpt_segments(eval_metadata=meta, out_path=out, start_time=0, duration=2,
                                  client=client)
        got[side] = (client.requests, open(out, "rb").read())
    assert got["port"] == got["jax"] and len(got["port"][0]) == 4
    assert gpt_competitor.PROMPT == jgpt.PROMPT
