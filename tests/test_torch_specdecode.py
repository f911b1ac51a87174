"""Speculative decoding in the port against the JAX package's and against
the port's own autoregressive path, on qwen25_vl_tiny with bridged weights
(f32, CPU; K2-verify's plain version): greedy spec tokens equal the
autoregressive stream whatever the draft, the engines' tables and
accounting agree after every chunk across evictions, the acceptance rule
is held to a numpy statement of it on fixed draws, and the serve entry
points with spec_decode give the autoregressive responses. After
tests/test_specdecode.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_cpu_thread, warm_cpu_math  # noqa: F401  (autouse fixtures)

from streaming_vlm_tpu.config import SamplingConfig, StreamConfig, qwen25_vl_tiny
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.streaming import specdecode as jspec
from streaming_vlm_tpu.streaming.engine import StreamingEngine as JaxEngine
from streaming_vlm_tpu.streaming.protocol import FakeTokenizer, PromptBuilder
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.serve import (
    StreamingSession,
    streaming_inference,
    streaming_inference_frames,
)
from streaming_vlm_tpu_torch.streaming import protocol as tp
from streaming_vlm_tpu_torch.streaming.engine import StreamingEngine
from streaming_vlm_tpu_torch.streaming.specdecode import (
    FixedDraft,
    NGramDraft,
    SpecStatics,
    accept_tokens,
)

CFG = qwen25_vl_tiny()
TOK = CFG.tokens
GRID = (1, 4, 4)
PATCH_DIM = CFG.vision.in_channels * CFG.vision.temporal_patch_size * CFG.vision.patch_size**2
GREEDY = SamplingConfig(do_sample=False, repetition_penalty=1.05)
N_CHUNKS = 5


def _stream(kv_quant="none", **kw):
    base = dict(text_round=3, window_size=2, chunk_duration=1, text_sink=8,
                text_sliding_window=8, max_tokens_per_chunk=6, kv_capacity=1024,
                prefill_buckets=(64, 128), kv_quant=kv_quant)
    return StreamConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def both():
    params = jm.init_params(CFG, jax.random.PRNGKey(11), dtype=jnp.float32)
    return params, from_jax_params(CFG, jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _segs(b, i):
    n_vid = GRID[0] * (GRID[1] // 2) * (GRID[2] // 2)
    out = []
    if i == 0:
        out.append(b.system_segment())
        out.extend(b.previous_text_segments("prev"))
        out.extend(b.user_turn_segments(0, 0.0, 1.0, n_vid, GRID, 1.0, query="go"))
    else:
        out.extend(b.user_turn_segments(i, float(i), float(i + 1), n_vid, GRID, 1.0))
    return out + b.assistant_open_segments(i)


def _pixels():
    rng = np.random.default_rng(7)
    return [(rng.normal(size=(int(np.prod(GRID)), PATCH_DIM)) * 0.1).astype(np.float32)
            for _ in range(N_CHUNKS)]


def _port_stream(model, draft_factory, stream, sampling=GREEDY):
    """The port's engine over N_CHUNKS chunks; draft_factory(i) is "AR"
    (process_chunk) or a draft for process_chunk_spec (None: no draft).
    Returns (gens, rounds a chunk, engine)."""
    eng = StreamingEngine(CFG, model, stream, sampling, dtype=torch.float32)
    b = tp.PromptBuilder(TOK, FakeTokenizer(TOK))
    _, end_bias = b.measure_biases()
    gens, rounds = [], []
    for i, px in enumerate(_pixels()):
        d = draft_factory(i)
        if isinstance(d, str):
            g, _ = eng.process_chunk(_segs(b, i), px, GRID)
        else:
            g, _ = eng.process_chunk_spec(_segs(b, i), px, GRID, draft_fn=d)
            rounds.append(eng._spec_rounds)
        eng.commit_assistant(g, end_bias, i)
        gens.append(np.asarray(g))
        assert eng.cached + eng.uncached_tail == eng.table.total_len()
    return gens, rounds, eng


_AR = {}


def _port_ar(model, kv_quant):
    if kv_quant not in _AR:
        _AR[kv_quant] = _port_stream(model, lambda i: "AR", _stream(kv_quant))[0]
    return _AR[kv_quant]


DRAFTS = {
    "none": lambda ar, i: None,
    "adversarial": lambda ar, i: FixedDraft(np.full(32, 999, np.int32)),
    "clairvoyant": lambda ar, i: FixedDraft(ar[i]),
}


@pytest.mark.parametrize("draft", list(DRAFTS))
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_spec_matches_jax_and_autoregressive(both, kv_quant, draft):
    """Chunk by chunk across evictions: the port's greedy spec tokens equal
    the JAX engine's process_chunk_spec tokens and the port's own
    autoregressive tokens, in as many verify rounds as the JAX engine
    takes; surviving ids, cached, uncached_tail and positions equal the
    JAX engine's after every chunk. The clairvoyant draft takes fewer
    rounds than tokens."""
    params, model = both
    stream = _stream(kv_quant)
    ar = _port_ar(model, kv_quant)
    jeng = JaxEngine(CFG, params, stream, GREEDY, dtype=jnp.float32)
    teng = StreamingEngine(CFG, model, stream, GREEDY, dtype=torch.float32)
    jb, tb = PromptBuilder(TOK, FakeTokenizer(TOK)), tp.PromptBuilder(TOK, FakeTokenizer(TOK))
    _, end_bias = jb.measure_biases()
    evictions = 0
    for i, px in enumerate(_pixels()):
        gj, _ = jeng.process_chunk_spec(_segs(jb, i), px, GRID, draft_fn=DRAFTS[draft](ar, i))
        gt, _ = teng.process_chunk_spec(_segs(tb, i), px, GRID, draft_fn=DRAFTS[draft](ar, i))
        np.testing.assert_array_equal(gt, gj, err_msg=f"JAX spec tokens, chunk {i}")
        np.testing.assert_array_equal(gt, ar[i], err_msg=f"autoregressive tokens, chunk {i}")
        assert teng._spec_rounds == jeng._spec_rounds, i
        jeng.commit_assistant(gj, end_bias, i)
        teng.commit_assistant(gt, end_bias, i)
        evictions += teng.cached_after_evict < teng.cached_before_evict
        np.testing.assert_array_equal(teng.table.token_ids(), jeng.table.token_ids())
        assert (teng.cached, teng.uncached_tail) == (jeng.cached, jeng.uncached_tail)
        np.testing.assert_allclose(teng._positions(), jeng._positions(), atol=1e-5)
    assert evictions >= 2
    if draft == "clairvoyant":
        assert teng._spec_rounds < len(gt), (teng._spec_rounds, len(gt))


def test_spec_table_and_kv_invariants(both):
    """With the n-gram draft across evictions: cached + uncached_tail ==
    the table's length after every chunk, the surviving ids and the
    tokens equal the autoregressive run's, and the committed arena ids
    hold the table's cached prefix."""
    _, model = both
    ar = _port_ar(model, "none")
    draft = NGramDraft(n=2)
    gens, _, eng = _port_stream(model, lambda i: draft, _stream())
    _, _, eng_ar = _port_stream(model, lambda i: "AR", _stream())
    for a, b in zip(ar, gens):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(eng.table.token_ids(), eng_ar.table.token_ids())
    np.testing.assert_array_equal(eng.ids_arena[: eng.cached].numpy(),
                                  eng.table.token_ids()[: eng.cached])


def test_spec_sampling_within_budget(both):
    """Sampling: at most max_new tokens (+ the forced eos) a chunk, the
    accounting kept, and the engine's generator the only source of draws
    (two engines seeded alike emit the same tokens)."""
    _, model = both
    sampling = SamplingConfig(do_sample=True, temperature=0.9, repetition_penalty=1.05, seed=3)
    stream = _stream(max_tokens_per_chunk=5)
    runs = [_port_stream(model, lambda i: NGramDraft(n=2), stream, sampling)[0] for _ in range(2)]
    for g in runs[0]:
        assert 1 <= len(g) <= stream.max_tokens_per_chunk + 1
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def _accept_numpy(logits, inputs, presence, n_draft, emitted_total, eos, *, max_new, temperature,
                  penalty, do_sample, eos_threshold, uniforms, gumbel):
    """The acceptance rule, stated in numpy (after the JAX package's scan)."""
    K, V = logits.shape
    presence = presence.copy()
    still, done = True, False
    toks, n_emit, n_acc = [], 0, 0
    for j in range(K):
        lg = logits[j].astype(np.float64)
        if eos_threshold is not None:
            tok_id, base, step = eos_threshold
            thr = np.float32(np.float32(step) * (emitted_total + j) + np.float32(base))
            e = np.exp(lg - lg.max())
            if e[tok_id] / e.sum() <= thr:
                lg[tok_id] = -np.inf
        sc = np.where(presence, np.where(lg > 0, lg / penalty, lg * penalty), lg)
        d = inputs[j + 1] if j < K - 1 else eos
        is_draft = j < n_draft
        if do_sample:
            z = sc / temperature
            p = np.exp(z - z.max())
            p /= p.sum()
            accept = is_draft and uniforms[j] < p[d]
            resid = p.copy()
            if is_draft:
                resid[d] = 0.0
            tok = d if accept else int(np.argmax(np.log(np.maximum(resid, 1e-30)) + gumbel[j]))
        else:
            tok = int(np.argmax(sc))
            accept = is_draft and tok == d
        can_emit = still and not done and emitted_total + j < max_new
        tok = tok if can_emit else eos
        if can_emit:
            presence[tok] = True
            n_emit += 1
            n_acc += accept
        now_done = done or (can_emit and tok == eos)
        still = still and accept and can_emit and not now_done
        done = now_done
        toks.append(tok)
    return np.asarray(toks), n_emit, 1 + n_acc, done, presence


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("do_sample", [False, True], ids=["greedy", "sampled"])
def test_acceptance_rule_matches_numpy(seed, do_sample):
    """accept_tokens on fixed uniforms and Gumbel noise (the engine draws
    them from its generator) against the numpy statement: the eos gate at
    each position's step, the penalty over the presence mask updated in
    emission order, acceptance, the residual draw, the max_new budget."""
    rng = np.random.default_rng(seed)
    K, V, eos = 6, 40, 3
    logits = (rng.normal(size=(K, V)) * 3).astype(np.float32)
    # drafts that follow the argmax for a while, then part from it
    inputs = rng.integers(0, V, K)
    n_follow = seed % K
    inputs[1 : 1 + n_follow] = np.argmax(logits[:n_follow], axis=1)
    presence = rng.random(V) < 0.3
    n_draft = min(K - 1, 2 + seed % 4)
    emitted_total = seed % 3
    kw = dict(max_new=emitted_total + 4 + seed % 2, temperature=0.7, penalty=1.3,
              do_sample=do_sample, eos_threshold=(eos, 0.02, 0.01) if seed % 2 else None)
    uniforms = rng.random(K).astype(np.float32)
    gumbel = (-np.log(-np.log(rng.random((K, V))))).astype(np.float32)
    statics = SpecStatics(cfg=CFG, t_pad=64, k_pad=K, n_delta=0, temperature=kw["temperature"],
                          repetition_penalty=kw["penalty"], do_sample=do_sample,
                          max_new=kw["max_new"], eos_threshold=kw["eos_threshold"])
    pres_t = torch.from_numpy(presence.copy())
    emitted, n_emit, n_keep, done = accept_tokens(
        statics, torch.from_numpy(logits), torch.from_numpy(inputs), pres_t, n_draft,
        emitted_total, eos, torch.from_numpy(uniforms), torch.from_numpy(gumbel))
    want = _accept_numpy(logits, inputs, presence, n_draft, emitted_total, eos,
                         uniforms=uniforms, gumbel=gumbel, **kw)
    np.testing.assert_array_equal(emitted.numpy(), want[0])
    assert (int(n_emit), int(n_keep), bool(done)) == want[1:4]
    np.testing.assert_array_equal(pres_t.numpy(), want[4])


def test_drafts_match_jax():
    """The port's NGramDraft and FixedDraft propose what the JAX package's do."""
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 6, 60)
    for k in (1, 4, 7):
        jd, td = jspec.NGramDraft(n=2), NGramDraft(n=2)
        jd.observe(hist[:30])
        td.observe(hist[:30])
        for cut in range(31, 60, 3):
            np.testing.assert_array_equal(td(hist[30:cut], k), jd(hist[30:cut], k))
        seq = hist[10:25]
        for ctx in (hist[:12], hist[:20], hist[40:], np.zeros(0, np.int64)):
            np.testing.assert_array_equal(FixedDraft(seq)(ctx, k), jspec.FixedDraft(seq)(ctx, k))


@pytest.mark.parametrize("entry", ["video", "frames"])
def test_serve_entry_points_spec_matches_autoregressive(both, tmp_path, entry):
    """streaming_inference (a video file through the native ingest) and
    streaming_inference_frames with spec_decode=True give the greedy
    autoregressive responses, one chunk's answer forced to ground truth
    (the spec path's rollback + re-prefill)."""
    _, model = both
    stream = StreamConfig(window_size=3, text_round=3, text_sink=8, text_sliding_window=8,
                          max_tokens_per_chunk=4, kv_capacity=1024, prefill_buckets=(64, 128),
                          chunk_duration=1)
    kw = dict(cfg=CFG, model=model, tokenizer=FakeTokenizer(TOK), stream=stream,
              sampling=GREEDY, quiet=True, gt_lookup={"Time=2.0-3.0s": "a goal"})
    if entry == "video":
        from streaming_vlm_tpu.video import ingest  # the test video's writer
        from streaming_vlm_tpu_torch.config import VideoConfig

        path = str(tmp_path / "clip.mp4")
        ingest.write_test_video(path, w=64, h=48, n_frames=50, fps=10)
        kw.update(video_path=path, duration=5.0,
                  video=VideoConfig(fps=2.0, video_min_pixels=28 * 28,
                                    video_max_pixels=16 * 28 * 28))
        run = streaming_inference
    else:
        rng = np.random.default_rng(4)
        kw["frames"] = [rng.integers(0, 256, (2, 56, 56, 3), dtype=np.uint8) for _ in range(5)]
        run = streaming_inference_frames
    ar, t_ar = run(time_test=True, **kw)
    sp, t_sp = run(spec_decode=True, spec_k=3, time_test=True, **kw)
    assert len(sp) == 5
    assert [r["response"] for r in sp] == [r["response"] for r in ar]
    assert [t["kv"] for t in t_sp] == [t["kv"] for t in t_ar]
    assert [t["prefill_len"] for t in t_sp] == [t["prefill_len"] for t in t_ar]


def test_spec_refusals(both):
    """ValueError, naming the fix, for a raw arena, for rot_quant="int8"
    and for spec decode with recompute."""
    _, model = both
    b = tp.PromptBuilder(TOK, FakeTokenizer(TOK))
    px = _pixels()[0]
    for stream, match in ((_stream(prerotate_arena=False), "prerotate_arena"),
                          (_stream(kv_quant="int8", rot_quant="int8"), "rot_quant")):
        eng = StreamingEngine(CFG, model, stream, GREEDY, dtype=torch.float32)
        with pytest.raises(ValueError, match=match):
            eng.process_chunk_spec(_segs(b, 0), px, GRID)
        assert eng.cached == 0 and eng.table.total_len() == 0  # refused before any change
    with pytest.raises(ValueError, match="recompute"):
        StreamingSession(CFG, model, FakeTokenizer(TOK), stream=_stream(), spec_decode=True,
                         recompute=True)
