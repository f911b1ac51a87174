"""Multi-stream serving: the port's MultiStreamEngine against the JAX
package's on qwen25_vl_tiny (f32, CPU, greedy; the kernels' plain lane
forms), both built from one set of weights through the bridge. Every round
of every scenario of tests/test_multistream.py must agree on the lanes'
tokens and counts, surviving ids, occupancy (cached, uncached_tail) and
positions, across eviction. Also: compact_arena_batched bitwise, the lane
forms' plain versions against B one-lane calls, and (port only) sampled
lanes against solo engines seeded the same way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu.config import SamplingConfig, StreamConfig, qwen25_vl_tiny
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.streaming.engine import compact_arena_batched as jax_compact_batched
from streaming_vlm_tpu.streaming.multistream import MultiStreamEngine as JaxMS
from streaming_vlm_tpu.streaming.protocol import FakeTokenizer, PromptBuilder
from streaming_vlm_tpu.ops.quant import quantize_kv as jax_quantize_kv
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.ops import attention as A
from streaming_vlm_tpu_torch.ops.quant import QuantKV
from streaming_vlm_tpu_torch.streaming import protocol as tp
from streaming_vlm_tpu_torch.streaming.engine import StreamingEngine, compact_arena_batched
from streaming_vlm_tpu_torch.streaming.multistream import MultiStreamEngine, lane_seed

CFG = qwen25_vl_tiny()
TOK = CFG.tokens
D = CFG.text.hidden_size
GRID = (1, 4, 4)
GRID_B = (1, 6, 4)  # a second resolution: 6 merged vision tokens against GRID's 4
N_VID = 4
N_VID_B = 6
PATCH_DIM = CFG.vision.in_channels * CFG.vision.temporal_patch_size * CFG.vision.patch_size**2
GREEDY = SamplingConfig(do_sample=False, repetition_penalty=1.05)
# distinct per-lane content: queries and start times (107.0 gives longer
# Time=a-bs strings, so chunk lengths differ within a round)
STREAMS = [("describe the scene", 0.0), ("commentate the match", 5.0), ("what is happening", 107.0)]


def _stream(**kw):
    d = dict(text_round=3, window_size=2, chunk_duration=1, text_sink=8, text_sliding_window=8,
             max_tokens_per_chunk=6, kv_capacity=1024, prefill_buckets=(64, 128))
    d.update(kw)
    return StreamConfig(**d)


@pytest.fixture(scope="module")
def both():
    params = jm.init_params(CFG, jax.random.PRNGKey(11), dtype=jnp.float32)
    return params, from_jax_params(CFG, jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _segs(builder, i, query, start, grid=GRID, n_vid=N_VID):
    out = []
    if i == 0:
        out.append(builder.system_segment())
        out.extend(builder.previous_text_segments("prev " + query))
        out.extend(builder.user_turn_segments(0, start, start + 1.0, n_vid, grid, 1.0, query=query))
    else:
        out.extend(builder.user_turn_segments(i, start + i, start + i + 1.0, n_vid, grid, 1.0))
    return out + builder.assistant_open_segments(i)


class Pair:
    """The JAX and the port's multi-stream engines over the same weights,
    driven with the same rounds; each round's results and lane state are
    held equal."""

    def __init__(self, both, n, stream=None, jax_stream=None, sampling=GREEDY):
        params, model = both
        stream = stream or _stream()
        self.j = JaxMS(CFG, params, jax_stream or stream, sampling, n_streams=n, dtype=jnp.float32)
        self.t = MultiStreamEngine(CFG, model, stream, sampling, n_streams=n, dtype=torch.float32)
        ftok = FakeTokenizer(TOK)
        self.jb = [PromptBuilder(TOK, ftok) for _ in range(n)]
        self.tb = [tp.PromptBuilder(TOK, ftok) for _ in range(n)]
        self.end_bias = self.jb[0].measure_biases()[1]
        self.n = n

    def reset_lane(self, b):
        self.j.reset_lane(b)
        self.t.reset_lane(b)
        self.jb[b], self.tb[b] = PromptBuilder(TOK, FakeTokenizer(TOK)), tp.PromptBuilder(
            TOK, FakeTokenizer(TOK))

    def round(self, lanes, ve=None, grid=GRID, commit=None, **kw):
        """lanes: per lane None (idle) or (chunk index, query, start, grid,
        n_vid); ve: [B, N, D] numpy (uniform) or a per-lane list (mixed).
        Runs both engines, checks, commits each active lane at `commit[b]`
        (default: its chunk index). Returns the port's outputs."""
        segs_j = [None if x is None else _segs(self.jb[b], *x) for b, x in enumerate(lanes)]
        segs_t = [None if x is None else _segs(self.tb[b], *x) for b, x in enumerate(lanes)]
        if isinstance(ve, list):
            vj = [None if e is None else jnp.asarray(e) for e in ve]
            vt = [None if e is None else torch.from_numpy(e) for e in ve]
        else:
            vj = None if ve is None else jnp.asarray(ve)
            vt = None if ve is None else torch.from_numpy(ve)
        oj = self.j.process_round(segs_j, vis_embeds=vj, grid_thw=grid, **kw)
        ot = self.t.process_round(segs_t, vis_embeds=vt, grid_thw=grid, **kw)
        for b in range(self.n):
            assert (oj[b] is None) == (ot[b] is None)
            if ot[b] is not None:
                np.testing.assert_array_equal(ot[b][0], np.asarray(oj[b][0]),
                                              err_msg=f"lane {b}: tokens")
                assert ot[b][1] == oj[b][1]
                i = lanes[b][0] if commit is None else commit[b]
                self.j.engines[b].commit_assistant(oj[b][0], self.end_bias, i)
                self.t.engines[b].commit_assistant(ot[b][0], self.end_bias, i)
        self.check_state()
        return ot

    def check_state(self):
        jids, tids = np.asarray(self.j.ids_arena), self.t.ids_arena.numpy()
        for b, (je, te) in enumerate(zip(self.j.engines, self.t.engines)):
            assert (te.cached, te.uncached_tail, te.chunk_index) == (
                je.cached, je.uncached_tail, je.chunk_index), f"lane {b}"
            assert te.cached + te.uncached_tail == te.table.total_len()
            np.testing.assert_array_equal(te.table.token_ids(), je.table.token_ids())
            np.testing.assert_array_equal(tids[b, : te.cached], jids[b, : je.cached],
                                          err_msg=f"lane {b}: surviving ids")
            np.testing.assert_allclose(te._positions(), je._positions(), atol=1e-5)


def _ve(seed, rounds, n, nv=N_VID):
    return np.random.default_rng(seed).normal(size=(rounds, n, nv, D)).astype(np.float32) * 0.1


def test_batched_rounds_match_jax_and_solo_engines(both):
    """3 lanes, 6 rounds past text_round=3 and window_size=2 (evictions),
    different chunk lengths in a round; and each lane equals a solo port
    engine fed the same chunks."""
    pair = Pair(both, 3)
    ve = _ve(3, 6, 3)
    outs = [pair.round([(i, q, s) for q, s in STREAMS], ve[i]) for i in range(6)]
    assert any(e.cached_after_evict < e.cached_before_evict for e in pair.t.engines)
    _, model = both
    for b, (q, s) in enumerate(STREAMS):
        eng = StreamingEngine(CFG, model, _stream(), GREEDY, dtype=torch.float32)
        builder = tp.PromptBuilder(TOK, FakeTokenizer(TOK))
        for i in range(6):
            gen, _ = eng.process_chunk(_segs(builder, i, q, s), grid_thw=GRID,
                                       vis_embeds=torch.from_numpy(ve[i, b]))
            eng.commit_assistant(gen, pair.end_bias, i)
            np.testing.assert_array_equal(gen, outs[i][b][0], err_msg=f"lane {b} round {i}")


@pytest.mark.parametrize("kv_quant,prerotate,pos_mode", [
    ("int8", False, "append"), ("int8", True, "shrink"), ("none", False, "shrink")],
    ids=["int8-raw-append", "int8-prerotated", "float-raw"])
def test_batched_arenas_match_jax(both, kv_quant, prerotate, pos_mode):
    """The int8 and raw arenas (K1 raw + K3's lane forms) and append-mode
    positions, 3 lanes across eviction; the JAX engine decodes the raw
    arena on its jnp route."""
    kw = dict(kv_quant=kv_quant, prerotate_arena=prerotate, pos_mode=pos_mode)
    pair = Pair(both, 3, _stream(**kw), _stream(**kw, decode_int8_kernel=False))
    ve = _ve(4, 5, 3)
    for i in range(5):
        pair.round([(i, q, s) for q, s in STREAMS], ve[i])


def test_idle_lane(both):
    """Lane 1 idles in rounds 2 and 4: lane 0 is untouched, lane 1 resumes
    where a solo engine that skipped those rounds would."""
    pair = Pair(both, 2)
    ve = _ve(5, 6, 2)
    clock = 0
    for i in range(6):
        idle = i in (2, 4)
        out = pair.round([(i, *STREAMS[0]), None if idle else (clock, *STREAMS[1])], ve[i])
        assert (out[1] is None) == idle
        clock += not idle


def test_reset_lane(both):
    """reset_lane hands lane 0 to a new client mid-flight; lane 1 goes on."""
    pair = Pair(both, 2)
    ve = _ve(6, 6, 2)
    for i in range(3):
        pair.round([(i, *STREAMS[b]) for b in range(2)], ve[i])
    pair.reset_lane(0)
    for j, i in enumerate(range(3, 6)):
        pair.round([(j, "summarize the events", 31.0), (i, *STREAMS[1])], ve[i])


def test_mixed_grid_round(both):
    """Lanes at different resolutions in one round (per-lane embeds padded
    to the round's largest count), with an idle lane mid-flight."""
    pair = Pair(both, 3)
    rng = np.random.default_rng(9)
    grids, nvs = [GRID, GRID_B, GRID], [N_VID, N_VID_B, N_VID]
    clocks = [0, 0, 0]
    for i in range(5):
        lanes, ve = [], []
        for b, (q, s) in enumerate(STREAMS):
            if b == 2 and i == 2:
                lanes.append(None)
                ve.append(None)
            else:
                lanes.append((clocks[b], q, s, grids[b], nvs[b]))
                ve.append(rng.normal(size=(nvs[b], D)).astype(np.float32) * 0.1)
        out = pair.round(lanes, ve, grid=grids)
        for b in range(3):
            clocks[b] += out[b] is not None


def test_per_lane_budgets(both):
    """Lane 0 capped at 3 tokens a round while lane 1 keeps the default 6."""
    pair = Pair(both, 2)
    ve = _ve(7, 4, 2)
    for i in range(4):
        out = pair.round([(i, *STREAMS[b]) for b in range(2)], ve[i], max_new=[3, None])
        assert len(out[0][0]) <= 3 + 1


def test_text_only_lane_in_vision_round(both):
    """An active lane whose chunk carries no video rides a uniform vision
    round as visionless (its rows of the stacked embeddings dropped)."""
    pair = Pair(both, 2)
    ve = _ve(8, 3, 2)
    for i in range(3):
        nv = 0 if i == 1 else N_VID
        pair.round([(i, *STREAMS[0]), (i, *STREAMS[1], GRID, nv)], ve[i])


def test_round_capacity_error_is_atomic(both):
    """A round that cannot fit raises before any lane changes, in both
    engines; the same round retried with a sane budget then agrees."""
    pair = Pair(both, 2)
    ve = _ve(9, 2, 2)
    pair.round([(0, "q", 0.0)] * 2, ve[0])
    lanes = [(1, "q", 0.0)] * 2
    for ms, builders in ((pair.j, pair.jb), (pair.t, pair.tb)):
        segs = [_segs(builders[b], *lanes[b]) for b in range(2)]
        with pytest.raises(ValueError, match="No lane state was modified"):
            ms.process_round(segs, vis_embeds=ve[1], grid_thw=GRID, max_new=10**6)
    pair.check_state()
    pair.round(lanes, ve[1])


def test_encode_rounds_match_solo_towers(both):
    """encode_round / encode_round_mixed == one vision-tower call per lane
    (and the JAX package's encode_video)."""
    params, model = both
    ms = MultiStreamEngine(CFG, model, _stream(), GREEDY, n_streams=3, dtype=torch.float32)
    rng = np.random.default_rng(12)
    S = int(np.prod(GRID))
    pats = rng.normal(size=(3, S, PATCH_DIM)).astype(np.float32) * 0.1
    got = ms.encode_round(pats, GRID)
    grids = [GRID, None, GRID_B]
    mixed = [None if g is None else rng.normal(size=(int(np.prod(g)), PATCH_DIM)).astype(
        np.float32) * 0.1 for g in grids]
    got_m = ms.encode_round_mixed(mixed, grids)
    assert got_m[1] is None
    for b in range(3):
        want = jm.encode_video(CFG, params, jnp.asarray(pats[b]), (GRID,))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    for b in (0, 2):
        want = jm.encode_video(CFG, params, jnp.asarray(mixed[b]), (grids[b],))
        np.testing.assert_allclose(got_m[b].numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_compact_arena_batched_bitwise(quant):
    """Per-lane gathers over [B, L, C, Hkv, hd] arenas (float or int8) and
    ids [B, C]: bitwise the JAX package's."""
    rng = np.random.default_rng(13)
    B, L, C, Hkv, hd = 3, 2, 16, 2, 8
    k = rng.normal(size=(B, L, C, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, L, C, Hkv, hd)).astype(np.float32)
    ids = rng.integers(0, 1000, (B, C)).astype(np.int32)
    src = np.stack([rng.permutation(C), np.arange(C), rng.integers(0, C, C)])
    if quant:
        jk, jv = jax_quantize_kv(jnp.asarray(k)), jax_quantize_kv(jnp.asarray(v))
        tq = lambda d: QuantKV(torch.from_numpy(np.array(d["q"])), torch.from_numpy(np.array(d["s"])))  # noqa: E731
        tk, tv = tq(jk), tq(jv)
    else:
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k), torch.from_numpy(v)
    rk, rv, rids = jax_compact_batched(jk, jv, jnp.asarray(ids), jnp.asarray(src, jnp.int32))
    gk, gv, gids = compact_arena_batched(tk, tv, torch.from_numpy(ids).long(), torch.from_numpy(src))
    np.testing.assert_array_equal(gids.numpy(), np.asarray(rids))
    for g, r in ((gk, rk), (gv, rv)):
        if quant:
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(r["q"]))
            np.testing.assert_array_equal(g.s.numpy(), np.asarray(r["s"]))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_lane_plain_versions_equal_single_lane_calls():
    """K1's, K2's and K3's lane forms on CPU tensors (their plain versions)
    equal B one-lane calls, lengths from host ints or a tensor."""
    rng = np.random.default_rng(14)
    B, T, H, Hkv, hd, C, E = 3, 8, 4, 2, 16, 64, 5
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    q, ka, va, ks, vs = f(B, T, H, hd), f(B, C, Hkv, hd), f(B, C, Hkv, hd), f(B, T, Hkv, hd), f(
        B, T, Hkv, hd)
    ang = f(B, C, hd // 2)
    c2, s2 = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
    vis = [0, 17, 64]
    for cs in ((None, None), (c2, s2)):
        got = A.streaming_prefill_attention(q, ka, va, *cs, ks, vs, vis)
        for b in range(B):
            want = A.streaming_prefill_attention(
                q[b], ka[b], va[b], *(None if x is None else x[b] for x in cs), ks[b], vs[b], vis[b])
            torch.testing.assert_close(got[b], want, rtol=0, atol=0)
    qd, ksm, vsm = f(B, H, hd), f(B, E + 1, Hkv, hd), f(B, E + 1, Hkv, hd)
    vis_t = torch.tensor([5, 0, 40], dtype=torch.int32)
    got = A.streaming_decode_attention_full(qd, ka, va, ksm, vsm, vis_t, 3, e_delta=E)
    for b in range(B):
        want = A.streaming_decode_attention_full(qd[b], ka[b], va[b], ksm[b], vsm[b],
                                                 int(vis_t[b]), 3, e_delta=E)
        torch.testing.assert_close(got[b], want, rtol=0, atol=0)
    kq, vq = (torch.from_numpy(rng.integers(-127, 128, (B, C, Hkv, hd)).astype(np.int8))
              for _ in range(2))
    ksc, vsc = (torch.from_numpy(rng.random((B, C, Hkv)).astype(np.float32) * 0.01)
                for _ in range(2))
    pos = torch.from_numpy(rng.integers(0, 200, (B, C, 3)).astype(np.float32))
    kw = dict(e_delta=E, mrope_section=(2, 3, 3), rope_theta=1e4)
    got = A.streaming_decode_attention_int8(qd, kq, ksc, vq, vsc, pos, ksm, vsm, vis_t, 2, **kw)
    for b in range(B):
        want = A.streaming_decode_attention_int8(qd[b], kq[b], ksc[b], vq[b], vsc[b], pos[b],
                                                 ksm[b], vsm[b], int(vis_t[b]), 2, **kw)
        torch.testing.assert_close(got[b], want, rtol=0, atol=0)


def test_sampled_lanes_match_solo_engines_and_idle_generator_holds(both):
    """Sampled (port only): each lane emits what a solo engine whose
    generator is seeded with the lane's seed emits, and an idle lane's
    generator does not advance (lane 1 idles in round 1 and then matches
    a solo engine that skipped that round)."""
    _, model = both
    sampling = SamplingConfig(temperature=0.9, repetition_penalty=1.05, seed=5)
    ms = MultiStreamEngine(CFG, model, _stream(), sampling, n_streams=2, dtype=torch.float32)
    builders = [tp.PromptBuilder(TOK, FakeTokenizer(TOK)) for _ in range(2)]
    _, end_bias = builders[0].measure_biases()
    ve = _ve(10, 4, 2)
    solo = []
    for b in range(2):
        s = SamplingConfig(temperature=0.9, repetition_penalty=1.05,
                           seed=lane_seed(sampling.seed, b, 2))
        solo.append((StreamingEngine(CFG, model, _stream(), s, dtype=torch.float32),
                     tp.PromptBuilder(TOK, FakeTokenizer(TOK))))
    clocks = [0, 0]
    for i in range(4):
        idle1 = i == 1
        state = ms.generators[1].get_state()
        segs = [_segs(builders[0], i, *STREAMS[0]),
                None if idle1 else _segs(builders[1], clocks[1], *STREAMS[1])]
        out = ms.process_round(segs, vis_embeds=torch.from_numpy(ve[i]), grid_thw=GRID)
        if idle1:
            assert out[1] is None and torch.equal(ms.generators[1].get_state(), state)
        for b in range(2):
            if out[b] is None:
                continue
            eng, bld = solo[b]
            gen, _ = eng.process_chunk(_segs(bld, clocks[b], *STREAMS[b]), grid_thw=GRID,
                                       vis_embeds=torch.from_numpy(ve[i, b]))
            np.testing.assert_array_equal(gen, out[b][0], err_msg=f"lane {b} round {i}")
            eng.commit_assistant(gen, end_bias, clocks[b])
            ms.engines[b].commit_assistant(out[b][0], end_bias, clocks[b])
            clocks[b] += 1
