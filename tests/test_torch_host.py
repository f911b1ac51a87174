"""The port's numpy copies of the host modules (rope host half, segment
table, prompt protocol) held bitwise equal to the JAX package's, plus the
device-side position rebuild from descriptors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streaming_vlm_tpu.config import StreamConfig, qwen25_vl_tiny
from streaming_vlm_tpu.models.qwen25_vl import rope as jr
from streaming_vlm_tpu.streaming import protocol as jp
from streaming_vlm_tpu.streaming import segments as js
from streaming_vlm_tpu.streaming.engine import positions_from_descriptors as jax_pos_desc
from streaming_vlm_tpu_torch.models.qwen25_vl import rope as tr
from streaming_vlm_tpu_torch.streaming import protocol as tp
from streaming_vlm_tpu_torch.streaming import segments as ts
from streaming_vlm_tpu_torch.streaming.engine import positions_from_descriptors

CFG = qwen25_vl_tiny()
TOK = CFG.tokens


def test_rope_host_half_bitwise():
    ids = np.array(
        [5, 6, TOK.vision_start] + [TOK.video_pad] * 12 + [TOK.vision_end, 7]
        + [TOK.image_pad] * 4 + [8, 9], np.int32,
    )
    kw = dict(
        spatial_merge_size=2, tokens_per_second=2.0, second_per_grid_ts=[0.5],
        image_grid_thw=np.array([[1, 4, 4]]), video_token_id=TOK.video_pad,
        image_token_id=TOK.image_pad,
    )
    grid = np.array([[3, 4, 4]])
    p_ref, d_ref = jr.mrope_positions_from_ids(ids, grid, **kw)
    p, d = tr.mrope_positions_from_ids(ids, grid, **kw)
    np.testing.assert_array_equal(p, p_ref)
    assert d == d_ref
    segs = [("text", 3, None, 1.0), ("video", 0, (2, 6, 4), 0.5), ("text", 5, None, 1.0),
            ("image", 0, (1, 4, 2), 1.0)]
    seg_ref = [jr.PosSegment(k, n, g, s) for k, n, g, s in segs]
    seg_port = [tr.PosSegment(k, n, g, s) for k, n, g, s in segs]
    np.testing.assert_array_equal(
        tr.mrope_positions_from_segments(seg_port, spatial_merge_size=2, tokens_per_second=2.0),
        jr.mrope_positions_from_segments(seg_ref, spatial_merge_size=2, tokens_per_second=2.0),
    )
    for hd, theta in ((16, 1e6), (128, 1e6), (80, 1e4)):
        np.testing.assert_array_equal(tr.make_inv_freq(hd, theta), jr.make_inv_freq(hd, theta))


def _seg_tuples(segs):
    return [(s.kind, s.ids.tolist(), s.round, s.grid_thw, s.second_per_grid_t) for s in segs]


def test_protocol_bitwise():
    ftok = jp.FakeTokenizer(TOK)
    assert ftok("<|im_start|>user\nTime=1.0-2.0s") == tp.FakeTokenizer(TOK)("<|im_start|>user\nTime=1.0-2.0s")
    jb, tb = jp.PromptBuilder(TOK, ftok), tp.PromptBuilder(TOK, ftok)
    assert jb.measure_biases() == tb.measure_biases()
    stream = StreamConfig()
    for i in (0, 1, 5):
        for question in ("", "who scored?"):
            ref = jp.build_round_segs(jb, stream, 2, i, float(i), (1, 4, 6),
                                      query="describe", previous_text="so far", question=question)
            got = tp.build_round_segs(tb, stream, 2, i, float(i), (1, 4, 6),
                                      query="describe", previous_text="so far", question=question)
            assert _seg_tuples(got) == _seg_tuples(ref)


@pytest.mark.parametrize(
    "text_round,visual_round,sink,window", [(2, 2, 4, 3), (2, 4, 4, 3), (3, 1, None, 5)]
)
def test_segment_table_bitwise(text_round, visual_round, sink, window):
    """Scripted stream: identical segment lists through both tables, one
    eviction per round; plans, ids, masks, positions and descriptors equal."""
    ftok = jp.FakeTokenizer(TOK)
    jb, tb = jp.PromptBuilder(TOK, ftok), tp.PromptBuilder(TOK, ftok)
    stream = StreamConfig(fps=2.0)
    jt, tt = js.SegmentTable(), ts.SegmentTable()
    rng = np.random.default_rng(0)
    _, end_bias = jb.measure_biases()
    for i in range(9):
        pr = jt.evict(i, text_round=text_round, visual_round=visual_round,
                      text_sink=sink, text_sliding_window=window)
        pt = tt.evict(i, text_round=text_round, visual_round=visual_round,
                      text_sink=sink, text_sliding_window=window)
        np.testing.assert_array_equal(pt.src, pr.src)
        assert pt.changed == pr.changed
        grid = (1, 4, 4) if i % 2 else (2, 6, 4)
        for s in jp.build_round_segs(jb, stream, 2, i, float(i), grid, query="q", previous_text="prev text"):
            jt.append(s)
        for s in tp.build_round_segs(tb, stream, 2, i, float(i), grid, query="q", previous_text="prev text"):
            tt.append(s)
        gen = rng.integers(30, 900, size=rng.integers(1, 7)).astype(np.int32)
        gen = np.concatenate([gen, [TOK.im_end]]).astype(np.int32)
        cut = max(len(gen) - end_bias, 0)
        for table, mod in ((jt, js), (tt, ts)):
            table.append(mod.Seg(mod.ASST_BODY, gen[:cut], round=i))
            table.append(mod.Seg(mod.ASST_TAIL, gen[cut:], round=i))
        np.testing.assert_array_equal(tt.token_ids(), jt.token_ids())
        np.testing.assert_array_equal(tt.vision_mask(), jt.vision_mask())
        kw = dict(spatial_merge_size=2, tokens_per_second=2.0)
        np.testing.assert_array_equal(tt.positions(**kw), jt.positions(**kw))
        dr, nr, ar, xr = jt.position_descriptors(extra_text=5, **kw)
        dt, nt, at, xt = tt.position_descriptors(extra_text=5, **kw)
        assert (nt, at, xt) == (nr, ar, xr)
        for k in dr:
            np.testing.assert_array_equal(dt[k], dr[k])


def test_positions_from_descriptors():
    ftok = jp.FakeTokenizer(TOK)
    tb = tp.PromptBuilder(TOK, ftok)
    table = ts.SegmentTable()
    for i, grid in enumerate([(1, 4, 4), (2, 6, 4), (1, 8, 2)]):
        for s in tp.build_round_segs(tb, StreamConfig(), 2, i, float(i), grid, query="q"):
            table.append(s)
    kw = dict(spatial_merge_size=2, tokens_per_second=2.0)
    desc, _, total, _ = table.position_descriptors(extra_text=4, **kw)
    C = 256
    ref = np.asarray(jax_pos_desc({k: jnp.asarray(v) for k, v in desc.items()}, C))
    got = positions_from_descriptors({k: torch.from_numpy(v) for k, v in desc.items()}, C).numpy()
    np.testing.assert_array_equal(got, ref)
    # and they agree with the host re-index over the table's real slots
    np.testing.assert_array_equal(got[:, : table.total_len()], table.positions(**kw))
