"""W4A8 weights (kernel K5-int4's slice) against the JAX package's
ops/quant.py on the CPU: quantize_weight_int4 bitwise at both group cases,
the nibble unpack against numpy for all 256 bytes, qdot4 at every path
(T < 32 with one and with several groups, bitwise; T >= 32, the bf16
product, within the stated tolerance), the bridge's {"q4", "s"} leaves
bitwise and quantize_model(bits=4) on a widened tiny config (hidden 256:
2 scale groups, intermediate 384: 3), and the W4A8 engine against the
JAX engine across evictions (greedy; down_proj with 3 groups). The kernel wrappers run their plain versions
here (CPU tensors).

The JAX functions run jitted, as the JAX package serves them: XLA
multiplies by f32(1/7) and f32(1/127) where the source divides, and
contracts qdot4's jnp.sum(acc * s, axis=0) into a chain of fused
multiply-adds, which the port follows (ops/quant.py INV7, fma_f32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from streaming_vlm_tpu import config as jc
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.ops import quant as jq
from streaming_vlm_tpu.streaming.engine import StreamingEngine as JaxEngine
from streaming_vlm_tpu.streaming.protocol import FakeTokenizer, PromptBuilder
from streaming_vlm_tpu_torch import config as tc
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.ops import quant as tq
from streaming_vlm_tpu_torch.streaming import protocol as tp
from streaming_vlm_tpu_torch.streaming.engine import StreamingEngine

jax_qdot4 = jax.jit(jq.qdot4, static_argnames="out_dtype")
jax_quant4 = jax.jit(jq.quantize_weight_int4)


def _wide(mod, tied=False):
    """qwen25_vl_tiny with hidden 256 (2 scale groups) and intermediate 384
    (3 groups); attention stays 64 wide (o_proj: one group)."""
    cfg = mod.qwen25_vl_tiny()
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, out_hidden_size=256),
        text=dataclasses.replace(cfg.text, hidden_size=256, intermediate_size=384,
                                 tie_word_embeddings=tied))



def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _weight(D, F, seed=1):
    """[in, out] (the JAX layout) with an all-zero output column and an
    outlier."""
    w = np.random.default_rng(seed).normal(size=(D, F)).astype(np.float32) * 0.05
    w[:, 3] = 0.0
    w[5, 6] = 4.0
    return w


def _rows(T, D, seed=0):
    """Activation rows as bf16 values: normal, one all-zero row and one
    outlier row where T > 2."""
    x = np.random.default_rng(seed).normal(size=(T, D)).astype(np.float32) * 2
    if T > 2:
        x[1] = 0.0
        x[2, 7] = 900.0
    t = torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _port_weight(jw):
    return (torch.from_numpy(np.array(np.asarray(jw["q4"]).T, order="C")),
            torch.from_numpy(np.array(np.asarray(jw["s"]).T, order="C")))


def test_nibble_unpack_all_bytes():
    """unpack_int4 == numpy's right_shift(left_shift(p, 4), 4) (low) and
    right_shift(p, 4) (high) for every byte value; the packing inverts it."""
    b = np.arange(-128, 128, dtype=np.int8)
    got = tq.unpack_int4(torch.from_numpy(b)[None])[0].numpy()
    np.testing.assert_array_equal(got[0::2], np.right_shift(np.left_shift(b, 4), 4))
    np.testing.assert_array_equal(got[1::2], np.right_shift(b, 4))
    q = torch.from_numpy(got)[None]
    np.testing.assert_array_equal(((q[:, 0::2] & 0xF) | (q[:, 1::2] << 4))[0].numpy(), b)


@pytest.mark.parametrize("D,F", [(256, 48), (384, 40), (200, 24)], ids=["ng2", "ng3", "ng1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_int4_bitwise(D, F, dtype):
    w = _weight(D, F)
    t = torch.from_numpy(w.T.copy()).to(getattr(torch, dtype))
    ref = jax_quant4(jnp.asarray(t.float().numpy().T).astype(dtype))
    q4, s = tq.quantize_weight_int4(t)
    assert q4.dtype == torch.int8 and q4.shape == (F, D // 2) and q4.is_contiguous()
    assert s.shape == (F, tq.int4_groups(D)) == (F, np.asarray(ref["s"]).shape[0])
    np.testing.assert_array_equal(q4.numpy(), np.asarray(ref["q4"]).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref["s"]).T)
    assert (s[3] == np.float32(1e-12)).all() and not q4[3].any()


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D,F", [(256, 48), (384, 40), (200, 24)], ids=["ng2", "ng3", "ng1"])
@pytest.mark.parametrize("T", [1, 4, 8, 31, 32, 64])
def test_qdot4_matches_jax(T, D, F, out_dtype):
    """Below 32 rows bitwise (int32 group sums are exact, the f32 steps
    are the jitted JAX function's). At 32 rows or more both sides multiply
    the dequantized bf16 weight with f32 accumulation in their own order:
    within 2^-8 |ref| (one bf16 ulp of a bf16 output) + 1e-5 max |ref|."""
    jx, tx = _rows(T, D, seed=T)
    jw = jax_quant4(jnp.asarray(_weight(D, F)))
    q4, s = _port_weight(jw)
    od_j, od_t = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    ref = np.asarray(jax_qdot4(jx, jw, out_dtype=od_j).astype(jnp.float32))
    got = tq.qdot4(tx, q4, s, out_dtype=od_t)
    assert got.dtype == od_t and got.shape == (T, F)
    got = got.float().numpy()
    if T < 32:
        np.testing.assert_array_equal(got, ref)
        if T > 2:
            assert not got[1].any()  # the zero row
    else:
        tol = 1e-5 * np.abs(ref).max() + (2.0**-8 * np.abs(ref) if out_dtype == "bfloat16" else 0)
        assert (np.abs(got - ref) <= tol).all()


@pytest.mark.parametrize("D", [256, 200], ids=["ng2", "ng1"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_qlinear4_bias_bitwise(dtype, D):
    """QLinear4(x) == the JAX package's jitted mm(x, w) + b, rows and bias
    in one dtype (kept by default), bitwise. bf16: the bias is added after
    the cast to bf16. f32: XLA fuses the last product (`* sx`, or `* (sx *
    s)` with one group) with `+ b` into one fused multiply-add, and so does
    the port (fma_f32)."""
    x = np.random.default_rng(3).normal(size=(5, D)).astype(np.float32)
    b = np.random.default_rng(4).normal(size=48).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    jw = jax_quant4(jnp.asarray(_weight(D, 48)))
    ref = jax.jit(lambda x, w, b: jq.mm(x, w) + b)(
        jnp.asarray(tx.float().numpy()).astype(dtype), jw,
        jnp.asarray(tb.float().numpy()).astype(dtype))
    lin = tq.QLinear4(D, 48, bias=True, dtype=tx.dtype)
    lin.q4, lin.s = _port_weight(jw)
    with torch.no_grad():
        lin.bias.copy_(tb)
    got = lin(tx)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_fma_f32_single_rounding():
    """fma_f32 rounds a * b + c once: exact cases, a case where a product
    then sum would round twice, and random values against a float64
    product rounded once to f32 when c = 0."""
    a = torch.tensor([3.0, 1.0 + 2.0**-23, 7.0], dtype=torch.float32)
    b = torch.tensor([0.5, 1.0 - 2.0**-23, 2.0**-30], dtype=torch.float32)
    c = torch.tensor([1.0, -1.0, 1.0], dtype=torch.float32)
    got = tq.fma_f32(a, b, c)
    assert got[0] == 2.5
    assert got[1] == -(2.0**-46)  # a * b - 1 exactly; a product then sum gives 0
    assert got[2] == 1.0
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    y = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(tq.fma_f32(x, y, torch.zeros(1000)), (x.double() * y.double()).float(),
                               atol=0, rtol=0)


@pytest.fixture(scope="module", params=["untied", "tied"])
def trees(request):
    """(port cfg, JAX f32 tree, its W4A8 quantize_model_params tree) at
    the widened width, untied and tied (lm_head_q)."""
    tied = request.param == "tied"
    jcfg, tcfg = _wide(jc, tied), _wide(tc, tied)
    params = jm.init_params(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    return tcfg, params, jq.quantize_model_params(params, text_bits=4)


def test_bridge_carries_q4_leaves_bitwise(trees):
    """Every {"q4", "s"} leaf becomes a QLinear4 with q4 = the JAX bytes
    transposed (the same nibbles) and s transposed; the vision tower stays
    int8 (QLinear)."""
    cfg, _, qparams = trees
    model = from_jax_params(cfg, _np(qparams), device="cpu")
    t = qparams["text"]
    for i, layer in enumerate(model.text.layers):
        for attr, key in (("q_proj", "q_w"), ("gate_proj", "gate_w"), ("down_proj", "down_w"),
                          ("o_proj", "o_w")):
            lin = getattr(layer, attr)
            assert isinstance(lin, tq.QLinear4)
            np.testing.assert_array_equal(lin.q4.numpy(), np.asarray(t["layers"][key]["q4"][i]).T)
            np.testing.assert_array_equal(lin.s.numpy(), np.asarray(t["layers"][key]["s"][i]).T)
    head = t.get("lm_head_q", t.get("lm_head"))
    assert isinstance(model.text.lm_head, tq.QLinear4)
    np.testing.assert_array_equal(model.text.lm_head.q4.numpy(), np.asarray(head["q4"]).T)
    np.testing.assert_array_equal(model.text.lm_head.s.numpy(), np.asarray(head["s"]).T)
    assert all(isinstance(m, tq.QLinear) for m in (model.vision.merger_fc1,
                                                   model.vision.blocks[0].qkv))
    assert tq.is_model_quantized(model) and tq.is_model_quantized(qparams)


def test_quantize_model_bits4_matches_the_bridged_jax_tree(trees):
    """The port's quantize_model(bits=4) of the float model == the bridge of
    quantize_model_params(text_bits=4), bitwise in every q4, q and s."""
    cfg, params, qparams = trees
    got = tq.quantize_model(from_jax_params(cfg, _np(params), device="cpu"), bits=4)
    want = from_jax_params(cfg, _np(qparams), device="cpu")
    gs, ws = got.state_dict(), want.state_dict()
    assert gs.keys() == ws.keys()
    n_q = 0
    for k in ws:
        assert gs[k].dtype == ws[k].dtype and gs[k].shape == ws[k].shape, k
        torch.testing.assert_close(gs[k], ws[k], atol=0, rtol=0, msg=k)
        n_q += gs[k].dtype == torch.int8
    L, depth = cfg.text.num_hidden_layers, cfg.vision.depth
    assert n_q == 7 * L + 1 + 5 * depth + 2


def _engine_cfg(mod):
    """qwen25_vl_tiny with intermediate 384: down_proj has 3 scale groups,
    the other products one. The hidden width stays 64: at 256 the f32
    reductions of the decoder (norms, attention) already differ in order
    between XLA and PyTorch, and with int8 activations such a difference
    flips a rounding now and then, which moves the logits far more than
    the difference (the W8A8 engines part there too)."""
    cfg = mod.qwen25_vl_tiny()
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, intermediate_size=384))


ENGINE_J, ENGINE_T = _engine_cfg(jc), _engine_cfg(tc)


@pytest.fixture(scope="module")
def engine_pair():
    params = jm.init_params(ENGINE_J, jax.random.PRNGKey(11), dtype=jnp.float32)
    qparams = jq.quantize_model_params(params, text_bits=4)
    return qparams, from_jax_params(ENGINE_T, _np(qparams), device="cpu")


@pytest.mark.parametrize("bucket", [31, 64], ids=["int-prefill", "bf16-prefill"])
def test_w4a8_engine_matches_jax_across_evictions(engine_pair, bucket):
    """The W4A8 engine against the JAX engine over 8 chunks: greedy tokens,
    surviving ids, occupancy and positions agree after every chunk, across
    evictions. Every decode product runs qdot4's int8 x int4 path (down_proj
    grouped, 3 groups; the rest one group). The chunks (at most 30 tokens,
    one video token each) prefill in a 31-row bucket, below qdot4's 32-row
    threshold (the int path again), or in a 64-row one (the bf16 product)."""
    qparams, model = engine_pair
    assert {lin.s.shape[1] for lin in model.text.modules() if isinstance(lin, tq.QLinear4)} \
        == {1, 3}
    assert _parity(qparams, model, (bucket,)) >= 2


def _parity(qparams, model, buckets):
    """8 chunks through both engines (greedy, f32); returns the evictions."""
    stream = jc.StreamConfig(text_round=2, window_size=2, chunk_duration=1, text_sink=4,
                             text_sliding_window=3, max_tokens_per_chunk=8, kv_capacity=512,
                             prefill_buckets=buckets)
    greedy = jc.SamplingConfig(do_sample=False, repetition_penalty=1.05)
    jeng = JaxEngine(ENGINE_J, qparams, stream, greedy, dtype=jnp.float32)
    teng = StreamingEngine(ENGINE_J, model, stream, greedy, dtype=torch.float32)
    tok = ENGINE_J.tokens
    jb, tb = PromptBuilder(tok, FakeTokenizer(tok)), tp.PromptBuilder(tok, FakeTokenizer(tok))
    end_bias = jb.measure_biases()[1]
    grid, n_vid = (1, 2, 2), 1
    v = ENGINE_J.vision
    patch_dim = v.in_channels * v.temporal_patch_size * v.patch_size**2
    rng = np.random.default_rng(3)
    evictions = 0
    for i in range(8):
        px = (rng.normal(size=(4, patch_dim)) * 0.1).astype(np.float32)

        def segs(b):
            return (b.previous_text_segments("p") if i == 0 else []) \
                + b.user_turn_segments(i, i, i + 1, n_vid, grid, 1.0,
                                       query="q" if i == 0 else None) \
                + b.assistant_open_segments(i)

        gj, _ = jeng.process_chunk(segs(jb), px, grid)
        gt, _ = teng.process_chunk(segs(tb), px, grid)
        np.testing.assert_array_equal(gt, gj, err_msg=f"generation diverged at chunk {i}")
        jeng.commit_assistant(gj, end_bias, i)
        teng.commit_assistant(gt, end_bias, i)
        evictions += teng.cached_after_evict < teng.cached_before_evict
        np.testing.assert_array_equal(teng.table.token_ids(), jeng.table.token_ids())
        assert (teng.cached, teng.uncached_tail) == (jeng.cached, jeng.uncached_tail)
        np.testing.assert_array_equal(teng.ids_arena[: teng.cached].numpy(),
                                      np.asarray(jeng.ids_arena[: jeng.cached]))
        np.testing.assert_allclose(teng._positions(), jeng._positions(), atol=1e-5)
    return evictions
