"""W8A8 weights (kernel K5's slice) against the JAX package's ops/quant.py on
the CPU: quantize_weight, qdot and the int8 product bitwise; the W8A8
model from the bridge and from the port's own quantize_model; the random
quantized model's layout; and the W8A8 engine against the JAX engine
across evictions (greedy). The kernel wrappers run their plain versions
here (CPU tensors).

The JAX functions run jitted, as the JAX package serves them (its
quantize_weight is jitted; qdot runs inside the jitted model): XLA then
multiplies by f32(1/127) where the source divides by 127, which the port
and K5 follow (ops/quant.py INV127)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import warm_cpu_math  # noqa: F401  (autouse fixture)

from test_torch_engine import _engine_parity, _parity_stream
from streaming_vlm_tpu.config import qwen25_vl_tiny
from streaming_vlm_tpu.models.qwen25_vl import model as jm
from streaming_vlm_tpu.ops import quant as jq
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.models.qwen25_vl import model as tm
from streaming_vlm_tpu_torch.ops import quant as tq

CFG = qwen25_vl_tiny()
jax_qdot = jax.jit(jq.qdot, static_argnames="out_dtype")
TIED = dataclasses.replace(CFG, text=dataclasses.replace(CFG.text, tie_word_embeddings=True))
PATCH_DIM = CFG.vision.in_channels * CFG.vision.temporal_patch_size * CFG.vision.patch_size**2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(x: np.ndarray, dtype):
    """The same values as a JAX array and a torch tensor in `dtype`."""
    if dtype == "bfloat16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t
    return jnp.asarray(x), torch.from_numpy(x)


def _rows(M=9, K=40, seed=0):
    """Activation rows: normal, one all-zero row (the 1e-12 clamp), one
    outlier row, and one row whose x / sx sit exactly half way between two
    integers (max|x| = 127 makes sx = 1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32) * 2
    x[2] = 0.0
    x[4, 7] = 900.0
    x[5, :8] = [127, 2.5, -3.5, 0.5, -0.5, 1.5, -2.5, 126.5]
    return x


def _weight(K=40, N=24, seed=1):
    """[in, out] (the JAX layout) with one all-zero output column and one
    outlier."""
    w = np.random.default_rng(seed).normal(size=(K, N)).astype(np.float32) * 0.05
    w[:, 3] = 0.0
    w[5, 6] = 4.0
    return w


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_weight_bitwise(dtype):
    jw, tw = _pair(_weight(), dtype)
    ref = jq.quantize_weight(jw, contract_axis=-2)
    q, s = tq.quantize_weight(tw.T)  # the port's [out, in]
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and q.is_contiguous()
    np.testing.assert_array_equal(q.T.numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref["s"])[0])
    assert float(s[3]) == np.float32(1e-12) and not q[3].any()


@pytest.mark.parametrize("out_dtype", [None, "float32"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_qdot_bitwise(dtype, out_dtype):
    jx, tx = _pair(_rows(), dtype)
    jw = jq.quantize_weight(jnp.asarray(_weight()), contract_axis=-2)
    q = torch.from_numpy(np.ascontiguousarray(np.asarray(jw["q"]).T))
    s = torch.from_numpy(np.array(jw["s"])[0])
    ref = jax_qdot(jx, jw, out_dtype=jnp.float32 if out_dtype else None)
    got = tq.qdot(tx, q, s, out_dtype=torch.float32 if out_dtype else None)
    assert got.dtype == (torch.float32 if out_dtype else tx.dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    assert not got[2].any()  # the zero row
    torch.testing.assert_close(tq.qdot_plain(tx, q, s), tq.qdot(tx, q, s), atol=0, rtol=0)
    # leading dims are flattened and restored
    got3 = tq.qdot(tx.reshape(3, 3, -1), q, s, out_dtype=got.dtype)
    torch.testing.assert_close(got3.reshape(got.shape), got, atol=0, rtol=0)


def test_qlinear_adds_bias_after_the_cast():
    """QLinear(x) == the JAX package's mm(x, w) + b in bf16, bitwise."""
    jx, tx = _pair(_rows(), "bfloat16")
    b = np.random.default_rng(2).normal(size=24).astype(np.float32)
    jb, tb = _pair(b, "bfloat16")
    lin = torch.nn.Linear(40, 24, dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(_weight().T).to(torch.bfloat16))
        lin.bias.copy_(tb)
    ql = tq.QLinear.from_linear(lin)
    jw = jq.quantize_weight(jnp.asarray(lin.weight.detach().float().numpy().T).astype(jnp.bfloat16))
    ref = jax.jit(lambda x, w, b: jq.mm(x, w) + b)(jx, jw, jb)
    got = ql(tx)
    assert got.dtype == torch.bfloat16 and ql.bias.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("M,K,N", [(1, 64, 48), (3, 36, 20), (7, 76, 33)])  # K % 16 != 0 too
def test_int8_gemm_plain_bitwise(M, K, N):
    """int8_gemm_plain (and int8_gemm on the CPU) against mm_kernel's body,
    lax.dot_general(..., preferred_element_type=int32), including the
    extreme sums (every product 127 * 127 or -127 * 127)."""
    rng = np.random.default_rng(M * K)
    a = rng.integers(-127, 128, (M, K), dtype=np.int8)
    b = rng.integers(-127, 128, (K, N), dtype=np.int8)
    a[0] = 127
    b[:, 0] = 127
    b[:, 1] = -127
    ref = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(b.T))
    for fn in (tq.int8_gemm_plain, tq.int8_gemm):
        got = fn(ta, tb)
        assert got.dtype == torch.int32 and got.shape == (M, N)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got[0, 0]) == 127 * 127 * K and int(got[0, 1]) == -127 * 127 * K


@pytest.fixture(scope="module", params=["untied", "tied"])
def trees(request):
    """(cfg, JAX f32 tree, its quantize_model_params tree) for an untied
    and a tied (lm_head_q) configuration."""
    cfg = CFG if request.param == "untied" else TIED
    params = jm.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    return cfg, params, jq.quantize_model_params(params)


def test_forward_full_w8a8_matches_jax(trees):
    """The bridged W8A8 tree's full forward (vision tower + decoder +
    lm_head, every projection through qdot) against the JAX forward_full
    on the same quantized tree: f32 logits within 3e-5 + 1e-4 |ref| (f32
    summation order; the int8 products are exact)."""
    cfg, _, qparams = trees
    model = from_jax_params(cfg, _np(qparams), device="cpu")
    assert tq.is_model_quantized(model) and tq.is_model_quantized(qparams)
    assert isinstance(model.text.lm_head, tq.QLinear)
    assert isinstance(model.vision.patch_embed, torch.nn.Linear)
    tok = cfg.tokens
    ids = np.array([tok.im_start, 40, 41, tok.vision_start] + [tok.video_pad] * 4
                   + [tok.vision_end, 50, 51, 52], np.int32)
    px = np.random.default_rng(0).normal(size=(16, PATCH_DIM)).astype(np.float32)
    kw = dict(video_grid_thw=np.array([(1, 4, 4)]), second_per_grid_ts=[1.0])
    ref = jm.forward_full(cfg, qparams, ids, pixel_patches=jnp.asarray(px), **kw)
    out = tm.forward_full(cfg, model, ids, pixel_patches=torch.from_numpy(px), **kw)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)


def test_quantize_model_matches_the_bridged_jax_tree(trees):
    """The port's quantize_model of the float model == the bridge of the
    JAX package's quantize_model_params, bitwise in every q and s."""
    cfg, params, qparams = trees
    got = tq.quantize_model(from_jax_params(cfg, _np(params), device="cpu"))
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
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        tq.quantize_model(got, bits=3)


@pytest.mark.parametrize("cfg", [CFG, TIED], ids=["untied", "tied"])
def test_random_quantized_model_layout(cfg):
    """random_quantized_model has the modules, shapes and dtypes of the
    bridge of the JAX package's random_quantized_model_params; text
    weights are int8 in [-127, 127] with s = 0.02 / 127."""
    jtree = jq.random_quantized_model_params(cfg, jax.random.PRNGKey(0))
    want = from_jax_params(cfg, _np(jtree), device="cpu", dtype=torch.bfloat16)
    got = tm.random_quantized_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    gs, ws = got.state_dict(), want.state_dict()
    assert gs.keys() == ws.keys()
    for k in ws:
        assert (gs[k].dtype, gs[k].shape) == (ws[k].dtype, ws[k].shape), k
    for m in got.text.modules():
        if isinstance(m, tq.QLinear):
            assert int(m.q.min()) >= -127 and m.q.unique().numel() > 100
            assert torch.equal(m.s, torch.full_like(m.s, 0.02 / 127.0))
    assert got.text.embed.weight.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def both_w8a8():
    """(JAX W8A8 tree, the port's model bridged from it), f32.

    int8 activation rounding is discontinuous. The two frameworks' f32
    paths differ by summation order (~1 ulp; qdot itself is bitwise equal,
    test_qdot_bitwise), and the ~1e-5 of activations that sit within that
    noise of a rounding midpoint round apart; the changed K/V row then
    reaches every later token. On qwen25_vl_tiny that moved a greedy token
    within 7 chunks in 6 of 20 (seed, arena, mode) runs (PRNGKeys 0-3 and 7
    over the four cases below; CPU, PyTorch 2.13). PRNGKey(0) agrees in all
    four, with 1, 4 and 16 torch threads."""
    params = jm.init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    qparams = jq.quantize_model_params(params)
    return qparams, from_jax_params(CFG, _np(qparams), device="cpu")


@pytest.mark.parametrize("pos_mode", ["shrink", "append"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_engine_w8a8_matches_jax(both_w8a8, kv_quant, pos_mode):
    """The W8A8 engine (every projection and the lm_head through qdot)
    against the JAX engine on the same quantized tree: greedy tokens,
    surviving ids, cached / uncached_tail and positions equal across
    evictions, over a float and an int8 arena (pre-rotated)."""
    stream = _parity_stream(pos_mode=pos_mode, kv_quant=kv_quant)
    assert _engine_parity(both_w8a8, stream) >= 2
