"""Training attention of the port (ops/attention.py `train_attention`,
`train_attention_plain`, `train_attention_bwd_plain`, `attention_bwd` and
K1's log-sum-exp output) on the CPU: the plain forward and its gradients
against jax.grad of the JAX package's `_gqa_attention_chunked` and of the
naive form on the same numpy inputs, the backward algebra K1-bwd
implements against torch autograd of the plain forward, and the wrappers'
refusals (CUDA-side checks, reached here with meta tensors)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_cpu_thread  # noqa: F401  (autouse fixture)
from streaming_vlm_tpu.models.qwen25_vl.language import _gqa_attention_chunked, _gqa_attention_multi
from streaming_vlm_tpu_torch.ops import attention as A

SHAPES = [(37, 4, 2, 16), (19, 8, 1, 8)]  # T, H, Hkv, hd (ragged T; G 2 and 8)


def _inputs(T, H, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, H, hd), np.float32)
    k = rng.standard_normal((T, Hkv, hd), np.float32)
    v = rng.standard_normal((T, Hkv, hd), np.float32)
    w = rng.standard_normal((T, H * hd), np.float32)  # the loss's weights
    return q, k, v, w


def _jax_out_and_grads(q, k, v, w, q_block, dtype):
    T = q.shape[0]
    mask = jnp.tril(jnp.ones((T, T), bool))

    def f(q, k, v):
        if q_block:
            out = _gqa_attention_chunked(q, k, v, mask, q_block=q_block)
        else:
            out = _gqa_attention_multi(q, [(k, v, mask)])
        return out, jnp.sum(out.astype(jnp.float32) * w)

    @jax.jit
    def out_and_grads(*a):
        return f(*a)[0], jax.grad(lambda *b: f(*b)[1], argnums=(0, 1, 2))(*a)

    out, grads = out_and_grads(*[jnp.asarray(x, dtype) for x in (q, k, v)])
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_out_and_grads(q, k, v, w, q_block, dtype, fn):
    args = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = fn(*args, q_block)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out.detach().float().numpy(), [a.grad.float().numpy() for a in args]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "T{}_H{}_Hkv{}_hd{}".format(*s))
@pytest.mark.parametrize("q_block", [0, 8], ids=["naive", "chunked8"])
def test_plain_forward_and_grads_equal_jax_f32(shape, q_block):
    """train_attention_plain and its autograd gradients == the JAX forms
    and jax.grad in f32 (atol 1e-5); so is train_attention (the Function:
    plain forward, train_attention_bwd_plain backward)."""
    q, k, v, w = _inputs(*shape)
    jo, jg = _jax_out_and_grads(q, k, v, w, q_block, jnp.float32)
    for fn in (A.train_attention_plain, A.train_attention):
        to, tg = _torch_out_and_grads(q, k, v, w, q_block, torch.float32, fn)
        np.testing.assert_allclose(to, jo, atol=1e-5, rtol=0)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("q_block", [0, 16], ids=["naive", "chunked16"])
def test_plain_forward_and_grads_equal_jax_bf16(q_block):
    """The same in bf16 (the dtype chain: P cast to bf16 for P.V, 1 / sum
    cast to bf16), to 2e-2 of each tensor's largest value."""
    q, k, v, w = _inputs(64, 4, 2, 32, seed=1)
    jo, jg = _jax_out_and_grads(q, k, v, w, q_block, jnp.bfloat16)
    to, tg = _torch_out_and_grads(q, k, v, w, q_block, torch.bfloat16, A.train_attention_plain)
    for a, b in zip([to] + tg, [jo] + jg):
        np.testing.assert_allclose(a, b, atol=2e-2 * np.abs(b).max(), rtol=2e-2)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "T{}_H{}_Hkv{}_hd{}".format(*s))
@pytest.mark.parametrize("q_block", [0, 5])
def test_bwd_plain_equals_autograd_of_plain_forward(shape, q_block):
    """train_attention_bwd_plain (K1-bwd's algebra from the saved output and
    log2-space log-sum-exp, dK/dV summed over the G heads) == torch
    autograd of train_attention_plain, in f32 (atol 1e-5), in any row
    blocking."""
    q, k, v, _ = _inputs(*shape, seed=2)
    T, H, _, hd = shape
    d_out = np.random.default_rng(3).standard_normal((T, H, hd), np.float32)
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse2 = A.train_attention_plain(*args, return_lse=True)
    want = torch.autograd.grad(out, args, torch.from_numpy(d_out).reshape(T, H * hd))
    got = A.train_attention_bwd_plain(*[a.detach() for a in args], out.detach().reshape(T, H, hd),
                                      lse2.detach(), torch.from_numpy(d_out), q_block)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    # attention_bwd on CPU tensors is the plain version (all rows at once),
    # in the inputs' dtype
    saved = ([a.detach() for a in args], out.detach().reshape(T, H, hd), lse2.detach(),
             torch.from_numpy(d_out))
    cpu = A.attention_bwd(*saved[0], *saved[1:])
    for a, b in zip(cpu, A.train_attention_bwd_plain(*saved[0], *saved[1:])):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_lse_is_log2_of_the_softmax_denominator():
    """The plain forward's lse2 and K1's LSE output (plain version, both
    arena modes' layout) are log2 of each row's sum of exp over its causal
    logits; K1's output is unchanged by asking for it, and the lane form
    fills [B, T, H]."""
    q, k, v, _ = _inputs(33, 4, 2, 16, seed=4)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    s = torch.einsum("thd,shd->hts", qt, kt.repeat_interleave(2, dim=1)) / math.sqrt(16)
    s = s.masked_fill(~torch.ones(33, 33, dtype=torch.bool).tril(), -math.inf)
    want = (torch.logsumexp(s, -1) / math.log(2)).T
    _, lse2 = A.train_attention_plain(qt, kt, vt, return_lse=True)
    torch.testing.assert_close(lse2, want, atol=1e-5, rtol=1e-6)
    lse = torch.full((33, 4), math.nan)
    out = A.streaming_prefill_attention(qt, kt, vt, None, None, kt, vt, 0, lse=lse)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)
    assert torch.equal(out, A.streaming_prefill_attention(qt, kt, vt, None, None, kt, vt, 0))
    # an arena of 5 visible slots joins the softmax
    ka, va = torch.randn(8, 2, 16), torch.randn(8, 2, 16)
    lse = torch.empty(1, 33, 4)
    A.streaming_prefill_attention(qt[None], ka[None], va[None], None, None, kt[None], vt[None],
                                  [5], lse=lse)
    sa = torch.einsum("thd,shd->hts", qt, ka[:5].repeat_interleave(2, dim=1)) / math.sqrt(16)
    want_a = (torch.logsumexp(torch.cat([sa, s], -1), -1) / math.log(2)).T
    torch.testing.assert_close(lse[0], want_a, atol=1e-5, rtol=1e-6)
    with pytest.raises(ValueError, match="lse must be f32"):
        A.streaming_prefill_attention(qt, kt, vt, None, None, kt, vt, 0, lse=torch.empty(33, 3))


@pytest.mark.parametrize("case", ["f32", "hd64", "G16"])
def test_card_path_refuses_what_the_kernels_do_not_take(case):
    """On a non-CPU tensor (meta here: the checks run before any launch)
    train_attention and attention_bwd raise ValueError for f32 inputs,
    head_dim != 128 and G > 8; nothing falls back to the plain version."""
    T, H, Hkv, hd, dt = {"f32": (16, 4, 2, 128, torch.float32),
                         "hd64": (16, 4, 2, 64, torch.bfloat16),
                         "G16": (16, 16, 1, 128, torch.bfloat16)}[case]
    q = torch.empty(T, H, hd, dtype=dt, device="meta")
    k = torch.empty(T, Hkv, hd, dtype=dt, device="meta")
    with pytest.raises(ValueError):
        A.train_attention(q, k, k)
    lse = torch.empty(T, H, device="meta")
    with pytest.raises(ValueError):
        A.attention_bwd(q, k, k, q, lse, q)
