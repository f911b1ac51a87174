"""The port's int8 KV quantization (ops/quant.py) against the JAX package's
quantize_kv / dequantize_kv as the JAX engine runs them, under jit: bitwise
on q and s, and on the dequantized values, including all-zero rows and
values whose x / s is exactly half way between two integers (both
frameworks round half to even)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streaming_vlm_tpu.ops.quant import dequantize_kv as jax_dequantize_kv
from streaming_vlm_tpu.ops.quant import quantize_kv as jax_quantize_kv
from streaming_vlm_tpu_torch.ops.quant import (
    QuantKV,
    arena_capacity,
    as_float,
    compute_dtype,
    dequantize_kv,
    gather_slots,
    is_kv_quantized,
    lanes_layer,
    quantize_kv,
    storage,
    with_lanes,
    write_slots,
)

HD = 16
# the JAX engine calls quantize_kv only under jit (the chunk step's arena
# merge, the jitted arena init), where XLA turns / 127 into * f32(1/127)
jit_quantize_kv = jax.jit(jax_quantize_kv)


def _rows():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, HD)).astype(np.float32) * 3
    x[0, 1, 2] = 0.0  # all-zero row: s clamps to 1e-12, q = 0
    # max |x| = 127 makes s exactly 1, so these x / s sit exactly at .5
    half = np.array([127, 2.5, -3.5, 0.5, -0.5, 1.5, -2.5, 126.5] + [0] * (HD - 8), np.float32)
    x[1, 3, 0] = half
    x[1, 3, 1] = -half
    return x


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_dequantize_bitwise(dtype):
    x = _rows()
    if dtype == "bfloat16":
        tx = torch.from_numpy(x).to(torch.bfloat16)
        jx = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
    else:
        tx, jx = torch.from_numpy(x), jnp.asarray(x)
    ref = jit_quantize_kv(jx)
    got = quantize_kv(tx)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(ref["s"]))
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.q[1, 3, 0, :8].numpy(), [127, 2, -4, 0, 0, 2, -2, 126])
    assert float(got.s[0, 1, 2]) == np.float32(1e-12) and not got.q[0, 1, 2].any()

    deq = dequantize_kv(got, torch.float32)
    jdeq = jax_dequantize_kv(ref, jnp.float32)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    deq16 = dequantize_kv(got, torch.bfloat16).float().numpy()
    jdeq16 = np.asarray(jax_dequantize_kv(ref, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(deq16, jdeq16)


def test_quantize_kv_has_the_jitted_scales():
    """On 4096 seeded bf16 rows of [4, 128] the eager JAX function (a true
    division by 127) and the jitted one (a product with f32(1/127)) give
    different scales on some rows; the port gives the jitted bits, on q
    and s."""
    rng = np.random.default_rng(11)
    tx = torch.from_numpy(rng.normal(size=(4096, 4, 128)).astype(np.float32)).to(torch.bfloat16)
    jx = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
    eager, jitted = jax_quantize_kv(jx), jit_quantize_kv(jx)
    assert (np.asarray(eager["s"]) != np.asarray(jitted["s"])).any()
    got = quantize_kv(tx)
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(jitted["s"]))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(jitted["q"]))


def test_is_kv_quantized():
    q = quantize_kv(torch.ones(2, HD))
    assert is_kv_quantized(q) and isinstance(q, QuantKV)
    assert not is_kv_quantized(torch.ones(2, HD))


@pytest.mark.parametrize("quant", [False, True])
def test_arena_helpers_agree_across_representations(quant):
    """The representation helpers on a [L, C, Hkv, hd] arena: an int8 arena
    read back through them equals the float arena quantized as a whole."""
    x = torch.from_numpy(_rows()).transpose(0, 1).contiguous()  # [L=5, C=2, 3, HD]
    x = torch.cat([x, x.flip(1)], dim=1)  # C = 4
    arena = quantize_kv(torch.zeros_like(x)) if quant else torch.zeros_like(x)
    write_slots(arena, x[:, 1:3], 1)
    write_slots(arena, x[:, :1], 0)
    write_slots(arena, x[:, 3:], 3)
    with pytest.raises(ValueError, match="outside"):
        write_slots(arena, x[:, :2], 3)
    want = dequantize_kv(quantize_kv(x), torch.float32) if quant else x
    assert arena_capacity(arena) == 4
    torch.testing.assert_close(as_float(arena, torch.float32), want, atol=0, rtol=0)
    idx = torch.tensor([3, 0, 0, 2])
    torch.testing.assert_close(
        as_float(gather_slots(arena, idx), torch.float32), want.index_select(1, idx), atol=0, rtol=0
    )
    layer = lanes_layer(with_lanes(arena), 2)  # layer 2 of a one-lane [1, L, C, ...] arena
    torch.testing.assert_close(as_float(layer, torch.float32)[0], want[2], atol=0, rtol=0)
    data, scales = storage(layer)
    assert data.dtype == (torch.int8 if quant else torch.float32)
    assert (scales is not None) == quant and (scales is None or scales.shape == (1, 4, 3))
    assert compute_dtype(arena, torch.bfloat16) == (torch.bfloat16 if quant else torch.float32)
