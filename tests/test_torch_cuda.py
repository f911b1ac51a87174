"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skips without one. Imports no jax, so that it runs on the card's
machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from streaming_vlm_tpu_torch.ops import attention as A
from streaming_vlm_tpu_torch.ops.quant import quantize_kv


def _assert_decode_close(out, ref):
    """A decode kernel's bf16 output vs its plain version: every step before
    the output's bf16 rounding is f32 in both, so one bf16 ulp of each value
    (rtol = 2^-7) plus 2^-12 of the largest |ref| (f32 summation noise near
    zero), as chip_smoke.py holds them."""
    out, ref = out.float(), ref.float()
    torch.testing.assert_close(out, ref, atol=2.0**-12 * float(ref.abs().max()), rtol=2.0**-7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda):
    """bf16 kernels vs their plain versions on unit-normal inputs at G=7
    (K1: atol = rtol = 2e-2, both round the output to bf16 and K1 also
    rounds the scaled q and P; K2: one bf16 ulp, _assert_decode_close)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    H, Hkv, hd, Cc, T = 28, 4, 128, 1024, 128

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(torch.bfloat16)

    q, ka, va, ks, vs = rn(T, H, hd), rn(Cc, Hkv, hd), rn(Cc, Hkv, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
    ang = torch.randn(Cc, hd // 2, generator=g, device=cuda)
    c2 = torch.cat([ang.cos()] * 2, -1).contiguous()
    s2 = torch.cat([ang.sin()] * 2, -1).contiguous()
    for vis in (0, 300, Cc):
        for cs in ((None, None), (c2, s2)):
            out = A.streaming_prefill_attention(q, ka, va, *cs, ks, vs, vis)
            ref = A.prefill_attention_plain(q, ka, va, *cs, ks, vs, vis)
            torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    ksm, vsm = rn(21, Hkv, hd), rn(21, Hkv, hd)
    for vis in (0, 300, Cc):
        for evis in (0, 7, 20):
            args = (q[0].contiguous(), ka, va, ksm, vsm, vis, evis)
            out = A.streaming_decode_attention_full(*args, e_delta=20)
            ref = A.decode_attention_plain(*args, e_delta=20)
            _assert_decode_close(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [True, False])
def test_raw_decode_kernel_matches_plain_on_card(cuda, quantized):
    """K3 (int8 or bf16 raw arena, dequant + mRoPE rotation in the kernel)
    vs its plain version at G=7, with shrink- and append-range positions,
    to one bf16 ulp (_assert_decode_close)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    H, Hkv, hd, Cc, E = 28, 4, 128, 1024, 20

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(torch.bfloat16)

    q, ksm, vsm = rn(H, hd), rn(E + 1, Hkv, hd), rn(E + 1, Hkv, hd)
    ka, va = rn(Cc, Hkv, hd), rn(Cc, Hkv, hd)
    if quantized:
        (kq, ks), (vq, vs) = quantize_kv(ka), quantize_kv(va)
    else:
        kq, ks, vq, vs = ka, None, va, None
    kw = dict(e_delta=E, mrope_section=(16, 24, 24), rope_theta=1e6)
    for top in (5000.0, 100_000.0):
        pos_t = torch.rand(Cc, 3, generator=g, device=cuda).mul(top).floor().contiguous()
        for vis in (0, 300, Cc):
            for evis in (0, 7, 20):
                args = (q, kq, ks, vq, vs, pos_t, ksm, vsm, vis, evis)
                out = A.streaming_decode_attention_int8(*args, **kw)
                ref = A.decode_attention_int8_plain(*args, **kw)
                _assert_decode_close(out, ref)


@pytest.mark.gpu
def test_partials_kernel_and_merge_match_on_card(cuda):
    """K4's partials vs its plain version (f32 sums of bf16 inputs: atol =
    rtol = 1e-3), and merged with the small block vs K2's output (one bf16
    ulp)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    H, Hkv, hd, Cc, E = 28, 4, 128, 1024, 20

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(torch.bfloat16)

    q, ka, va, ksm, vsm = rn(H, hd), rn(Cc, Hkv, hd), rn(Cc, Hkv, hd), rn(E + 1, Hkv, hd), rn(E + 1, Hkv, hd)
    for vis in (0, 300, Cc):
        got = A.streaming_decode_attention(q, ka, va, vis)
        want = A.decode_attention_partials_plain(q, ka, va, vis)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
        mask = torch.ones(1, E, dtype=torch.bool, device=cuda)
        one = torch.ones(1, 1, dtype=torch.bool, device=cuda)
        parts = [(ksm[:E], vsm[:E], mask), (ksm[E:], vsm[E:], one)]
        merged = A.decode_attention_merge(q[None], parts, ka, va, vis)
        k2 = A.streaming_decode_attention_full(q, ka, va, ksm, vsm, vis, E, e_delta=E)
        _assert_decode_close(merged.reshape(H, hd), k2)
