"""The port's CUDA kernels (K1-K5, K2-verify, K1-bwd, CE-row) against their
plain PyTorch versions, on the card. Skips without one. Imports no jax, so
that it runs on the card's machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import time

import pytest
import torch

import torch.nn.functional as F

from streaming_vlm_tpu_torch.config import qwen25_vl_tiny
from streaming_vlm_tpu_torch.models.qwen25_vl import language as lang
from streaming_vlm_tpu_torch.ops import attention as A
from streaming_vlm_tpu_torch.ops import quant as Q
from streaming_vlm_tpu_torch.ops.quant import quantize_kv


def _assert_decode_close(out, ref):
    """A decode kernel's bf16 output vs its plain version: every step before
    the output's bf16 rounding is f32 in both, so one bf16 ulp of each value
    (rtol = 2^-7) plus 2^-12 of the largest |ref| (f32 summation noise near
    zero), as chip_smoke.py holds them."""
    out, ref = out.float(), ref.float()
    torch.testing.assert_close(out, ref, atol=2.0**-12 * float(ref.abs().max()), rtol=2.0**-7)


def _assert_prefill_close(out, ref):
    """K1's bf16 output vs its plain version: K1 also rounds the scaled q
    and P to bf16 for the tensor cores, so one bf16 ulp of each value plus
    one bf16 ulp of the largest |ref|, as chip_smoke.py holds it."""
    out, ref = out.float(), ref.float()
    torch.testing.assert_close(out, ref, atol=2.0**-7 * float(ref.abs().max()), rtol=2.0**-7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda):
    """bf16 kernels vs their plain versions on unit-normal inputs at G=7
    (K1: _assert_prefill_close; K2: one bf16 ulp, _assert_decode_close)."""
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
            _assert_prefill_close(out, ref)
    ksm, vsm = rn(21, Hkv, hd), rn(21, Hkv, hd)
    for vis in (0, 300, Cc):
        for evis in (0, 7, 20):
            args = (q[0].contiguous(), ka, va, ksm, vsm, vis, evis)
            out = A.streaming_decode_attention_full(*args, e_delta=20)
            ref = A.decode_attention_plain(*args, e_delta=20)
            _assert_decode_close(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [64, 200, 640])
def test_prefill_kernel_edges_on_card(cuda, T):
    """K1 vs its plain version (_assert_prefill_close) where its tiles have
    edges: T * G off the 128-row tile (T = 200), visible lengths off the
    128-key tile (401) and the whole arena, both arena modes; one counted
    launch per call (raw mode's rotate pass and the merge pass included).
    A new plan reaches the card without a host sync."""
    g = torch.Generator(device=cuda).manual_seed(T)
    H, Hkv, hd, Cc = 28, 4, 128, 1024

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(torch.bfloat16)

    q, ka, va, ks, vs = rn(T, H, hd), rn(Cc, Hkv, hd), rn(Cc, Hkv, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
    ang = torch.randn(Cc, hd // 2, generator=g, device=cuda)
    c2 = torch.cat([ang.cos()] * 2, -1).contiguous()
    s2 = torch.cat([ang.sin()] * 2, -1).contiguous()
    for vis in (0, 401, Cc):
        for cs in ((None, None), (c2, s2)):
            n = A.launch_counts["streaming_prefill_attention"]
            out = A.streaming_prefill_attention(q, ka, va, *cs, ks, vs, vis)
            assert A.launch_counts["streaming_prefill_attention"] == n + 1
            ref = A.prefill_attention_plain(q, ka, va, *cs, ks, vs, vis)
            _assert_prefill_close(out, ref)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        A.streaming_prefill_attention(q, ka, va, None, None, ks, vs, 777)  # a new plan
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [True, False])
def test_raw_decode_kernel_matches_plain_on_card(cuda, quantized):
    """K3 (int8 or bf16 raw arena, dequant + mRoPE rotation in the kernel)
    vs its plain version at G=7, with shrink- and append-range positions,
    at visible lengths on and off the host's split up to the whole arena and
    with a small block longer than the kernel's 160-row tile, to one bf16
    ulp (_assert_decode_close). Each call is one counted launch and one
    kernel on the card (split pass, small block and combine)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    H, Hkv, hd, Cc, E = 28, 4, 128, 10240, 20

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(torch.bfloat16)

    q, ksm, vsm = rn(H, hd), rn(E + 1, Hkv, hd), rn(E + 1, Hkv, hd)
    kbig, vbig = rn(200, Hkv, hd), rn(200, Hkv, hd)
    ka, va = rn(Cc, Hkv, hd), rn(Cc, Hkv, hd)
    if quantized:
        (kq, ks), (vq, vs) = quantize_kv(ka), quantize_kv(va)
    else:
        kq, ks, vq, vs = ka, None, va, None
    kw = dict(e_delta=E, mrope_section=(16, 24, 24), rope_theta=1e6)
    name = "streaming_decode_attention_int8"
    for top in (5000.0, 100_000.0):
        pos_t = torch.rand(Cc, 3, generator=g, device=cuda).mul(top).floor().contiguous()
        for vis in (0, 1, 100, 641, 4501, 9000, Cc):
            for evis in (0, 7, 20):
                args = (q, kq, ks, vq, vs, pos_t, ksm, vsm, vis, evis)
                n = A.launch_counts[name]
                out = A.streaming_decode_attention_int8(*args, **kw)
                assert A.launch_counts[name] == n + 1
                ref = A.decode_attention_int8_plain(*args, **kw)
                _assert_decode_close(out, ref)
        args = (q, kq, ks, vq, vs, pos_t, kbig, vbig, 500, 60)
        _assert_decode_close(A.streaming_decode_attention_int8(*args, **dict(kw, e_delta=199)),
                             A.decode_attention_int8_plain(*args, **dict(kw, e_delta=199)))
    args = (q, kq, ks, vq, vs, pos_t, ksm, vsm, 9000, 7)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)  # device records outside the trace's host window are dropped
        for _ in range(3):
            A.streaming_decode_attention_int8(*args, **kw)
        torch.cuda.synchronize()
        time.sleep(0.05)
    kernels = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    assert len(kernels) == 3 and all("decode_raw_kernel" in k for k in kernels), kernels


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


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [
    (1, 3584, 512), (3, 1280, 520), (1, 3420, 1280), (5, 64, 33), (130, 3420, 1280),
    (640, 3584, 520), (200, 1280, 3420),
])
def test_int8_gemm_matches_plain_on_card(cuda, M, K, N):
    """K5's int32 form is bitwise equal to its plain version, on both paths
    (M <= 4: decode; else row tiles), with K % 16 != 0 (3420) and N, M off
    the tile."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    xq = torch.randint(-127, 128, (M, K), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (N, K), generator=g, device=cuda, dtype=torch.int8)
    n = Q.launch_counts["int8_gemm"]
    got = Q.int8_gemm(xq, wq)
    assert Q.launch_counts["int8_gemm"] == n + 1
    assert torch.equal(got, Q.int8_gemm_plain(xq, wq))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 5, 300])
@pytest.mark.parametrize("K", [1280, 3420])
@pytest.mark.parametrize("x_dtype,out_dtype,bias", [
    (torch.bfloat16, torch.bfloat16, True), (torch.bfloat16, torch.float32, False),
    (torch.float32, torch.float32, True), (torch.float32, torch.bfloat16, False),
])
def test_qdot_matches_plain_on_card(cuda, M, K, x_dtype, out_dtype, bias):
    """K5's serving form (row quantization, int8 product, rescale, cast,
    + bias) is bitwise equal to qdot_plain, with an all-zero row and an
    outlier row."""
    g = torch.Generator(device=cuda).manual_seed(M * K)
    N = 520
    x = torch.randn(M, K, generator=g, device=cuda).to(x_dtype)
    if M > 2:
        x[1] = 0
        x[2, 7] = 500.0
    q = torch.randint(-127, 128, (N, K), generator=g, device=cuda, dtype=torch.int8)
    s = torch.rand(N, generator=g, device=cuda) * 1e-3 + 1e-5
    b = torch.randn(N, generator=g, device=cuda).to(out_dtype) if bias else None
    got = Q.qdot(x, q, s, b, out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got, Q.qdot_plain(x, q, s, b, out_dtype))


@pytest.mark.gpu
def test_lm_logits_are_f32_on_card(cuda):
    """bf16 hidden and weights: lm_logits is the f32 product (cuBLAS with an
    f32 output), within 1e-4 of max|logit| of the f32 product of the same
    bf16 operands; the W8A8 lm_head (K5, f32 out) equals its plain
    version."""
    cfg = qwen25_vl_tiny().text
    g = torch.Generator(device=cuda).manual_seed(3)
    lm = lang.LanguageModel(cfg, device=cuda, dtype=torch.bfloat16).requires_grad_(False)
    lm.lm_head.weight.copy_(torch.randn(lm.lm_head.weight.shape, generator=g, device=cuda))
    h = torch.randn(5, cfg.hidden_size, generator=g, device=cuda).to(torch.bfloat16)
    got = lang.lm_logits(cfg, lm, h)
    want = F.linear(h.float(), lm.lm_head.weight.float())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-4 * float(want.abs().max()), rtol=0)
    lm.lm_head = Q.QLinear.from_linear(lm.lm_head)
    got = lang.lm_logits(cfg, lm, h)
    want = Q.qdot_plain(h, lm.lm_head.q, lm.lm_head.s, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(300, 1280, 520), (130, 3420, 1280), (640, 3584, 512)])
@pytest.mark.parametrize("bn", [256, 128])
@pytest.mark.parametrize("max_split", [0, 1, 4])
def test_int8_gemm_every_plan_on_card(cuda, monkeypatch, M, K, N, bn, max_split):
    """K5's tiled path is bitwise equal to its plain version under every plan
    gemm_plan weighs (both tile widths, whole tiles and stream-K shares with
    int32 fixups), not only the one it picks; twice in a row, so that the
    fixup counters are back at zero after a call."""
    monkeypatch.setattr(Q, "gemm_plan", lambda M_, N_, K_, n: Q.stream_k_plan(M_, N_, K_, n, bn, max_split))
    Q._gemm_plan_on.cache_clear()
    try:
        g = torch.Generator(device=cuda).manual_seed(M + N + bn + max_split)
        xq = torch.randint(-127, 128, (M, K), generator=g, device=cuda, dtype=torch.int8)
        wq = torch.randint(-127, 128, (N, K), generator=g, device=cuda, dtype=torch.int8)
        want = Q.int8_gemm_plain(xq, wq)
        for _ in range(2):
            assert torch.equal(Q.int8_gemm(xq, wq), want)
    finally:
        Q._gemm_plan_on.cache_clear()


@pytest.mark.gpu
def test_padded_qlinear_on_card(cuda):
    """A QLinear with K = 3420 (vision down_proj) keeps rows padded to 3424
    bytes and runs the tiled path on them without a copy, bitwise equal to
    qdot_plain; its weight's tensor map is encoded once, not per call."""
    from streaming_vlm_tpu_torch.ops._kernels import lib

    g = torch.Generator(device=cuda).manual_seed(7)
    ql = Q.QLinear(3420, 1280, True, device=cuda, dtype=torch.bfloat16)
    ql.q.copy_(torch.randint(-127, 128, (1280, 3420), generator=g, device=cuda, dtype=torch.int8))
    ql.s.copy_(torch.rand(1280, generator=g, device=cuda) * 1e-3 + 1e-5)
    ql.bias.copy_(torch.randn(1280, generator=g, device=cuda))
    assert ql.q.stride(0) == 3424
    x = torch.randn(2040, 3420, generator=g, device=cuda).to(torch.bfloat16)
    want = Q.qdot_plain(x, ql.q, ql.s, ql.bias, torch.bfloat16)
    assert torch.equal(ql(x), want)
    n = lib().svt_int8_maps_encoded()
    assert torch.equal(ql(x), want)
    assert lib().svt_int8_maps_encoded() - n <= 1  # at most the activation's scratch


@pytest.mark.gpu
@pytest.mark.parametrize("vis,e1,evis", [(641, 21, 7), (4501, 21, 0), (500, 200, 60), (1, 21, 20)])
def test_decode_kernel_splits_on_card(cuda, vis, e1, evis):
    """K2 (one launch: split pass, small block, fused combine) at visible
    lengths off the host's split and with a small block longer than the
    kernel's 160-row tile, to one bf16 ulp; K4 over the same splits."""
    g = torch.Generator(device=cuda).manual_seed(vis + e1)
    H, Hkv, hd, Cc = 28, 4, 128, 8192

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(torch.bfloat16)

    q, ka, va, ksm, vsm = rn(H, hd), rn(Cc, Hkv, hd), rn(Cc, Hkv, hd), rn(e1, Hkv, hd), rn(e1, Hkv, hd)
    args = (q, ka, va, ksm, vsm, vis, evis)
    for _ in range(2):  # the per-kv-head counters are back at zero after a call
        _assert_decode_close(A.streaming_decode_attention_full(*args, e_delta=e1 - 1),
                             A.decode_attention_plain(*args, e_delta=e1 - 1))
    got = A.streaming_decode_attention(q, ka, va, vis)
    want = A.decode_attention_partials_plain(q, ka, va, vis)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2, 3, 8, 9, 16])
@pytest.mark.parametrize("vis", [0, 641, 4501, 8192 - 44])
def test_verify_kernel_on_card(cuda, T, vis):
    """K2-verify against its plain version to one bf16 ulp (as K2), and
    each of its rows against K2 on that query with the small block cut to
    the rows it sees, to the same tolerance (the tensor cores sum in
    another order than K2's f32 loop; at T = 1 the wrapper is K2, so
    bitwise); twice, so the per-kv-head counters are shown back at zero."""
    g = torch.Generator(device=cuda).manual_seed(T * 10000 + vis)
    H, Hkv, hd, Cc, e_delta = 28, 4, 128, 8192, 28

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(torch.bfloat16)

    q, ka, va = rn(T, H, hd), rn(Cc, Hkv, hd), rn(Cc, Hkv, hd)
    ksm, vsm = rn(e_delta + T, Hkv, hd), rn(e_delta + T, Hkv, hd)
    for evis in (0, 5, e_delta):
        args = (q, ka, va, ksm, vsm, vis, evis)
        for _ in range(2):
            out = A.streaming_verify_attention(*args, e_delta=e_delta)
            _assert_decode_close(out, A.verify_attention_plain(*args, e_delta=e_delta))
        for t in range(T):
            k2 = A.streaming_decode_attention_full(
                q[t], ka, va, ksm[: e_delta + t + 1], vsm[: e_delta + t + 1], vis, evis,
                e_delta=e_delta)
            if T == 1:
                assert torch.equal(out[t], k2), (t, evis)
            else:
                _assert_decode_close(out[t], k2)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 4, 8])
def test_decode_lane_forms_on_card(cuda, B):
    """K2's and K3's lane forms (one launch for B lanes, lengths from an
    int32 device tensor, lanes of a [B, L, C, Hkv, hd] arena) against their
    plain lane versions, to one bf16 ulp, with lanes shorter than one split
    and of length 0; twice, so the per-(lane, kv head) counters are shown
    back at zero."""
    g = torch.Generator(device=cuda).manual_seed(B)
    H, Hkv, hd, Cc, L, e1 = 28, 4, 128, 4096, 2, 21

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(torch.bfloat16)

    lens = [0, 1, 100, 641, 4001, 4096, 7, 3000][:B]
    vis = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q, ksm, vsm = rn(B, H, hd), rn(B, e1, Hkv, hd), rn(B, e1, Hkv, hd)
    ka, va = rn(B, L, Cc, Hkv, hd)[:, 1], rn(B, L, Cc, Hkv, hd)[:, 1]  # lane-strided layers
    kq, vq = quantize_kv(ka), quantize_kv(va)
    pos = (torch.rand(B, Cc, 3, generator=g, device=cuda) * 900).floor()
    kw = dict(e_delta=e1 - 1, mrope_section=(16, 24, 24), rope_theta=1e6)
    for _ in range(2):
        out = A.streaming_decode_attention_full(q, ka, va, ksm, vsm, vis, 7, e_delta=e1 - 1,
                                                max_visible=max(lens))
        _assert_decode_close(out, A.decode_attention_lanes_plain(q, ka, va, ksm, vsm, lens, 7,
                                                                 e_delta=e1 - 1))
        for arena in ((kq.q, kq.s, vq.q, vq.s), (ka, None, va, None)):
            out = A.streaming_decode_attention_int8(q, *arena, pos, ksm, vsm, vis, 7,
                                                    max_visible=max(lens), **kw)
            _assert_decode_close(out, A.decode_attention_int8_lanes_plain(
                q, *arena, pos, ksm, vsm, lens, 7, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("raw", [False, True])
def test_prefill_lane_form_on_card(cuda, raw):
    """K1's lane form (one plan over all lanes' units, lane-strided arena
    layers) at ragged visible lengths against its plain lane version."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, T, H, Hkv, hd, Cc, L = 4, 200, 28, 4, 128, 2048, 2

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(torch.bfloat16)

    q, ks, vs = rn(B, T, H, hd), rn(B, T, Hkv, hd), rn(B, T, Hkv, hd)
    ka, va = rn(B, L, Cc, Hkv, hd)[:, 0], rn(B, L, Cc, Hkv, hd)[:, 0]
    ang = torch.randn(B, Cc, hd // 2, generator=g, device=cuda)
    cs = ((torch.cat([ang.cos()] * 2, -1).contiguous(), torch.cat([ang.sin()] * 2, -1).contiguous())
          if raw else (None, None))
    vis = [0, 1, 1201, 2048]
    out = A.streaming_prefill_attention(q, ka, va, *cs, ks, vs, vis)
    _assert_prefill_close(out, A.prefill_attention_lanes_plain(q, ka, va, *cs, ks, vs, vis))


@pytest.mark.gpu
def test_prefill_recompute_shape_on_card(cuda):
    """K1 at recompute mode's shape: visible 0, the causal self block alone,
    T long enough for many row tiles per CTA (plain in row blocks: rows
    [r0, r1) over keys [0, r0) as a visible arena plus their causal block)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    T, H, Hkv, hd, rows = 3000, 28, 4, 128, 512

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(torch.bfloat16)

    q, ks, vs = rn(T, H, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
    out = A.streaming_prefill_attention(q, ks[:64], vs[:64], None, None, ks, vs, 0)
    ref = torch.cat([A.prefill_attention_plain(q[r:r + rows], ks, vs, None, None, ks[r:r + rows],
                                               vs[r:r + rows], r) for r in range(0, T, rows)])
    _assert_prefill_close(out, ref)


@pytest.mark.gpu
def test_frames_on_card(cuda):
    """uint8 frames: `upload_frames` keeps a card engine's frames on the
    card, `patchify_on_device` there equals the CPU's bit for bit, and the
    qwen2 tower's frames encode on the card is close to the CPU's."""
    import numpy as np

    from streaming_vlm_tpu_torch.config import SamplingConfig, StreamConfig, qwen2_vl_tiny
    from streaming_vlm_tpu_torch.models.qwen25_vl import model as tm
    from streaming_vlm_tpu_torch.models.qwen25_vl import vision as tv
    from streaming_vlm_tpu_torch.streaming.engine import StreamingEngine

    cfg = qwen2_vl_tiny()
    frames = np.random.default_rng(0).integers(0, 256, (2, 56, 84, 3), dtype=np.uint8)
    model = tm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    eng = StreamingEngine(cfg, model, StreamConfig(kv_capacity=512, prefill_buckets=(64,)),
                          SamplingConfig(), dtype=torch.float32)
    up = eng.upload_frames(frames)
    assert up.device.type == "cuda" and up.dtype == torch.uint8
    for dt in (torch.float32, torch.bfloat16):
        got = tv.patchify_on_device(cfg.vision, up, dt)
        want = tv.patchify_on_device(cfg.vision, torch.from_numpy(frames), dt)
        assert torch.equal(got.cpu(), want)
    out = tm.encode_video_frames(cfg, model, up, (1, 4, 6), dtype=torch.float32)
    cpu = tm.encode_video_frames(cfg, model.cpu(), frames, (1, 4, 6), dtype=torch.float32)
    torch.testing.assert_close(out.cpu(), cpu, atol=1e-4, rtol=1e-3)


def _int4_weight(g, N, K, dev):
    """A random packed int4 weight [N, K/2] (every nibble value) and group
    scales [N, ng]."""
    q4 = torch.randint(-128, 128, (N, K // 2), generator=g, device=dev, dtype=torch.int16)
    s = torch.rand(N, Q.int4_groups(K), generator=g, device=dev) * 1e-2 + 1e-4
    return q4.to(torch.int8), s


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 8, 31])
@pytest.mark.parametrize("K", [3584, 18944, 3592, 3616], ids=["ng28", "ng148", "ng1", "ng1-vec16"])
@pytest.mark.parametrize("x_dtype,out_dtype,bias", [
    (torch.bfloat16, torch.bfloat16, True), (torch.bfloat16, torch.float32, False),
    (torch.float32, torch.float32, True), (torch.float32, torch.bfloat16, False),
])
def test_qdot4_matches_plain_on_card(cuda, M, K, x_dtype, out_dtype, bias):
    """K5-int4 (row quantization in the prologue, nibbles sign-extended,
    int32 group sums, the group fold in order, cast, + bias) is bitwise
    equal to qdot4_plain, with an all-zero row and an outlier row; each call
    counts one launch."""
    g = torch.Generator(device=cuda).manual_seed(M * K)
    N = 520
    x = torch.randn(M, K, generator=g, device=cuda).to(x_dtype)
    if M > 2:
        x[1] = 0
        x[2, 7] = 500.0
    q4, s = _int4_weight(g, N, K, cuda)
    b = torch.randn(N, generator=g, device=cuda).to(out_dtype) if bias else None
    n = Q.path_counts["int4"]
    got = Q.qdot4(x, q4, s, b, out_dtype)
    assert Q.path_counts["int4"] == n + 1
    assert got.dtype == out_dtype
    assert torch.equal(got, Q.qdot4_plain(x, q4, s, b, out_dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 31])
@pytest.mark.parametrize("K,N", [(3584, 512), (3584, 3584), (18944, 520)],
                         ids=["kv", "q", "ng148"])
@pytest.mark.parametrize("slabs", [None, 2, 3, 37])
def test_qdot4_plans_on_card(cuda, M, K, N, slabs):
    """K5-int4 under the planner's plan and forced slabs (per-group records
    folded by each tile's last part), bitwise equal to qdot4_plain, twice in
    a row (the tile counters must come back to zero), bf16 and f32 out."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    if M > 2:
        x[1] = 0
        x[2, 7] = 500.0
    q4, s = _int4_weight(g, N, K, cuda)
    plan = Q.int4_plan(M, N, K, torch.cuda.get_device_properties(cuda).multi_processor_count,
                       slabs)
    for od in (torch.bfloat16, torch.float32, torch.float32):
        b = torch.randn(N, generator=g, device=cuda).to(od)
        assert torch.equal(Q._qdot4_with_plan(x, q4, s, b, od, slabs), Q.qdot4_plain(x, q4, s, b, od))
    if plan.slabs > 1:
        assert not Q._int4_scratch[x.device][1].any()


@pytest.mark.gpu
def test_qlinear4_and_lm_head_on_card(cuda):
    """QLinear4 at 1 row (K5-int4) and at 64 rows (the bf16 product, no
    launch) against qdot4_plain; the W4A8 lm_head's logits are f32."""
    cfg = qwen25_vl_tiny().text
    g = torch.Generator(device=cuda).manual_seed(5)
    lm = lang.LanguageModel(cfg, device=cuda, dtype=torch.bfloat16).requires_grad_(False)
    lm.lm_head.weight.copy_(torch.randn(lm.lm_head.weight.shape, generator=g, device=cuda))
    lm.lm_head = Q.QLinear4.from_weight(lm.lm_head.weight)
    for T in (1, 64):
        h = torch.randn(T, cfg.hidden_size, generator=g, device=cuda).to(torch.bfloat16)
        n = Q.path_counts["int4"]
        got = lang.lm_logits(cfg, lm, h)
        want = Q.qdot4_plain(h, lm.lm_head.q4, lm.lm_head.s, out_dtype=torch.float32)
        assert got.dtype == torch.float32
        assert Q.path_counts["int4"] == n + (T < 32)
        if T < 32:
            assert torch.equal(got, want)
        else:  # both the dequantized bf16 product with f32 sums, in their own order
            torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 64, 200, 640])
def test_attention_bwd_on_card(cuda, T):
    """K1-bwd against the plain algebra in f32 from the same bf16 inputs: two
    bf16 ulps of each value plus two of the largest (as chip_smoke.py holds
    it), and two calls bitwise equal (dQ's partials fold in a fixed order).
    Qwen2.5-VL-7B's heads (G = 7)."""
    _check_attention_bwd(cuda, T, 28, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 200])
def test_attention_bwd_g8_on_card(cuda, T):
    """As test_attention_bwd_on_card at Qwen2.5-VL-3B's heads (H 16, Hkv 2:
    G = 8, a row tile of 8 whole tokens)."""
    _check_attention_bwd(cuda, T, 16, 2)


def _check_attention_bwd(cuda, T, H, Hkv):
    g = torch.Generator(device=cuda).manual_seed(T)
    hd = 128

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(torch.bfloat16)

    q, k, v, do = rn(T, H, hd), rn(T, Hkv, hd), rn(T, Hkv, hd), rn(T, H, hd)
    with torch.no_grad():
        o, lse2 = A.train_attention_plain(q.float(), k.float(), v.float(), return_lse=True)
    o = o.reshape(T, H, hd).to(torch.bfloat16)
    got = A.attention_bwd(q, k, v, o, lse2, do)
    want = A.train_attention_bwd_plain(q, k, v, o, lse2, do)
    for a, b, c in zip(got, want, A.attention_bwd(q, k, v, o, lse2, do)):
        assert torch.equal(a, c)
    if T == 1:
        # one key: P = 1 and the exact dQ and dK are 0 (D = dP); each side
        # holds only the f32 rounding of D - dP, two sums of hd exact
        # products, each within (hd - 1) 2^-24 (twice that for an adder that
        # truncates) of the products' magnitudes: 2^-15 of it bounds dS, so
        # dQ = dS k scale and dK = sum over G heads of dS q scale
        G, scale = H // Hkv, hd**-0.5
        mag = (do.float().reshape(T, Hkv, G, hd).abs() * v.float()[:, :, None].abs()).sum(-1).max()
        ds = 2.0**-15 * float(mag)
        assert float(got[0].float().abs().max()) <= ds * float(k.float().abs().max()) * scale
        assert float(got[1].float().abs().max()) <= G * ds * float(q.float().abs().max()) * scale
        got, want = got[2:], want[2:]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b, atol=2.0**-6 * float(b.abs().max()), rtol=2.0**-6)


@pytest.mark.gpu
def test_train_attention_lse_and_autograd_on_card(cuda):
    """train_attention on bf16 card tensors: K1 (with its log-sum-exp, one
    f32 row each, within 1e-5 relative of the plain one) and K1-bwd under
    autograd, each launched once; an f32 card tensor raises."""
    g = torch.Generator(device=cuda).manual_seed(1)
    T, H, Hkv, hd = 300, 28, 4, 128
    q, k, v = (torch.randn(T, h, hd, generator=g, device=cuda).to(torch.bfloat16).requires_grad_()
               for h in (H, Hkv, Hkv))
    lse = torch.empty(T, H, device=cuda)
    A.streaming_prefill_attention(q.detach(), k.detach(), v.detach(), None, None, k.detach(),
                                  v.detach(), 0, lse=lse)
    ref = A.prefill_lse_plain(q.detach(), k.detach(), None, None, k.detach(), 0)
    torch.testing.assert_close(lse, ref, atol=1e-5 * float(ref.abs().max()), rtol=1e-5)
    A.reset_launch_counts()
    A.train_attention(q, k, v).float().square().sum().backward()
    assert A.launch_counts["streaming_prefill_attention"] == 1
    assert A.launch_counts["attention_bwd"] == 1
    with pytest.raises(ValueError):
        A.train_attention(q.detach().float(), k.detach().float(), v.detach().float())


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [4.0, 1.0])
@pytest.mark.parametrize("rows,V", [(1, 152064), (77, 152064), (33, 1001)])
def test_ce_rows_on_card(cuda, rows, V, scale):
    """CE-row against its plain version: the NLL to 1e-5 relative, dlog (in
    place over the logits) to 1e-5 of each value, with no absolute floor
    (logits of scale 4 put most probabilities far below 1e-6; scale 1 puts
    each near 1/V, as random weights do); masked rows and targets 0 and
    V - 1 among them; a V that is not a multiple of 4 takes the scalar
    loop."""
    from streaming_vlm_tpu_torch.ops import linear_ce as CE

    g = torch.Generator(device=cuda).manual_seed(rows)
    logits = torch.randn(rows, V, generator=g, device=cuda) * scale
    tgt = torch.randint(0, V, (rows,), generator=g, device=cuda)
    tgt[0] = V - 1
    tgt[-1] = 0
    mask = (torch.rand(rows, generator=g, device=cuda) > 0.3).float()
    mask[0] = 1.0
    a, b = logits.clone(), logits.clone()
    nll, ref = CE.ce_rows(a, tgt, mask, True), CE.ce_rows_plain(b, tgt, mask, True)
    torch.testing.assert_close(nll, ref, atol=1e-5 * float(ref.abs().max()), rtol=1e-5)
    torch.testing.assert_close(a, b, atol=0.0, rtol=1e-5)
