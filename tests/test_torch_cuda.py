"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skips without one. Imports no jax, so that it runs on the card's
machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from streaming_vlm_tpu_torch.ops import attention as A


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda):
    """bf16 kernels vs their plain versions on unit-normal inputs at G=7
    (atol = rtol = 2e-2: both round the output to bf16, K1 also rounds the
    scaled q and P)."""
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
            torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
