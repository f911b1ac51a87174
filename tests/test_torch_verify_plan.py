"""K2-verify's tensor-core schedule (csrc/verify_attention.cu) as a plain
model on the CPU, kept here (`verify_by_schedule`), at 7B widths (H 28, Hkv
4, hd 128): the host's split (ops/attention.py `verify_split_size`), the
T x G query rows of a kv head in m-tiles of 16 with the idle warps' key
groups, per part and key group an online softmax over 32-key steps whose
weights go through P.V rounded exactly as the kernel rounds them (bf16 hi +
bf16 lo), the key groups merged, and one fold of all T x G rows over the
parts. It is held against `verify_attention_plain` to K2's card tolerance
(one bf16 ulp of each value, rtol 2^-7, plus 2^-12 of the largest |ref|),
and the same model with P rounded to bf16 alone is shown to miss it: the
evidence for the hi/lo split. The kernel runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py hold it to the same tolerance)."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_cpu import one_cpu_thread, warm_cpu_math  # noqa: F401  (autouse fixtures)

from streaming_vlm_tpu_torch.ops import attention as A

H, HKV, HD = 28, 4, 128
G = H // HKV
C, E_DELTA = 9216, 28
SMS = 132  # an H100's SMs
TILE = 384  # csrc/verify_attention.cu: the largest split
STEP, WARPS = 32, 8  # keys a warp takes at once; warps a CTA
RTOL, ATOL_FRAC = 2.0**-7, 2.0**-12  # K2's card tolerance


def key_groups(T: int) -> int:
    """The warps that share an m-tile, each over its own steps: 8 // tiles."""
    return WARPS // -(-T * G // 16)


def _round_p(p: torch.Tensor, lo: bool) -> torch.Tensor:
    """The weights as P.V reads them: bf16 hi (+ bf16 of the rest)."""
    hi = p.to(torch.bfloat16).float()
    return hi + (p - hi).to(torch.bfloat16).float() if lo else hi


def part_partial(s, v, kg: int, lo: bool):
    """One part's partial of every query row: s [Hkv, R, n] log2-space
    logits (masked keys -inf), v [n, Hkv, hd]. Key group k runs the 32-key
    steps k, k + kg, ... in turn; a step's weights are exp2(s - the group's
    running max after it), rounded as P.V reads them, and later steps
    rescale the earlier ones (exactly, here); the groups then merge.
    Returns (m, l, acc) [Hkv, R], [Hkv, R], [Hkv, R, hd]."""
    Hkv, R, n = s.shape
    rounds = -(-n // (STEP * kg))
    pad = rounds * kg * STEP - n
    s = F.pad(s, (0, pad), value=-math.inf).reshape(Hkv, R, rounds, kg, STEP)
    v = F.pad(v.float(), (0, 0, 0, 0, 0, pad)).reshape(rounds, kg, STEP, Hkv, -1)
    run = torch.cummax(s.amax(-1), dim=2).values  # [Hkv, R, rounds, kg]
    base = torch.where(run == -math.inf, 0.0, run)
    p = torch.exp2(s - base[..., None])
    m = run[:, :, -1]  # [Hkv, R, kg]
    scale = torch.where(run == -math.inf, 0.0,
                        torch.exp2(base - torch.where(m == -math.inf, 0.0, m)[:, :, None]))
    l = (scale * p.sum(-1)).sum(2)
    acc = torch.einsum("hrikj,ikjhd->hrkd", scale[..., None] * _round_p(p, lo), v)
    mx = m.amax(-1)
    w = torch.where(m == -math.inf, 0.0, torch.exp2(m - mx[..., None]))
    return mx, (w * l).sum(-1), (w[..., None] * acc).sum(2)


def verify_by_schedule(q, ka, va, ksm, vsm, visible_len: int, extra_visible: int, *,
                       e_delta: int, split: int, lo: bool = True) -> torch.Tensor:
    """K2-verify's schedule in plain PyTorch: q [T, H, hd], arenas [C, Hkv,
    hd], small block [e_delta + T, Hkv, hd], all bf16. Query row r = t G + g
    of kv head h; each split of `decode_splits(visible_len, split)` and the
    small block give a partial (`part_partial`), and one fold of all T x G
    rows merges them. Returns [T, H, hd] bf16."""
    T = q.shape[0]
    Hkv, hd = ka.shape[1], ka.shape[2]
    R = T * G
    qr = q.float().reshape(T, Hkv, G, hd).permute(1, 0, 2, 3).reshape(Hkv, R, hd)
    qscale = np.float32(A.LOG2E / math.sqrt(hd))
    kg = key_groups(T)

    def logits(k):
        return torch.einsum("hrd,jhd->hrj", qr, k.float()) * qscale

    parts = [part_partial(logits(ka[lo_:hi_]), va[lo_:hi_], kg, lo)
             for lo_, hi_ in A.decode_splits(visible_len, split)]
    t_of_row = torch.arange(R) // G
    mask = A.verify_small_mask(T, ksm.shape[0], extra_visible, e_delta, "cpu")[t_of_row]
    parts.append(part_partial(logits(ksm).masked_fill(~mask[None], -math.inf), vsm, kg, lo))
    ms = torch.stack([m for m, _, _ in parts])
    mx = ms.amax(0)
    w = torch.where(ms == -math.inf, 0.0, torch.exp2(ms - mx))
    l = (w * torch.stack([p[1] for p in parts])).sum(0)
    acc = (w[..., None] * torch.stack([p[2] for p in parts])).sum(0)
    out = acc / l.clamp_min(1e-20)[..., None]  # [Hkv, R, hd]
    return out.reshape(Hkv, T, G, hd).permute(1, 0, 2, 3).reshape(T, H, hd).to(torch.bfloat16)


@pytest.fixture(scope="module")
def arena():
    rng = np.random.default_rng(12)
    return tuple(torch.from_numpy(rng.standard_normal((C, HKV, HD), np.float32)).to(torch.bfloat16)
                 for _ in range(2))


def _inputs(T: int, seed: int):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).to(torch.bfloat16)  # noqa: E731
    return f(T, H, HD), f(E_DELTA + T, HKV, HD), f(E_DELTA + T, HKV, HD)


def _within(got, want) -> bool:
    got, want = got.float(), want.float()
    atol = ATOL_FRAC * float(want.abs().max())
    return bool(((got - want).abs() <= atol + RTOL * want.abs()).all())


@pytest.mark.parametrize("visible", [0, 641, 9000])
@pytest.mark.parametrize("T", [2, 3, 8, 9, 16])
def test_schedule_within_k2_tolerance_of_plain(arena, T, visible):
    """The schedule, P as bf16 hi + lo, at every extra_visible, within
    K2's tolerance of the plain joint softmax."""
    ka, va = arena
    q, ksm, vsm = _inputs(T, T * 10000 + visible)
    split = A.verify_split_size(visible, HKV, SMS, TILE)
    for evis in (0, 5, E_DELTA):
        args = (q, ka, va, ksm, vsm, visible, evis)
        got = verify_by_schedule(*args, e_delta=E_DELTA, split=split)
        want = A.verify_attention_plain(*args, e_delta=E_DELTA)
        assert got.shape == want.shape == (T, H, HD)
        err = (got.float() - want.float()).abs()
        limit = ATOL_FRAC * float(want.float().abs().max()) + RTOL * want.float().abs()
        assert _within(got, want), (evis, float((err / limit).max()))


def test_p_in_bf16_alone_misses_k2_tolerance(arena):
    """With P rounded to bf16 alone (one P.V product), the same schedule
    leaves K2's tolerance in at least one case where hi + lo meets it."""
    ka, va = arena
    missed = []
    for T, visible, evis in ((8, 9000, 5), (8, 641, 5), (2, 40, 0), (16, 9000, 28)):
        q, ksm, vsm = _inputs(T, T + visible)
        args = (q, ka, va, ksm, vsm, visible, evis)
        split = A.verify_split_size(visible, HKV, SMS, TILE)
        want = A.verify_attention_plain(*args, e_delta=E_DELTA)
        assert _within(verify_by_schedule(*args, e_delta=E_DELTA, split=split), want)
        if not _within(verify_by_schedule(*args, e_delta=E_DELTA, split=split, lo=False), want):
            missed.append((T, visible, evis))
    assert missed


@pytest.mark.parametrize("visible", [0, 1, 641, 9000, 10240, 14848])
@pytest.mark.parametrize("n_sms", [132, 16])
def test_verify_split_tiles_the_visible_slots_once(visible, n_sms):
    """K2-verify's split: whole 32-key steps, at most the kernel's tile;
    every visible slot in one split; where the tile allows, the kv heads'
    splits and small blocks are at most one CTA an SM."""
    split = A.verify_split_size(visible, HKV, n_sms, TILE)
    assert split % A.VERIFY_SPLIT_ALIGN == 0 and A.VERIFY_SPLIT_ALIGN <= split <= TILE
    ranges = A.decode_splits(visible, split)
    assert sum(hi - lo for lo, hi in ranges) == visible
    if split < TILE:
        assert HKV * (len(ranges) + 1) <= n_sms
    assert len(ranges) + 1 <= A.decode_max_parts(visible, HKV, n_sms, TILE,
                                                 ctas_per_sm=A.VERIFY_CTAS_PER_SM)
