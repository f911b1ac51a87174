"""Two checkouts of the port on one card, in turns: the one-stream device
times of K1 (T=640 over 9600 visible slots), K2 and K3 (int8; visible
9000), and K2-verify at T = 2, 8 and 16 (visible 9000, e_delta 28,
extra_visible 5), each timed twice; K1 also in its full-block mode at T =
4096 over 4096 keys, at T = 10240 visible 0, over 8 lanes of T = 1024 at
visible 0 (the MCQ batch) and with its log-sum-exp at T = 8192 visible 0,
each timed twice, and a hash of its output and log-sum-exp at T = 640 over
9600 and in the full-block mode at T = 4096 (the same seeded inputs in
every run: equal hashes mean bitwise equal results); K1-bwd's device time at training's T = 8192
(7B heads; O and the log-sum-exp from K1's forward) and in its full-block
mode at T = 4096 over 4096 keys (from K1's full-block forward), each timed
twice, with a hash of each one's dq, dk and dv;
K5-int4's device time with cold weights (each
call rotates over copies of its weight past 100 MB, twice the L2) at every
7B decode product (q_proj and k/v_proj with their bias, o_proj,
gate/up_proj, down_proj) at M = 1 and 8 rows, each timed twice, and its
CUDA-event time a call, back to back on one weight (the wrapper's host
time where it exceeds the device's), at gate/up and q_proj, M = 1; and with
--slices the chunk p50 of chip_smoke.py's slices C (random W8A8 weights)
and I (random bf16 weights quantized to W4A8), 20 chunks each.

    git archive <commit> | tar -x -C build/parent   # build/ is git-ignored
    python3 tools/ab_torch.py build/parent [--slices CI] [--only K1-bwd,K2]

Runs the other checkout, this one, this one, the other (then this one and
the other once more without the slices), each in its own process from its
root, and prints one JSON line per run. Each checkout builds its own
kernels."""

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CODE = r'''
import contextlib, hashlib, io, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as c
from streaming_vlm_tpu_torch.ops import attention as A
from streaming_vlm_tpu_torch.ops.quant import quantize_kv
dev = "cuda"
g = torch.Generator(device=dev).manual_seed(1)
rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
H, Hkv, hd, C = 28, 4, 128, 10240
ka, va = rn(C, Hkv, hd), rn(C, Hkv, hd)
q, ks, vs = rn(640, H, hd), rn(640, Hkv, hd), rn(640, Hkv, hd)
qd, ksm, vsm = rn(H, hd), rn(21, Hkv, hd), rn(21, Hkv, hd)
(kq, ksc), (vq, vsc) = quantize_kv(ka), quantize_kv(va)
pos = (torch.rand(C, 3, generator=g, device=dev) * torch.tensor([C, 50.0, 50.0], device=dev)).floor()
kw = dict(e_delta=20, mrope_section=(16, 24, 24), rope_theta=1e6)
verify = {T: (rn(T, H, hd), rn(28 + T, Hkv, hd), rn(28 + T, Hkv, hd)) for T in (2, 8, 16)}
qf, kf, vf = rn(4096, H, hd), rn(4096, Hkv, hd), rn(4096, Hkv, hd)
q10, k10, v10 = rn(10240, H, hd), rn(10240, Hkv, hd), rn(10240, Hkv, hd)
qm, km, vm = rn(8, 1024, H, hd), rn(8, 1024, Hkv, hd), rn(8, 1024, Hkv, hd)
lse_f, lse_640 = torch.empty(4096, H, device=dev), torch.empty(640, H, device=dev)
only = sys.argv[sys.argv.index("--only") + 1].split(",") if "--only" in sys.argv else None
want = lambda name: only is None or name in only  # noqa: E731
out = {}

def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


if want("K1"):
    out["K1 hashes"] = {
        "T=640 over 9600 (out, lse)": digest(
            A.streaming_prefill_attention(q, ka, va, None, None, ks, vs, 9600),
            (A.streaming_prefill_attention(q, ka, va, None, None, ks, vs, 9600, lse=lse_640), lse_640)[1]),
        "full-block T=4096 (out, lse)": digest(A.full_block_attention(qf, kf, vf, lse=lse_f), lse_f)}
for _ in range(2):
    if want("K1"):
        out.setdefault("K1", []).append(c._device_ms(lambda: A.streaming_prefill_attention(q, ka, va, None, None, ks, vs, 9600), n=50))
        out.setdefault("K1 full-block T=4096", []).append(c._device_ms(lambda: A.full_block_attention(qf, kf, vf, lse=lse_f), n=20))
        out.setdefault("K1 T=10240 visible 0", []).append(c._device_ms(lambda: A.streaming_prefill_attention(q10, k10, v10, None, None, k10, v10, 0), n=10))
        out.setdefault("K1 MCQ 8 lanes x 1024", []).append(c._device_ms(lambda: A.streaming_prefill_attention(qm, km, vm, None, None, km, vm, [0] * 8), n=20))
        lse8 = torch.empty(8192, H, device=dev)
        out.setdefault("K1 with lse T=8192 visible 0", []).append(c._device_ms(lambda: A.streaming_prefill_attention(q10[:8192], k10[:8192], v10[:8192], None, None, k10[:8192], v10[:8192], 0, lse=lse8), n=10))
    if want("K2"):
        out.setdefault("K2", []).append(c._device_ms(lambda: A.streaming_decode_attention_full(qd, ka, va, ksm, vsm, 9000, 7, e_delta=20), n=200))
    if want("K3"):
        out.setdefault("K3", []).append(c._device_ms(lambda: A.streaming_decode_attention_int8(qd, kq, ksc, vq, vsc, pos.contiguous(), ksm, vsm, 9000, 7, **kw), n=200))
    for T, (qv, kv, vv) in verify.items() if want("K2-verify") else ():
        out.setdefault("K2-verify", {}).setdefault(f"T={T}", []).append(c._device_ms(lambda: A.streaming_verify_attention(qv, ka, va, kv, vv, 9000, 5, e_delta=28), n=200))
if want("K1-bwd"):
    T8 = 8192
    qb, kb, vb, dob = rn(T8, H, hd), rn(T8, Hkv, hd), rn(T8, Hkv, hd), rn(T8, H, hd)
    lb = torch.empty(T8, H, device=dev)
    ob = A.streaming_prefill_attention(qb, kb, vb, None, None, kb, vb, 0, lse=lb)
    out["K1-bwd hashes"] = {"T=8192 (dq, dk, dv)": digest(*A.attention_bwd(qb, kb, vb, ob, lb, dob))}
    out["K1-bwd T=8192"] = [c._device_ms(lambda: A.attention_bwd(qb, kb, vb, ob, lb, dob), n=5) for _ in range(2)]
    del qb, kb, vb, dob, lb, ob
    torch.cuda.empty_cache()
    dof, lf = rn(4096, H, hd), torch.empty(4096, H, device=dev)
    of = A.full_block_attention(qf, kf, vf, lse=lf)
    full_bwd = lambda: A.attention_bwd(qf, kf, vf, of, lf, dof, causal=False)  # noqa: E731
    out["K1-bwd hashes"]["full-block T=4096 (dq, dk, dv)"] = digest(*full_bwd())
    out["K1-bwd full-block T=4096"] = [c._device_ms(full_bwd, n=10) for _ in range(2)]
    del dof, lf, of
from streaming_vlm_tpu_torch.ops import quant as Q
for what, K, N, bias in () if not want("K5-int4") else (("q_proj", 3584, 3584, True), ("k/v_proj", 3584, 512, True),
                         ("o_proj", 3584, 3584, False), ("gate/up_proj", 3584, 18944, False),
                         ("down_proj", 18944, 3584, False)):
    q4 = torch.randint(-128, 128, (N, K // 2), generator=g, device=dev, dtype=torch.int16).to(torch.int8)
    s = torch.rand(N, K // 128, generator=g, device=dev) * 1e-2 + 1e-4
    b = rn(N) if bias else None
    copies = [(q4, s)] + [(q4.clone(), s.clone()) for _ in range(-(-100 * 2**20 // (q4.numel() + 4 * s.numel())) - 1)]
    for M in (1, 8):
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        i = [0]
        def rotate():
            w, sc = copies[i[0] % len(copies)]
            i[0] += 1
            Q.qdot4(x, w, sc, b, torch.bfloat16)
        out.setdefault("K5-int4 cold", {})[f"{what} M={M}"] = [c._device_ms(rotate, n=max(20, 2 * len(copies))) for _ in range(2)]
        if M == 1 and what in ("q_proj", "gate/up_proj"):
            out.setdefault("K5-int4 event", {})[f"{what} M=1"] = [c._median_ms(lambda: Q.qdot4(x, q4, s, b, torch.bfloat16), reps=20, batch=50) for _ in range(2)]
    del copies, q4, s
    torch.cuda.empty_cache()
slices = sys.argv[sys.argv.index("--slices") + 1] if "--slices" in sys.argv else ""
if slices:
    from streaming_vlm_tpu_torch.config import StreamConfig, qwen25_vl_7b
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import init_params, random_quantized_model
    cfg = qwen25_vl_7b()
    L, mn, vision = cfg.text.num_hidden_layers, 20, 5 * cfg.vision.depth + 2
    expect = {  # launches a chunk, as chip_smoke.py's slices C and I
        "C": {"streaming_prefill_attention": L, "streaming_decode_attention_full": L * mn,
              "int8_gemm": 7 * L * (1 + mn) + (1 + mn) + vision, "int8_gemm/tiled": 7 * L + vision,
              "int8_gemm/gemv": 7 * L * mn + 1 + mn},
        "I": {"streaming_prefill_attention": L, "streaming_decode_attention_full": L * mn,
              "int8_gemm": vision, "int8_gemm/tiled": vision, "int8_gemm/int4": 7 * L * mn + mn + 1}}
    for name in slices:
        gen = torch.Generator(device=dev).manual_seed(0)
        model = (random_quantized_model(cfg, gen, device=dev) if name == "C" else
                 Q.quantize_model(init_params(cfg, gen, device=dev, dtype=torch.bfloat16), bits=4))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            c.phase_slice(cfg, model, 20, StreamConfig(kv_quant="int8"), expect[name])
        out[f"slice_{name.lower()}"] = [x.strip() for x in buf.getvalue().splitlines() if "chunk latency" in x][0]
        del model
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root (e.g. build/parent)")
    ap.add_argument("--slices", default="", help="also serve these of slices C and I "
                    "(e.g. CI; ~40 s a slice a run)")
    ap.add_argument("--only", default="", help="time only these kernels, comma-separated "
                    "(of K1, K2, K3, K2-verify, K1-bwd, K5-int4; default all)")
    args = ap.parse_args()
    if set(args.slices) - set("CI"):
        ap.error(f"--slices takes C and I, got {args.slices!r}")
    other = args.other.resolve()
    runs = [(other, args.slices), (REPO, args.slices), (REPO, args.slices), (other, args.slices),
            (REPO, ""), (other, "")]
    for root, slices in runs:
        r = subprocess.run([sys.executable, "-c", CODE] + (["--slices", slices] if slices else [])
                           + (["--only", args.only] if args.only else []),
                           cwd=root, capture_output=True, text=True, timeout=900)
        line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
        name = "this" if root == REPO else str(args.other)
        print(json.dumps({"checkout": name, **json.loads(line[0][7:])}) if line else
              f"{name}: failed\n{r.stdout[-2000:]}{r.stderr[-3000:]}", flush=True)
        if not line:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
