"""Two checkouts of the port on one card, in turns: the one-stream device
times of K1 (T=640 over 9600 visible slots), K2 and K3 (int8; visible
9000), each timed twice, and with --slice slice C's chunk p50 (20 chunks,
random W8A8 weights; as chip_smoke.py's slice C).

    git archive <commit> | tar -x -C build/parent   # build/ is git-ignored
    python3 tools/ab_torch.py build/parent [--slice]

Runs the other checkout, this one, this one, the other (then this one and
the other once more without --slice), each in its own process from its
root, and prints one JSON line per run. Each checkout builds its own
kernels."""

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CODE = r'''
import contextlib, io, json, sys
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
out = {"K1": [], "K2": [], "K3": []}
for _ in range(2):
    out["K1"].append(c._device_ms(lambda: A.streaming_prefill_attention(q, ka, va, None, None, ks, vs, 9600), n=50))
    out["K2"].append(c._device_ms(lambda: A.streaming_decode_attention_full(qd, ka, va, ksm, vsm, 9000, 7, e_delta=20), n=200))
    out["K3"].append(c._device_ms(lambda: A.streaming_decode_attention_int8(qd, kq, ksc, vq, vsc, pos.contiguous(), ksm, vsm, 9000, 7, **kw), n=200))
if "--slice" in sys.argv:
    from streaming_vlm_tpu_torch.config import StreamConfig, qwen25_vl_7b
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import random_quantized_model
    cfg = qwen25_vl_7b()
    model = random_quantized_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    L, mn = cfg.text.num_hidden_layers, 20
    expect = {"streaming_prefill_attention": L, "streaming_decode_attention_full": L * mn,
              "int8_gemm": 7 * L * (1 + mn) + (1 + mn) + 5 * cfg.vision.depth + 2,
              "int8_gemm/tiled": 7 * L + 5 * cfg.vision.depth + 2,
              "int8_gemm/gemv": 7 * L * mn + 1 + mn}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c.phase_slice(cfg, model, 20, StreamConfig(kv_quant="int8"), expect)
    out["slice_c"] = [x.strip() for x in buf.getvalue().splitlines() if "chunk latency" in x][0]
print("RESULT " + json.dumps(out))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root (e.g. build/parent)")
    ap.add_argument("--slice", action="store_true", help="also serve slice C (~1 min a run)")
    args = ap.parse_args()
    other = args.other.resolve()
    runs = [(other, args.slice), (REPO, args.slice), (REPO, args.slice), (other, args.slice),
            (REPO, False), (other, False)]
    for root, with_slice in runs:
        r = subprocess.run([sys.executable, "-c", CODE] + (["--slice"] if with_slice else []),
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
