#!/usr/bin/env python3
"""Where K5-int4's time goes on the card (the PyTorch port's W4A8 decode
product, streaming_vlm_tpu_torch/csrc/int4_gemv.cu).

    python3 tools/profile_k5_int4_torch.py [VARIANT ...]   # one CUDA card; ~6 min; the
                                                            # variants named are left out

Ablations: copies of the port under build/k5_int4_profile/<variant>/ with
one part of K5-int4 removed (their results are wrong; only their time
counts), built in parallel, then timed in turns (base, variants, base):
the profiler's device time of one call with cold weights (each call
rotates over copies of its weight past 100 MB, twice the L2) at the 7B
decode products, M = 1 and 8 rows, bf16 in and out.
  no rows      the rows' maxima and quantization skipped
  no products  each stage waited on and released, no mma and no fold
  rows only    no tile: the launch and the rows' prologue alone
  stream only  no rows and no products: the weight stream alone (and
               without the scales' boxes)
  no mma       the tensor-core products replaced by integer adds
  empty        no rows and no tile: the launch alone
Then the unmodified kernel under the planner's slabs and forced ones (1:
no split; more: K cut across CTAs, the tile's last part folding every
group's record) at the narrow and long-K products; and, as the card's reachable stream rate, the bytes read and
written by a 256 MiB device-to-device copy over its device time. Prints the
card's name and power limit first, one JSON line a run. First, a
timeline: a copy whose thread 0 of each CTA records the globaltimer at
entry, when the rows' loads and the ring have started, when the maxima are
known, when the rows are quantized, when its warp 0's first stage lands,
when that warp has read its last stage and when its tile is folded, for one
call at each decode product (M = 1, L2 flushed first). Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "k5_int4_profile"
SRC = "csrc/int4_gemv.cu"
# variant -> edits (file under streaming_vlm_tpu_torch/, text, replacement)
VARIANTS = {
    "base": [],
    "no rows": [
        (SRC, "f0 < total; f0 += THREADS * LOADS) {", "f0 < 0; f0 += THREADS * LOADS) {"),
        (SRC, "p0 < ngx * M; p0 += WARPS * LOADS) {", "p0 < 0; p0 += WARPS * LOADS) {"),
        (SRC, "  if (held) {\n", "  if (false) {\n"),
    ],
    "no products": [(SRC, "for (int nt = 0; nt < NT; ++nt) {\n        const int xr",
                     "for (int nt = 0; nt < 0; ++nt) {\n        const int xr")],
    "rows only": [(SRC, "const int nparts = first < T ? (T - 1 - first) / step + 1 : 0;",
                   "const int nparts = 0;")],
}
VARIANTS["stream only"] = VARIANTS["no rows"] + VARIANTS["no products"]
VARIANTS["stream only, no scales"] = VARIANTS["stream only"] + [
    (SRC, "mbar_arrive_expect_tx(&bars[islot], fold ? STAGE : S_OFF);",
     "mbar_arrive_expect_tx(&bars[islot], S_OFF);"),
    (SRC, "    if (fold) tma_load_2d(dst + S_OFF, smp, &bars[islot], gb, row);\n", "")]
VARIANTS["no mma"] = [(SRC, """  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));""",
                       "  d[0] += a0 ^ b0, d[1] += a1 ^ b1, d[2] += a2 ^ b0, d[3] += a3 ^ b1;")]
VARIANTS["empty"] = VARIANTS["no rows"] + VARIANTS["rows only"]
SHAPES = (("k/v_proj", 3584, 512), ("q/o_proj", 3584, 3584), ("gate/up_proj", 3584, 18944),
          ("down_proj", 18944, 3584))
ROWS = (1, 8)
SLABS = {"k/v_proj": (1, 2, 4), "q/o_proj": (1, 2, 4), "down_proj": (1, 2, 4)}
CODE = r'''
import json, sys
sys.path[:0] = [".", sys.argv[1]]   # this copy's port, the repository's chip_smoke
import torch
import chip_smoke as c
from streaming_vlm_tpu_torch.ops import quant as Q
shapes, rows, slabs = json.loads(sys.argv[2]), json.loads(sys.argv[3]), json.loads(sys.argv[4])
dev = "cuda"
g = torch.Generator(device=dev).manual_seed(0)
res = {}
for what, K, N in shapes:
    q4 = torch.randint(-128, 128, (N, K // 2), generator=g, device=dev, dtype=torch.int16).to(torch.int8)
    s = torch.rand(N, K // 128, generator=g, device=dev) * 1e-2 + 1e-4
    for M in rows:
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        for sl in [None] + slabs.get(what, []):
            key = f"{what} M={M}" + (f" slabs={sl}" if sl else "")
            res[key] = c._cold_device_ms(lambda w, sc: Q._qdot4_with_plan(x, w, sc, None, torch.bfloat16, sl), (q4, s))
    del q4, s
    torch.cuda.empty_cache()
src = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
dst = torch.empty_like(src)
res["copy 256 MiB (TB/s, read + written)"] = 2 * src.numel() / (c._device_ms(lambda: dst.copy_(src)) * 1e-3) / 1e12
print("RESULT " + json.dumps(res))
'''


# timeline marks: (text of the source, mark, before the text?, condition)
TL = "k5i4_ts[blockIdx.x][{k}] = t_;"
MARKS = (
    ("  uint8_t* sm = smem_raw", 0, True, "threadIdx.x == 0"),                       # entry
    ("  {\n    int cur = -1;", 1, True, "tid == 0"),                          # x asked for, ring started
    ("  if (tid < M) ssx[tid] = row_scale", 2, True, "tid == 0"),             # maxima known
    ("  if (warp >= busy) return;", 3, True, "tid == 0"),                    # rows quantized
    ("      const int gb = g0 + k * GS, n = min(GS, g1 - gb);", 4, True,
     "tid == 0 && part == 0 && k == 0"),                                    # first stage landed
    ("    if (split) {\n      __threadfence();", 5, True, "tid == 0 && part == nparts - 1"),  # last stage read
    ("    // rows 8 nt + 2t (+1) of channels n0 + g (+8)", 6, True,
     "tid == 0 && part == nparts - 1"),                                     # folded (split: the last part)
)
PHASES = ("ring started", "maxima", "rows quantized", "first stage (from entry)", "last stage read",
          "folded")
TIMELINE = (("k/v_proj", 3584, 512), ("q/o_proj", 3584, 3584), ("gate/up_proj", 3584, 18944),
            ("down_proj", 18944, 3584))
TL_CODE = r'''
import ctypes, json, sys
sys.path[:0] = [".", sys.argv[1]]
import torch
import chip_smoke as c
from streaming_vlm_tpu_torch.ops import _kernels, quant as Q
so = _kernels.lib()
so.svt_k5i4_timeline.argtypes = [ctypes.c_void_p]
dev = "cuda"
g = torch.Generator(device=dev).manual_seed(0)
out = {}
for what, K, N in json.loads(sys.argv[2]):
    q4 = torch.randint(-128, 128, (N, K // 2), generator=g, device=dev, dtype=torch.int16).to(torch.int8)
    s = torch.rand(N, K // 128, generator=g, device=dev) * 1e-2 + 1e-4
    x = torch.randn(1, K, generator=g, device=dev).to(torch.bfloat16)
    c._cold_device_ms(lambda w, sc: Q.qdot4(x, w, sc, None, torch.bfloat16), (q4, s))  # warm, L2 flushed
    host = torch.zeros(1024, 8, dtype=torch.int64)
    so.svt_k5i4_timeline(ctypes.c_void_p(0))  # clear
    junk = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev).fill_(1)  # L2 cold
    torch.cuda.synchronize()
    Q.qdot4(x, q4, s, None, torch.bfloat16)
    torch.cuda.synchronize()
    so.svt_k5i4_timeline(ctypes.c_void_p(host.data_ptr()))
    ts = host[host[:, 0] > 0]
    t0 = ts[:, 0].min()
    rel = (ts - t0).clamp_min(0).double() / 1e3  # us
    row = {"ctas": int(len(ts))}
    for k in range(1, 7):
        col = rel[ts[:, k] > 0, k]
        if len(col):
            row[k] = [round(float(col.median()), 3), round(float(col.max()), 3)]
    row["entry spread"] = round(float(rel[:, 0].max()), 3)
    out[what] = row
    del q4, s, junk
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
'''


# timeline copies (name -> edits): the kernel as it is
TL_VARIANTS = {"timeline": []}


def _timeline_copy(name: str = "timeline") -> Path:
    d = _copy(name, TL_VARIANTS[name])
    p = d / "streaming_vlm_tpu_torch" / SRC
    s = p.read_text().replace("namespace {\n", "__device__ unsigned long long k5i4_ts[1024][8];\nnamespace {\n", 1)
    for text, k, before, cond in MARKS:
        if s.count(text) != 1:
            raise AssertionError(f"timeline: {text!r} is not once in {SRC}")
        mark = ("  if (" + cond + ") { unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\""
                " : \"=l\"(t_)); " + TL.format(k=k) + " }\n")
        s = s.replace(text, mark + text if before else text + mark)
    s += ("\nextern \"C\" int svt_k5i4_timeline(void* host) {\n"
          "  if (!host) { static unsigned long long z[1024][8]; return (int)cudaMemcpyToSymbol(k5i4_ts, z, sizeof(z)); }\n"
          "  return (int)cudaMemcpyFromSymbol(host, k5i4_ts, sizeof(k5i4_ts));\n}\n")
    p.write_text(s)
    return d


def _copy(name: str, edits) -> Path:
    d = OUT / name.replace(" ", "_")
    shutil.copytree(REPO / "streaming_vlm_tpu_torch", d / "streaming_vlm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f, text, repl in edits:
        p = d / "streaming_vlm_tpu_torch" / f
        s = p.read_text()
        if s.count(text) != 1:
            raise AssertionError(f"{name}: {text!r} is not once in {f}")
        p.write_text(s.replace(text, repl))
    return d


def _run(d: Path, shapes, rows, slabs) -> dict:
    r = subprocess.run([sys.executable, "-c", CODE, str(REPO), json.dumps(shapes),
                        json.dumps(rows), json.dumps(slabs)],
                       cwd=d, capture_output=True, text=True, timeout=900)
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
    if not line:
        raise RuntimeError(f"{d.name}: failed\n{r.stdout[-2000:]}{r.stderr[-3000:]}")
    return json.loads(line[0][7:])


def main() -> int:
    skip = set(sys.argv[1:])  # variants to leave out
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    shutil.rmtree(OUT, ignore_errors=True)
    dirs = {name: _copy(name, edits) for name, edits in VARIANTS.items() if name not in skip}
    for name in TL_VARIANTS:
        if name not in skip:
            dirs[name] = _timeline_copy(name)
    build = [sys.executable, "-c",
             "from streaming_vlm_tpu_torch.ops import _kernels; _kernels.build()"]
    for p in [subprocess.Popen(build, cwd=d) for d in dirs.values()]:
        if p.wait():
            raise RuntimeError("a variant failed to build")
    for name in TL_VARIANTS:
        if name in skip:
            continue
        r = subprocess.run([sys.executable, "-c", TL_CODE, str(REPO), json.dumps(TIMELINE)],
                           cwd=dirs[name], capture_output=True, text=True, timeout=900)
        line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
        if not line:
            raise RuntimeError(f"{name}: failed\n{r.stdout[-2000:]}{r.stderr[-3000:]}")
        print(json.dumps({name + " (us from the first CTA's entry, median and last CTA, M=1, cold)":
                          {w: {PHASES[int(k) - 1] if k.isdigit() else k: v for k, v in row.items()}
                           for w, row in json.loads(line[0][7:]).items()}}), flush=True)
    order = [n for n in VARIANTS if n not in skip] + ["base"]
    for name in order:
        res = _run(dirs[name], SHAPES, ROWS, SLABS if name == "base" else {})
        print(json.dumps({"variant": name, "device_ms_cold": res}), flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
