#!/usr/bin/env python3
"""Where K3's time goes on the card (the PyTorch port's raw-arena decode
kernel, streaming_vlm_tpu_torch/csrc/decode_attention_raw.cu).

    python3 tools/profile_k3_torch.py            # one CUDA card; ~3 min

1. Ablations: copies of the port under build/k3_profile/<variant>/ with
   one part of K3 removed (its results are wrong; only its time counts),
   built in parallel, then timed in turns (base, variants, base): the
   profiler's device time of one call at visible 640, 4500 and 9000 (int8
   and bf16 arena, shrink-range positions), at the 7B decode shapes of
   chip_smoke.py phase 3 (H=28, Hkv=4, C=10240, e_delta 20).
2. Timeline: a copy whose K3 records, for thread 0 of each CTA, clock64 at
   its phase marks and the globaltimer at entry and exit, for one call at
   each visible length: the CTAs' start spread, each phase's cycles
   (median and largest, arena splits and small block apart) and when the
   CTAs end (the last of each kv head folds the partials).

Prints the card's name and power limit first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "k3_profile"
RAW = "csrc/decode_attention_raw.cu"
COMMON = "csrc/decode_common.cuh"
VISIBLE = (640, 4500, 9000)
# variant -> edits (file under streaming_vlm_tpu_torch/, text, replacement)
VARIANTS = {
    "base": [],
    "no sin/cos": [(RAW, "sincosf(ang, &sn, &cs);", "sn = ang; cs = 1.f - ang;")],
    "no fold": [(COMMON, "  if (!*s_last) return;\n", "  return;\n")],
    "no P.V": [
        (RAW, "acc[g][0] += p.x * v[0].x + p.y * v[1].x + p.z * v[2].x + p.w * v[3].x;", ""),
        (RAW, "acc[g][1] += p.x * v[0].y + p.y * v[1].y + p.z * v[2].y + p.w * v[3].y;", ""),
    ],
}
# timeline marks: (text of the source, mark index, before the text?)
MARKS = (
    ("  extern __shared__ unsigned char smem_raw[];\n", 0, False),  # entry
    ("  uint32_t parity = 0;\n", 1, False),                          # set-up done
    ("    // every chunk has landed", 2, True),                      # Q.K loop done
    ("    // softmax of query head g over the tile", 3, True),       # all chunks + barrier
    ("    // P.V: head dims 2 dp + {0, 1} of the groups of 4 rows", 4, True),  # softmax done
    ("  // the quarters meet in the K tile; the last CTA", 5, True),  # P.V done
)
PHASES = ("set-up", "Q.K", "last chunks + barrier", "softmax", "P.V + barrier", "finish_part")
MARK = ("  if (threadIdx.x == 0) {{ unsigned long long gt; asm volatile(\"mov.u64 %0, %%globaltimer;\""
        " : \"=l\"(gt)); const int cta = blockIdx.y * gridDim.x + blockIdx.x; k3_ts[cta][{k}] ="
        " (unsigned long long)clock64(); if ({k} == 0) k3_ts[cta][7] = gt; if ({k} == 6)"
        " k3_ts[cta][8] = gt; }}\n")


def _copy(name: str, edits) -> Path:
    d = OUT / name.replace(" ", "_").replace("/", "").replace(".", "")
    shutil.copytree(REPO / "streaming_vlm_tpu_torch", d / "streaming_vlm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f, text, repl in edits:
        p = d / "streaming_vlm_tpu_torch" / f
        s = p.read_text()
        if s.count(text) != 1:
            raise AssertionError(f"{name}: {text!r} is not once in {f}")
        p.write_text(s.replace(text, repl))
    return d


def _timeline_copy() -> Path:
    d = _copy("timeline", [])
    p = d / "streaming_vlm_tpu_torch" / RAW
    s = p.read_text().replace("namespace {\n", "__device__ unsigned long long k3_ts[4096][9];\nnamespace {\n", 1)
    for text, k, before in MARKS:
        if s.count(text) != 1:
            raise AssertionError(f"timeline: {text!r} is not once in {RAW}")
        s = s.replace(text, MARK.format(k=k) + text if before else text + MARK.format(k=k))
    end = "blockIdx.z * Hkv + kvh, kvh, s_slot[0], s_slot[1], gridDim.x, G);\n"
    if s.count(end) != 1:
        raise AssertionError(f"timeline: {end!r} is not once in {RAW}")
    s = s.replace(end, end + MARK.format(k=6))
    s += ('\nextern "C" int svt_k3_timeline(void* host) {\n'
          '  return (int)cudaMemcpyFromSymbol(host, k3_ts, sizeof(k3_ts));\n}\n')
    p.write_text(s)
    return d


def _inputs():
    import torch

    from streaming_vlm_tpu_torch.ops.quant import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(1)
    H, Hkv, hd, C, E = 28, 4, 128, 10240, 20
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    q, ksm, vsm, ka, va = rn(H, hd), rn(E + 1, Hkv, hd), rn(E + 1, Hkv, hd), rn(C, Hkv, hd), rn(C, Hkv, hd)
    (kq, ks), (vq, vs) = quantize_kv(ka), quantize_kv(va)
    pos = (torch.rand(C, 3, generator=g, device="cuda")
           * torch.tensor([C, 50.0, 50.0], device="cuda")).floor().contiguous()
    kw = dict(e_delta=E, mrope_section=(16, 24, 24), rope_theta=1e6)
    return {"int8": (q, kq, ks, vq, vs, pos, ksm, vsm), "bf16": (q, ka, None, va, None, pos, ksm, vsm)}, kw


def time_variant() -> dict:
    """Device ms of one K3 call by form and visible length (run in a copy)."""
    import torch

    from chip_smoke import _device_ms
    from streaming_vlm_tpu_torch.ops import attention as A

    forms, kw = _inputs()
    torch.cuda.synchronize()
    return {f"{form} {v}": _device_ms(lambda: A.streaming_decode_attention_int8(*args, v, 7, **kw), n=50)
            for form, args in forms.items() for v in VISIBLE}


def timeline() -> None:
    """Per-CTA phase marks of one int8 call at each visible length (run in
    the timeline copy)."""
    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.ops import _kernels
    from streaming_vlm_tpu_torch.ops import attention as A

    forms, kw = _inputs()
    so = _kernels.lib()
    so.svt_k3_timeline.argtypes = [ctypes.c_void_p]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for v in VISIBLE:
        for _ in range(3):
            A.streaming_decode_attention_int8(*forms["int8"], v, 7, **kw)
        torch.cuda.synchronize()
        buf = np.zeros((4096, 9), np.uint64)
        if so.svt_k3_timeline(buf.ctypes.data):
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        split = A.decode_split_size(v, 4, n_sms)
        n_parts = -(-v // split) + 1
        ts = buf[: 4 * n_parts].astype(np.int64)
        arena = np.arange(len(ts)) % n_parts != n_parts - 1
        cyc = np.diff(ts[:, 0:7], axis=1)
        start, end = ts[:, 7] - ts[:, 7].min(), ts[:, 8] - ts[:, 7].min()
        print(f"  timeline visible {v}: split {split}, {len(ts)} CTAs, start spread "
              f"{start.max() / 1e3:.2f} us, CTA end median {np.median(end) / 1e3:.2f} us, p90 "
              f"{np.percentile(end, 90) / 1e3:.2f}, last {end.max() / 1e3:.2f}")
        for k, name in enumerate(PHASES):
            a = cyc[arena, k]
            print(f"    {name:22s} arena splits: median {np.median(a):7.0f} max {a.max():7.0f} "
                  f"cycles; small block: median {np.median(cyc[~arena, k]):7.0f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: K3's profile runs only on the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    shutil.rmtree(OUT, ignore_errors=True)
    dirs = {name: _copy(name, edits) for name, edits in VARIANTS.items()}
    dirs["timeline"] = _timeline_copy()
    shutil.copy2(REPO / "chip_smoke.py", OUT)
    shutil.copy2(Path(__file__), OUT / "tools_k3.py")  # this module, importable in the copies
    build = [sys.executable, "-c", "from streaming_vlm_tpu_torch.ops import _kernels; _kernels.build()"]
    procs = [subprocess.Popen(build, cwd=d) for d in dirs.values()]
    if any(p.wait() for p in procs):
        raise SystemExit("a variant did not build")
    env_path = str(OUT)
    for name in [*VARIANTS, "base"]:
        code = (f"import sys, json; sys.path[:0] = [{str(dirs[name])!r}, {env_path!r}]; "
                "import tools_k3; print(json.dumps(tools_k3.time_variant()))")
        r = _run_in(dirs[name], code)
        print(f"  {name}: device ms {r}")
    _run_in(dirs["timeline"], f"import sys; sys.path[:0] = [{str(dirs['timeline'])!r}, "
            f"{env_path!r}]; import tools_k3; tools_k3.timeline()", echo=True)
    shutil.rmtree(OUT, ignore_errors=True)
    return 0


def _run_in(d: Path, code: str, echo: bool = False) -> str:
    """Run `code` in a fresh interpreter in copy d; its last line of output."""
    r = subprocess.run([sys.executable, "-c", code], cwd=d, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout[-3000:] + r.stderr[-3000:])
    if echo:
        print(r.stdout, end="")
    return r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""


if __name__ == "__main__":
    sys.exit(main())
