#!/usr/bin/env python3
"""Where K2-verify's time goes on the card (the PyTorch port's multi-query
verify attention, streaming_vlm_tpu_torch/csrc/verify_attention.cu), at
chip_smoke.py's verify shapes (H=28, Hkv=4, C=10240, e_delta 28,
extra_visible 5).

    python3 tools/profile_verify_torch.py            # one CUDA card; ~4 min

1. ptxas's registers and spills of the kernel, and a check of the kernel
   against its plain version at T in {1, 2, 3, 8, 9, 16} (K2's tolerance).
2. Split sweep: the profiler's device time of one call at T = 2, 8 and 16,
   visible 9000 (and 640, 4500), at every split the kernel takes (whole
   32-key steps up to its 384-row tile) and at the host's choice
   (`verify_split_size`).
3. Ablations: copies of the port under build/verify_profile/<variant>/
   with one part of the kernel removed (their results are wrong; only
   their time counts), built in parallel from the checkout's objects, then
   timed in turns (base, variants, base) at the host's split.
4. Timeline: a copy that records the globaltimer at each CTA's entry and
   arrival and at the folding CTAs' steps, for one call at each T.

Prints the card's name and power limit first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "verify_profile"
SRC = "csrc/verify_attention.cu"
T_TIMED = (2, 8, 16)
VISIBLE = (640, 4500, 9000)
SPLITS = tuple(range(32, 385, 32))
E_DELTA, EVIS = 28, 5
# variant -> edits (file under streaming_vlm_tpu_torch/, text, replacement)
VARIANTS = {
    "base": [],
    "no fold": [(SRC, "  if (!arrive_last(counters, kvh, n_parts, &s_last)) return;\n",
                 "  if (arrive_last(counters, kvh, n_parts, &s_last) && tid == 0) counters[kvh] = 0;\n"
                 "  return;\n")],
    "one warp issues the copies": [(SRC, "  for (int j = tid; j < rows; j += VT_THREADS) {\n",
                                    "  for (int j = tid; warp == 0 && j < rows; j += 32) {\n")],
    "no P_lo product": [(SRC, "          mma_m16n8k16_bf16(o[2 * nd2], pl, f[0], f[1]);\n", ""),
                        (SRC, "          mma_m16n8k16_bf16(o[2 * nd2 + 1], pl, f[2], f[3]);\n", "")],
    "no P.V": [(SRC, "          ldmatrix_x4_trans(f, vrow + (j0 + 16 * ks) * RS + 32 * nd2);\n"
                     "          mma_m16n8k16_bf16(o[2 * nd2], ph, f[0], f[1]);\n"
                     "          mma_m16n8k16_bf16(o[2 * nd2], pl, f[0], f[1]);\n"
                     "          mma_m16n8k16_bf16(o[2 * nd2 + 1], ph, f[2], f[3]);\n"
                     "          mma_m16n8k16_bf16(o[2 * nd2 + 1], pl, f[2], f[3]);\n", "")],
    "no Q.K": [(SRC, "          ldmatrix_x4(f, krow + (j0 + 16 * kb) * RS + 32 * kk);\n"
                     "          mma_m16n8k16_bf16(s[2 * kb], qa[kk], f[0], f[1]);\n"
                     "          mma_m16n8k16_bf16(s[2 * kb + 1], qa[kk], f[2], f[3]);\n", "")],
    "fold with 32 slots": [(SRC, "FOLD_SLOTS = 16;", "FOLD_SLOTS = 32;")],
    "stream only": [(SRC, "    for (int b = kg; b < n_steps; b += KG) {\n      mbar_wait(&bar[b], 0);\n",
                     "    for (int b = kg; b < n_steps; b += KG) {\n      mbar_wait(&bar[b], 0);\n"
                     "      if (b >= 0) continue;\n")],
}

# timeline marks (globaltimer, ns): every CTA's entry and arrival, and the
# folding CTA's steps: (text of the source, slot, before the text?)
GT = "({ unsigned long long g; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g)); g; })"
CTA_MARK = "  if (threadIdx.x == 0) vt_cta[blockIdx.y * gridDim.x + blockIdx.x][{k}] = " + GT + ";\n"
FOLD_MARK = "  if (threadIdx.x == 0) vt_fold[blockIdx.y][{k}] = " + GT + ";\n"
MARKS = (
    (CTA_MARK, "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n", 0, False),
    (CTA_MARK, "  // one arrival a CTA; the last of the kv head folds", 1, True),
    (FOLD_MARK, "  if (!arrive_last(counters, kvh, n_parts, &s_last)) return;\n", 0, False),
    (FOLD_MARK, "  {  // row r's maximum, weights and denominator", 1, True),
    (FOLD_MARK, "  __syncthreads();  // the weights are made; (m, l)'s space takes the sums\n", 2, False),
    (FOLD_MARK, "  float4* red = reinterpret_cast<float4*>(smem);", 3, True),
    (FOLD_MARK, "  if (tid == 0) counters[kvh] = 0;  // ready for the next call\n", 4, True),
)
FOLD_STEPS = ("(m, l) loaded", "weights", "parts summed", "rows written")


def _timeline_copy() -> Path:
    d = _copy("timeline", [])
    p = d / "streaming_vlm_tpu_torch" / SRC
    s = p.read_text().replace("namespace {\n", "__device__ unsigned long long vt_cta[4096][2];\n"
                              "__device__ unsigned long long vt_fold[8][5];\nnamespace {\n", 1)
    for mark, text, k, before in MARKS:
        if s.count(text) != 1:
            raise AssertionError(f"timeline: {text!r} is not once in {SRC}")
        m = mark.replace("{k}", str(k))
        s = s.replace(text, m + text if before else text + m)
    s += ('\nextern "C" int svt_verify_timeline(void* cta, void* fold) {\n'
          '  cudaError_t e = cudaMemcpyFromSymbol(cta, vt_cta, sizeof(vt_cta));\n'
          '  return (int)(e ? e : cudaMemcpyFromSymbol(fold, vt_fold, sizeof(vt_fold)));\n}\n')
    p.write_text(s)
    return d


def timeline() -> None:
    """One call at T = 2, 8, 16, visible 9000, in the timeline copy: when
    the CTAs start and arrive, and the folding CTAs' steps after the last
    arrival (us)."""
    import ctypes

    import numpy as np
    import torch

    from streaming_vlm_tpu_torch.ops import _kernels
    from streaming_vlm_tpu_torch.ops import attention as A

    so = _kernels.lib()
    so.svt_verify_timeline.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for T in T_TIMED:
        q, ka, va, ksm, vsm = _inputs(T)
        for _ in range(3):
            A.streaming_verify_attention(q, ka, va, ksm, vsm, 9000, EVIS, e_delta=E_DELTA)
        torch.cuda.synchronize()
        cta, fold = np.zeros((4096, 2), np.uint64), np.zeros((8, 5), np.uint64)
        if so.svt_verify_timeline(cta.ctypes.data, fold.ctypes.data):
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        n = 4 * (-(-9000 // A.verify_split_size(9000, 4, n_sms)) + 1)
        t0 = cta[:n, 0].astype(np.int64).min()
        start, arrive = (cta[:n, 0].astype(np.int64) - t0) / 1e3, (cta[:n, 1].astype(np.int64) - t0) / 1e3
        f = (fold[:4].astype(np.int64) - t0) / 1e3
        steps = np.diff(f, axis=1)
        print(f"  timeline T={T}: {n} CTAs, start spread {start.max():.2f} us, arrival median "
              f"{np.median(arrive):.2f} us, last {arrive.max():.2f} us; folds start "
              f"{f[:, 0].min():.2f}-{f[:, 0].max():.2f} us and end {f[:, 4].max():.2f} us; steps "
              f"(us, largest of 4 kv heads): " + ", ".join(
                  f"{name} {steps[:, k].max():.2f}" for k, name in enumerate(FOLD_STEPS)))


def _copy(name: str, edits) -> Path:
    d = OUT / name.replace(" ", "_").replace(".", "")
    shutil.copytree(REPO / "streaming_vlm_tpu_torch", d / "streaming_vlm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    obj = REPO / "build" / "torch_kernels" / "obj"
    shutil.copytree(obj, d / "build" / "torch_kernels" / "obj")  # compiles only what changed
    for f, text, repl in edits:
        p = d / "streaming_vlm_tpu_torch" / f
        s = p.read_text()
        if s.count(text) != 1:
            raise AssertionError(f"{name}: {text!r} is not once in {f}")
        p.write_text(s.replace(text, repl))
    return d


def _inputs(T: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(T)
    H, Hkv, hd, C = 28, 4, 128, 10240
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    return rn(T, H, hd), rn(C, Hkv, hd), rn(C, Hkv, hd), rn(E_DELTA + T, Hkv, hd), rn(E_DELTA + T, Hkv, hd)


def time_variant() -> dict:
    """Device ms of one call at the host's split, by T, visible 9000 (run in a copy)."""
    import torch

    from chip_smoke import _device_ms
    from streaming_vlm_tpu_torch.ops import attention as A

    out = {}
    for T in T_TIMED:
        q, ka, va, ksm, vsm = _inputs(T)
        torch.cuda.synchronize()
        out[f"T={T}"] = _device_ms(lambda: A.streaming_verify_attention(
            q, ka, va, ksm, vsm, 9000, EVIS, e_delta=E_DELTA), n=50)
    return out


def check_and_sweep() -> None:
    """Phase 1's check and phase 2's sweep, in the checkout."""
    import torch

    from chip_smoke import _device_ms
    from streaming_vlm_tpu_torch.ops import attention as A
    from streaming_vlm_tpu_torch.ops._kernels import lib

    worst = 0.0
    for T in (1, 2, 3, 8, 9, 16):
        q, ka, va, ksm, vsm = _inputs(T)
        for vis in (0, 640, 9000, 10240 - E_DELTA - T):
            for evis in (0, EVIS, E_DELTA):
                args = (q, ka, va, ksm, vsm, vis, evis)
                got = A.streaming_verify_attention(*args, e_delta=E_DELTA).float()
                want = A.verify_attention_plain(*args, e_delta=E_DELTA).float()
                limit = 2.0**-12 * float(want.abs().max()) + 2.0**-7 * want.abs()
                r = float(((got - want).abs() / limit).max())
                if not (torch.isfinite(got).all() and r <= 1.0):
                    raise SystemExit(f"K2-verify disagrees with its plain version: T={T} "
                                     f"visible={vis} extra_visible={evis} err/limit={r:.3f}")
                worst = max(worst, r)
    print(f"  check: every case within K2's tolerance of the plain version (largest err/limit "
          f"{worst:.3f})")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    policy = A.verify_split_size
    for T in T_TIMED:
        q, ka, va, ksm, vsm = _inputs(T)
        for vis in VISIBLE:
            host = policy(vis, 4, n_sms)
            row = {}
            for split in sorted({*SPLITS, host}):
                if -(-vis // split) + 1 > lib().verify_max_parts:
                    continue
                A.verify_split_size = lambda *_, s=split: s  # the wrapper's split, forced
                row[split] = round(_device_ms(lambda: A.streaming_verify_attention(
                    q, ka, va, ksm, vsm, vis, EVIS, e_delta=E_DELTA), n=30), 5)
            A.verify_split_size = policy
            best = min(row, key=row.get)
            print(f"  sweep T={T} visible={vis}: host split {host} {row[host]:.4f} ms, best "
                  f"{best} {row[best]:.4f} ms; device ms by split {json.dumps(row)}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: K2-verify's profile runs only on the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from streaming_vlm_tpu_torch.ops import _kernels

    ptxas = chip_smoke._ptxas_verbose(_kernels, "verify_attention.cu")
    _kernels.build()
    print("  K2-verify " + chip_smoke._ptxas_lines(chip_smoke._ptxas_text(ptxas), "verify_tc_kernel"))
    check_and_sweep()
    shutil.rmtree(OUT, ignore_errors=True)
    dirs = {name: _copy(name, edits) for name, edits in VARIANTS.items()}
    dirs["timeline"] = _timeline_copy()
    shutil.copy2(REPO / "chip_smoke.py", OUT)
    shutil.copy2(Path(__file__), OUT / "tools_verify.py")  # this module, importable in the copies
    build = [sys.executable, "-c", "from streaming_vlm_tpu_torch.ops import _kernels; _kernels.build()"]
    procs = [subprocess.Popen(build, cwd=d) for d in dirs.values()]
    if any(p.wait() for p in procs):
        raise SystemExit("a variant did not build")
    for name in [*VARIANTS, "base"]:
        code = (f"import sys, json; sys.path[:0] = [{str(dirs[name])!r}, {str(OUT)!r}]; "
                "import tools_verify; print(json.dumps(tools_verify.time_variant()))")
        r = subprocess.run([sys.executable, "-c", code], cwd=dirs[name], capture_output=True,
                           text=True)
        if r.returncode:
            raise SystemExit(r.stdout[-3000:] + r.stderr[-3000:])
        print(f"  {name}: device ms at visible 9000 {r.stdout.strip().splitlines()[-1]}")
    r = subprocess.run([sys.executable, "-c", f"import sys; sys.path[:0] = [{str(dirs['timeline'])!r}, "
                        f"{str(OUT)!r}]; import tools_verify; tools_verify.timeline()"],
                       cwd=dirs["timeline"], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout[-3000:] + r.stderr[-3000:])
    print(r.stdout, end="")
    shutil.rmtree(OUT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
