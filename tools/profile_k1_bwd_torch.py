"""Where K1-bwd's time goes (csrc/attention_bwd.cu), on the card: copies of
the kernel with one part changed or removed, each built by nvcc into its own
library under build/k1_bwd_ablations/ and timed by CUDA events in turns (two
rounds) at training's T = 8192 (7B heads: H 28, Hkv 4), beside SDPA's own
autograd backward and aten's flash-attention backward on the same inputs
(K and V repeated to the 28 heads). The copies that only move time (no
fold, stores for adds, no counter wait, no dQ product) compute wrong dQ and
are timings only; each copy's outputs are compared with the kernel's.

    python3 tools/profile_k1_bwd_torch.py        # ~2 min, one card

Prints one JSON line per copy and one for the library calls, each with the
card's name and power limit."""

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

OUT = REPO / "build" / "k1_bwd_ablations"
POLL = ("        while (n > 0 && ld_acquire(cnt) != n) {\n        }\n"
        "        mbar_wait(&dq_full[b], (i >> 1) & 1);\n")
# name -> [(text, replacement)], each text once in the source
VARIANTS = {
    "kernel": [],
    "accurate exp2f for P": [("const float p = ex2(", "const float p = exp2f(")],
    "no counter wait (timing only)": [("        while (n > 0 && ld_acquire(cnt) != n) {\n        }\n",
                                       "")],
    "stores for adds (timing only)": [("bulk_reduce_add_f32(dst, src, DQ_FLOATS * 4);",
                                       "bulk_store(dst, src, DQ_FLOATS * 4);")],
    "no fold (timing only)": [(POLL, "        mbar_wait(&dq_full[b], (i >> 1) & 1);\n"
                               "        mbar_arrive(&dq_empty[b]);\n        continue;\n")],
    "no dQ product (timing only)": [
        ("for (int kk = 0; kk < BN / 16; ++kk) {\n        wgmma_m64n64k16_ss<1, 1>",
         "for (int kk = 0; kk < 0; ++kk) {\n        wgmma_m64n64k16_ss<1, 1>")],
}


def build(kernels, name, repl):
    """Start nvcc on a copy of the source with `repl` applied."""
    code = (kernels.CSRC / "attention_bwd.cu").read_text()
    for a, b in repl:
        if code.count(a) != 1:
            raise AssertionError(f"{name}: {a!r} is not once in attention_bwd.cu")
        code = code.replace(a, b)
    d = OUT / "".join(c if c.isalnum() else "_" for c in name)
    d.mkdir(parents=True, exist_ok=True)
    (d / "k.cu").write_text(code)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
           str(kernels.CSRC), "-o", str(d / "k.so"), str(d / "k.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from streaming_vlm_tpu_torch.ops import _kernels
    from streaming_vlm_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    procs = {name: build(_kernels, name, repl) for name, repl in VARIANTS.items()}
    libs, regs = {}, {}
    for name, (p, d) in procs.items():
        text = p.communicate(timeout=600)[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{text[-3000:]}")
        regs[name] = c._ptxas_lines(text, "attn_bwd_kernel")
        so = ctypes.CDLL(str(d / "k.so"))
        so.svt_attention_bwd.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        so.svt_attention_bwd.restype = ctypes.c_int
        libs[name] = so

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(3)
    T, H, Hkv, hd = 8192, 28, 4, 128
    G = H // Hkv

    def rn(*s):
        return torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)

    q, k, v, do = rn(T, H, hd), rn(T, Hkv, hd), rn(T, Hkv, hd), rn(T, H, hd)
    lse2 = torch.empty(T, H, device=dev)
    o = A.streaming_prefill_attention(q, k, v, None, None, k, v, 0, lse=lse2)
    rec, cnt, acc = A.attention_bwd_scratch(T, H, Hkv, hd, dev)

    def call(so):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        err = so.svt_attention_bwd(*(A.ptr(t) for t in (q, k, v, o, lse2, do, rec, cnt, acc, dq, dk,
                                                         dv)), T, H, Hkv, hd, A.stream())
        if err:
            raise RuntimeError(f"cudaError {err}")
        return dq, dk, dv

    def ms(fn, reps=7, batch=3):
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(batch):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / batch)
        return statistics.median(times)

    times = {name: [] for name in libs}
    for _ in range(2):
        for name, so in libs.items():
            times[name].append(ms(lambda: call(so)))
    ref = call(libs["kernel"])
    for name, so in libs.items():
        same = all(torch.equal(a, b) for a, b in zip(call(so), ref))
        print(json.dumps({"copy": name, "ms": times[name], "outputs_equal_the_kernel's": same,
                          "ptxas": regs[name], "card": card}), flush=True)
    rep = lambda x: x.repeat_interleave(G, dim=1).transpose(0, 1)[None].contiguous()  # noqa: E731
    qq, kk, vv = (x.requires_grad_() for x in (q.transpose(0, 1)[None].contiguous(), rep(k), rep(v)))
    dd = do.transpose(0, 1)[None].contiguous()
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
    sdpa = ms(lambda: torch.autograd.grad(out, (qq, kk, vv), dd, retain_graph=True))
    with torch.no_grad():
        fo, flse, cq, ck, mq, mk, seed, off, _ = torch.ops.aten._scaled_dot_product_flash_attention(
            qq, kk, vv, 0.0, True)
        flash = ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dd, qq, kk, vv, fo, flse, cq, ck, mq, mk, 0.0, True, seed, off))
    print(json.dumps({"sdpa_autograd_backward_ms": sdpa, "aten_flash_backward_ms": flash,
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
