"""Where K1-bwd's time goes (csrc/attention_bwd.cu), on the card: copies of
the kernel with one part changed or removed, each built by nvcc into its own
library under build/k1_bwd_ablations/ and timed by CUDA events in turns (two
rounds) at training's T = 8192 (7B heads: H 28, Hkv 4), or with --full in
the full-block mode at ring attention's block, T = 4096 queries over 4096
keys, beside SDPA's own autograd backward and aten's flash-attention
backward on the same inputs (K and V repeated to the 28 heads; causal, or
not with --full). The copies that only move time (no fold, stores for adds,
no counter wait, no dQ product, Q and dO loaded for the first two tiles
only, no dS barrier between the consumer warpgroups) compute wrong results
and are timings only; with --full one more copy is a design built and
dropped, the cluster's dQ partials summed in distributed shared memory
(correct, other dQ bits), and one hands each stage back to the peer's
producer with a cluster-scope release. Each copy's outputs are compared
with the kernel's.

    python3 tools/profile_k1_bwd_torch.py [--full]   # ~2 min, one card

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
LOAD = ("        mbar_wait(&empty[stage], phase ^ 1);\n"
        "        mbar_arrive_expect_tx(&full[stage], 4 * rows * 128 + REC * 4);\n")
# name -> [(text, replacement)], each text once in the source (the two
# modes share the loop and the fold)
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
    "Q/dO loaded for the first two tiles only (timing only)": [
        (LOAD, "        mbar_wait(&empty[stage], phase ^ 1);\n"
               "        if (i >= STAGES) {\n          mbar_arrive(&full[stage]);\n"
               "          if (++stage == STAGES) {\n            stage = 0;\n            phase ^= 1;\n"
               "          }\n          continue;\n        }\n"
               "        mbar_arrive_expect_tx(&full[stage], 4 * rows * 128 + REC * 4);\n")],
    "no dS barrier (timing only)": [
        ("      named_barrier_arrive(1 + 2 * wg + b, CONSUMERS * 128);\n", ""),
        ("      named_barrier_sync(1 + 2 * (1 - wg) + b, CONSUMERS * 128);\n", "")],
}


# --full only: a design built and dropped, a cluster's two dQ
# partials summed in distributed shared memory before the fold (correct, its
# dQ bits differ: each half of a tile's rows takes p(2c) + p(2c + 1), folded
# in cluster order): each CTA announces its partial on both CTAs' dq_full
# (cluster-scope release), the fold warp of rank r reads the peer's rows
# [32 r, 32 r + 32) in place (ld.shared::cluster), adds them to its own and
# folds those 16 KB once cluster c - 1 has (its count in bits [16 r, 16 r +
# 16) of the tile's counter); a buffer is free once both folds read it
PAIR_SUM_HELPERS = r"""using namespace hopper;
constexpr int HALF = 64 * 128 / 2;
__device__ __forceinline__ void arrive_release_cluster(uint32_t remote) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}
__device__ __forceinline__ void wait_acquire_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile("{\n.reg .pred done;\nWAIT_%=:\n"
               "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
               "@!done bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ float4 ld_cluster_f32x4(uint32_t remote) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote) : "memory");
  return v;
}
"""
PAIR_SUM_FOLD = r"""    } else if (FULL && (warp == 1 || warp == 2)) {
      const int b = warp - 1, c = n / 2;
      float4* sa = reinterpret_cast<float4*>(sDQ + b * DQ_FLOATS + rank * HALF);
      const uint32_t sb = mapa(sa, peer), peer_empty = mapa(&dq_empty[b], peer);
      for (int i = b; i < n_tiles; i += 2) {
        wait_acquire_cluster(&dq_full[b], (i >> 1) & 1);
#pragma unroll 2
        for (int j = lane; j < HALF / 4; j += 32) {
          const float4 p = ld_cluster_f32x4(sb + 16 * j);
          float4 a = sa[j];
          a.x += p.x;
          a.y += p.y;
          a.z += p.z;
          a.w += p.w;
          sa[j] = a;
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          arrive_release_cluster(peer_empty);
          const int m = M - 1 - i;
          int* cnt = counters + kvh * M + m;
          float* dst = dq_acc + (size_t)(kvh * M + m) * DQ_FLOATS + rank * HALF;
          while (((ld_acquire(cnt) >> (16 * rank)) & 0xFFFF) < c) {
          }
          if (c == 0) {
            bulk_store(dst, sa, HALF * 4);
          } else {
            fence_proxy_async_global();
            bulk_reduce_add_f32(dst, sa, HALF * 4);
          }
          bulk_commit();
          bulk_wait_all();
          mbar_arrive(&dq_empty[b]);
          fence_proxy_async_global();
          red_release_add(cnt, 1 << (16 * rank));
        }
        __syncwarp();
      }
    } else if (!FULL && (warp == 1 || warp == 2) && lane == 0) {
"""
# --full only: the consumers hand a stage back to the peer's producer with a
# cluster-scope release (.release.cluster) instead of the default
CLUSTER_RELEASE = [
    ("using namespace hopper;\n", "using namespace hopper;\n"
     "__device__ __forceinline__ void arrive_release_cluster(uint32_t remote) {\n"
     "  asm volatile(\"mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\\n\" "
     "::\"r\"(remote) : \"memory\");\n}\n"),
    ("if constexpr (FULL) mbar_arrive_cluster(mapa(&empty[stage], peer));",
     "if constexpr (FULL) arrive_release_cluster(mapa(&empty[stage], peer));"),
]
PAIR_SUM = [
    ("using namespace hopper;\n", PAIR_SUM_HELPERS),
    ("      mbar_init(&dq_full[b], CONSUMERS * 4);\n      mbar_init(&dq_empty[b], 1);",
     "      mbar_init(&dq_full[b], PAIR * CONSUMERS * 4);\n      mbar_init(&dq_empty[b], PAIR);"),
    ("    } else if ((warp == 1 || warp == 2) && lane == 0) {\n", PAIR_SUM_FOLD),
    ("      mbar_wait(&dq_empty[b], ((i >> 1) & 1) ^ 1);\n",
     "      if constexpr (FULL) {\n        wait_acquire_cluster(&dq_empty[b], ((i >> 1) & 1) ^ 1);\n"
     "      } else {\n        mbar_wait(&dq_empty[b], ((i >> 1) & 1) ^ 1);\n      }\n"),
    ("      if (lane == 0) mbar_arrive(&dq_full[b]);\n",
     "      if (lane == 0) {\n        mbar_arrive(&dq_full[b]);\n"
     "        if constexpr (FULL) arrive_release_cluster(mapa(&dq_full[b], peer));\n      }\n"),
]


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
    import argparse

    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from streaming_vlm_tpu_torch.ops import _kernels
    from streaming_vlm_tpu_torch.ops import attention as A

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the full-block mode at T = 4096 over 4096 keys (default: causal, T = 8192)")
    full = ap.parse_args().full
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    variants = dict(VARIANTS)
    if full:
        variants["dQ partials pair-summed in distributed shared memory (dropped)"] = PAIR_SUM
        variants["stages handed back with a cluster-scope release"] = CLUSTER_RELEASE
    procs = {name: build(_kernels, name, repl) for name, repl in variants.items()}
    libs, regs = {}, {}
    for name, (p, d) in procs.items():
        text = p.communicate(timeout=600)[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{text[-3000:]}")
        regs[name] = c._ptxas_lines(text, "attn_bwd_full_kernel" if full else "attn_bwd_kernel")
        so = ctypes.CDLL(str(d / "k.so"))
        so.svt_attention_bwd.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        so.svt_attention_bwd.restype = ctypes.c_int
        libs[name] = so

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(3)
    T, H, Hkv, hd = 4096 if full else 8192, 28, 4, 128
    G = H // Hkv

    def rn(*s):
        return torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)

    q, k, v, do = rn(T, H, hd), rn(T, Hkv, hd), rn(T, Hkv, hd), rn(T, H, hd)
    lse2 = torch.empty(T, H, device=dev)
    o = (A.full_block_attention(q, k, v, lse=lse2) if full else
         A.streaming_prefill_attention(q, k, v, None, None, k, v, 0, lse=lse2))
    rec, cnt, acc = A.attention_bwd_scratch(T, H, Hkv, hd, dev)

    def call(so):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        err = so.svt_attention_bwd(*(A.ptr(t) for t in (q, k, v, o, lse2, do, rec, cnt, acc, dq, dk,
                                                         dv)), T, H, Hkv, hd, int(full), A.stream())
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
        out = call(so)
        same = all(torch.equal(a, b) for a, b in zip(out, ref))
        # the largest difference from the kernel's dq, dk, dv, over each one's largest value
        diff = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
                for a, b in zip(out, ref)]
        print(json.dumps({"copy": name, "ms": times[name], "outputs_equal_the_kernel's": same,
                          "rel_diff (dq, dk, dv)": diff, "ptxas": regs[name], "card": card}),
              flush=True)
    rep = lambda x: x.repeat_interleave(G, dim=1).transpose(0, 1)[None].contiguous()  # noqa: E731
    qq, kk, vv = (x.requires_grad_() for x in (q.transpose(0, 1)[None].contiguous(), rep(k), rep(v)))
    dd = do.transpose(0, 1)[None].contiguous()
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=not full)
    sdpa = ms(lambda: torch.autograd.grad(out, (qq, kk, vv), dd, retain_graph=True))
    with torch.no_grad():
        fo, flse, cq, ck, mq, mk, seed, off, _ = torch.ops.aten._scaled_dot_product_flash_attention(
            qq, kk, vv, 0.0, not full)
        flash = ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dd, qq, kk, vv, fo, flse, cq, ck, mq, mk, 0.0, not full, seed, off))
    print(json.dumps({"T": T, "mode": "full-block" if full else "causal",
                      "sdpa_autograd_backward_ms": sdpa, "aten_flash_backward_ms": flash,
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
