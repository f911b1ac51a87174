"""Where K1's time goes (csrc/prefill_attention.cu), on the card: copies of
the port under build/k1_ablations/, each with K1's source changed in one
part (and the other kernels' objects taken from this checkout's build, so
that each copy compiles K1 alone), timed in turns (two rounds, each copy in
its own process) by CUDA events at ring attention's full-block T = 4096
over 4096 keys (with the log-sum-exp) and at serving's T = 640 over 9600
visible slots (7B heads: H 28, Hkv 4), beside SDPA on the same work (K and
V repeated to the 28 heads; non-causal, and over the arena's keys plus the
causal block as a boolean mask). The copies marked "timing only" compute
wrong outputs; each copy's outputs are hashed beside the kernel's.

    python3 tools/profile_k1_torch.py        # ~4 min, one card

Prints one JSON line per copy and one for the library calls, each with the
card's name and power limit."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

OUT = REPO / "build" / "k1_ablations"
LOADS = """          mbar_wait(&kempty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&kfull[stage], KV_BYTES);
          tma_load_4d(k_dst, km, &kfull[stage], 0, kvh, key0, b);
          tma_load_4d(k_dst + BOX_BYTES, km, &kfull[stage], 64, kvh, key0, b);
          mbar_wait(&vempty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&vfull[stage], KV_BYTES);
          tma_load_4d(v_dst, vm, &vfull[stage], 0, kvh, key0, b);
          tma_load_4d(v_dst + BOX_BYTES, vm, &vfull[stage], 64, kvh, key0, b);
"""
# after the ring's first STAGES tiles, the producer signals each stage full
# once it is free, without loading it: the consumers compute on the tiles
# already there
LOADS_ONCE = ("          if (loaded < STAGES) {\n            ++loaded;\n" + LOADS
              + "          } else {\n            mbar_wait(&kempty[stage], phase ^ 1);\n"
              "            mbar_arrive(&kfull[stage]);\n"
              "            mbar_wait(&vempty[stage], phase ^ 1);\n"
              "            mbar_arrive(&vfull[stage]);\n          }\n")
# name -> [(text, replacement)], each text once in the source
VARIANTS = {
    "kernel": [],
    # the ping-pong's turns removed: both warpgroups issue when ready
    "no ping-pong turns": [("using namespace hopper;\n", "using namespace hopper;\n"
                            "#define named_barrier_sync(id, n) \\\n"
                            "  ((id) >= BAR_TURN ? (void)0 : hopper::named_barrier_sync(id, n))\n"
                            "#define named_barrier_arrive(id, n) \\\n"
                            "  ((id) >= BAR_TURN ? (void)0 : hopper::named_barrier_arrive(id, n))\n")],
    # P and alpha by exp2f, which keeps results under 2^-126 subnormal
    "accurate exp2f for P and alpha": [("__device__ __forceinline__ float ex2(float x) {\n",
                                        "__device__ __forceinline__ float ex2(float x) {\n"
                                        "  return exp2f(x);\n")],
    "no exponentials (timing only)": [(f"s[{i}] = ex2(s[{i}] - base_{r});",
                                       f"s[{i}] = s[{i}] - base_{r};")
                                      for i, r in (("i", "a"), ("i + 1", "a"), ("i + 2", "b"),
                                                   ("i + 3", "b"))],
    "no S product (timing only)": [("wgmma_m64n128k16_ss(s, da, db, k > 0);", "")],
    "no P.V product (timing only)": [("wgmma_m64n128k16_rs_tb(o, p[k], db, 1);", "")],
    "K/V loaded once (timing only)": [
        (LOADS, LOADS_ONCE),
        ("      int stage = 0;\n      uint32_t phase = 0;\n      for (int si = seg_begin;",
         "      int stage = 0, loaded = 0;\n      uint32_t phase = 0;\n      for (int si = seg_begin;")],
}


# run in each copy's root: its K1 timed at the two shapes, its outputs hashed
CODE = r"""
import hashlib, json, statistics, sys
sys.path.insert(0, ".")
import torch
from streaming_vlm_tpu_torch.ops import attention as A
dev = "cuda"
g = torch.Generator(device=dev).manual_seed(5)
rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
H, Hkv, hd, C = 28, 4, 128, 10240
qf, kf, vf = rn(4096, H, hd), rn(4096, Hkv, hd), rn(4096, Hkv, hd)
lse = torch.empty(4096, H, device=dev)
q, ks, vs, ka, va = rn(640, H, hd), rn(640, Hkv, hd), rn(640, Hkv, hd), rn(C, Hkv, hd), rn(C, Hkv, hd)
shapes = {"full-block T=4096": lambda: (A.full_block_attention(qf, kf, vf, lse=lse), lse),
          "T=640 over 9600": lambda: (A.streaming_prefill_attention(q, ka, va, None, None, ks, vs, 9600),)}
def ms(fn, reps=7, batch=5):
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
out = {}
for name, fn in shapes.items():
    h = hashlib.sha256()
    for t in fn():
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    out[name] = dict(ms=ms(fn), hash=h.hexdigest()[:16])
if "--sdpa" in sys.argv:
    import torch.nn.functional as F
    rep = lambda x: x.repeat_interleave(H // Hkv, dim=1).transpose(0, 1)[None].contiguous()
    with torch.no_grad():
        qq, kk, vv = qf.transpose(0, 1)[None].contiguous(), rep(kf), rep(vf)
        out["sdpa full-block T=4096"] = ms(lambda: F.scaled_dot_product_attention(qq, kk, vv))
        mask = torch.cat([torch.ones(640, 9600, dtype=torch.bool, device=dev),
                          torch.ones(640, 640, dtype=torch.bool, device=dev).tril()], 1)
        qq, kk, vv = (q.transpose(0, 1)[None].contiguous(), rep(torch.cat([ka[:9600], ks])),
                      rep(torch.cat([va[:9600], vs])))
        out["sdpa T=640 over 9600"] = ms(lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask))
print("RESULT " + json.dumps(out))
"""


def copy(kernels, name, repl) -> Path:
    """A copy of the port with `repl` applied to K1's source, seeded with
    this checkout's compiled objects."""
    code = (kernels.CSRC / "prefill_attention.cu").read_text()
    for a, b in repl:
        if code.count(a) != 1:
            raise AssertionError(f"{name}: {a!r} is not once in prefill_attention.cu")
        code = code.replace(a, b)
    d = OUT / "".join(c if c.isalnum() else "_" for c in name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(REPO / "streaming_vlm_tpu_torch", d / "streaming_vlm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (d / "streaming_vlm_tpu_torch" / "csrc" / "prefill_attention.cu").write_text(code)
    shutil.copytree(kernels.OBJ_DIR, d / "build" / "torch_kernels" / "obj")
    return d


def main() -> int:
    import torch

    from streaming_vlm_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _kernels.build()
    roots = {name: copy(_kernels, name, repl) for name, repl in VARIANTS.items()}
    build = "from streaming_vlm_tpu_torch.ops import _kernels; _kernels.build()"
    procs = {name: subprocess.Popen([sys.executable, "-c", build], cwd=root, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for name, root in roots.items()}
    for name, p in procs.items():
        text = p.communicate(timeout=600)[0]
        if p.returncode:
            raise RuntimeError(f"{name}: build failed\n{text[-3000:]}")
    runs = {name: [] for name in roots}
    for rnd in range(2):
        for name, root in roots.items():
            r = subprocess.run([sys.executable, "-c", CODE] + (["--sdpa"] if rnd == 0 and name ==
                                                                 "kernel" else []),
                               cwd=root, capture_output=True, text=True, timeout=600)
            line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
            if not line:
                raise RuntimeError(f"{name}: failed\n{r.stdout[-2000:]}{r.stderr[-3000:]}")
            runs[name].append(json.loads(line[0][7:]))
    ref = runs["kernel"][0]
    for name, rs in runs.items():
        shapes = [k for k in rs[0] if not k.startswith("sdpa")]
        print(json.dumps({"copy": name, "ms": {s: [r[s]["ms"] for r in rs] for s in shapes},
                          "outputs_equal_the_kernel's": {s: rs[0][s]["hash"] == ref[s]["hash"]
                                                         for s in shapes},
                          "card": card}), flush=True)
    print(json.dumps({"sdpa_ms": {k: v for k, v in ref.items() if k.startswith("sdpa")},
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
