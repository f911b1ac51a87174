"""chip_smoke.py's slice O alone on the card: the port's parallel modes
(parallel/) in a 2-rank gloo world on cuda:0 (O1-O5) and a one-rank NCCL
world (O6), at Qwen2.5-VL-7B widths cut to 4 decoder layers and 4 vision
blocks; with --full-block, the phase-3 checks and times of K1's and
K1-bwd's full-block modes first. It runs chip_smoke.py's own functions
with the same limits: the gradient checks take each leaf's bf16 noise from
phase 4's training reference (`phase_train_reference`), run here first as
there.

    python3 tools/parallel_torch.py [--full-block]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as C  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-block", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py's main
    torch.backends.cudnn.allow_tf32 = False
    from streaming_vlm_tpu_torch.config import qwen25_vl_7b
    from streaming_vlm_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.build()
    _kernels.lib()
    print(f"build {time.perf_counter() - t0:.1f} s")
    if args.full_block:
        g = torch.Generator(device="cuda").manual_seed(1)
        print(json.dumps(C._phase_full_block(g)))
        if C._FAILED:
            print("FAILED: " + "; ".join(C._FAILED))
            return 1
    cfg = qwen25_vl_7b()
    t0 = time.perf_counter()
    noise = C.phase_train_reference(cfg).pop("noise")
    torch.cuda.empty_cache()  # the ranks share the card with this process, as in chip_smoke.py
    print(f"training reference {time.perf_counter() - t0:.1f} s")
    if C._FAILED:
        print("FAILED: " + "; ".join(C._FAILED))
        return 1
    t0 = time.perf_counter()
    launches, stats = C.phase_parallel(cfg, noise)
    print(json.dumps({"launches": dict(launches), "slice_o": stats}, default=str))
    print(f"slice O {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
