#!/usr/bin/env python3
"""Slice M's peak device memory (chip_smoke.py's `phase_train`) in a fresh
process, alone or after one other phase of chip_smoke.py, on the card:

    python3 tools/peak_m_torch.py none      # slice M alone
    python3 tools/peak_m_torch.py k1eval    # after phase 3's K1 checks at the eval shapes
    python3 tools/peak_m_torch.py mcqref    # after phase 4's batched MCQ reference
    python3 tools/peak_m_torch.py trainref  # after phase 4's training reference
    python3 tools/peak_m_torch.py N         # after slice N's in-process steps (no soak)

Prints the device memory still allocated before M and M's
max_memory_allocated (reset at M's start), beside the card's name and
power limit."""

import gc
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    import torch

    import chip_smoke as cs
    from streaming_vlm_tpu_torch.config import qwen25_vl_7b
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import init_params
    from streaming_vlm_tpu_torch.ops import _kernels

    what = sys.argv[1] if len(sys.argv) > 1 else "none"
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    _kernels.build()
    _kernels.lib()
    cfg = qwen25_vl_7b()
    if what == "k1eval":
        cs._phase_k1_eval(torch.Generator(device="cuda").manual_seed(1))
    elif what == "mcqref":
        cs.phase_mcq_reference(cfg)
    elif what == "trainref":
        cs.phase_train_reference(cfg)
    elif what == "N":
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                            dtype=torch.bfloat16)

        class Done:  # a soak that has ended with nothing to count: N stops at its check
            def wait(self, timeout=None):
                return 0

        cs.SOAK_OUT.parent.mkdir(parents=True, exist_ok=True)
        cs.SOAK_OUT.write_text('{"n_chunks": 0, "kv_constant": true, "kv_occupancy": []}\n'
                               "COUNTS {}\n")
        try:
            cs.phase_eval(cfg, model, Done())
        except AssertionError as e:  # the soak's check, after every in-process step
            print(f"slice N's steps ran; its soak check: {str(e)[:60]}")
        del model
    elif what != "none":
        raise SystemExit(f"unknown phase {what!r}")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 2**30
    with cs._raw_clips():
        _, stats = cs.phase_train(cfg)
    print(f"peak_m {what}: allocated before M {before:.3f} GiB, M's max_memory_allocated "
          f"{stats['max_memory_allocated'] / 2**30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
