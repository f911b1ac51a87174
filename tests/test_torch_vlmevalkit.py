"""Drive a real VLMEvalKit checkout with the port's VQAChat: the kit builds
the dataset (ImageMCQDataset over a local TSV) and every prompt through the
port's `eval.vlmeval_compat`; the port's model answers. Skipped exactly
where tests/test_vlmevalkit.py skips: when no kit checkout is available."""

import base64
import csv
import io
import os

import numpy as np
import pytest

from test_vlmevalkit import KIT_PATH  # the JAX package's kit test: the same checkout, the same skip

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(KIT_PATH, "vlmeval")),
    reason=f"no VLMEvalKit checkout at {KIT_PATH}",
)


def _png_b64(color):
    from PIL import Image

    img = Image.new("RGB", (56, 56), color)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _rows():
    return [{"index": str(i), "question": "What color is the square?", "A": "red",
             "B": "green", "C": "blue", "D": "yellow", "answer": a, "image": _png_b64(c)}
            for i, (a, c) in enumerate((("A", (255, 0, 0)), ("C", (0, 0, 255))))]


def test_kit_mcq_end_to_end_on_the_port(tmp_path):
    import torch

    from streaming_vlm_tpu_torch.config import qwen25_vl_tiny
    from streaming_vlm_tpu_torch.eval.vlmeval_compat import load_vlmeval, run_kit_mcq
    from streaming_vlm_tpu_torch.eval.vqa import VQAChat, build_mcq_message
    from streaming_vlm_tpu_torch.models.qwen25_vl.model import init_params
    from streaming_vlm_tpu_torch.streaming.protocol import FakeTokenizer

    cfg = qwen25_vl_tiny()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    chat = VQAChat(cfg, model, FakeTokenizer(cfg.tokens), lambda ids: " ".join(map(str, ids)),
                   max_new_tokens=1, min_pixels=28 * 28, max_pixels=16 * 28 * 28)
    lmu = tmp_path / "LMUData"
    lmu.mkdir()
    os.environ["LMUData"] = str(lmu)
    rows = _rows()
    with open(lmu / "TinySquaresPort.tsv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t")
        w.writeheader()
        w.writerows(rows)
    kit = load_vlmeval(KIT_PATH)
    assert "VLMEvalKit" in kit.__file__
    out = tmp_path / "preds.jsonl"
    res = run_kit_mcq(chat, "TinySquaresPort", kit_path=KIT_PATH, out_path=str(out))
    assert res["total"] == 2 and len(out.read_text().strip().splitlines()) == 2

    # the kit's prompt text equals the port's own runner's
    from vlmeval.dataset.image_mcq import ImageMCQDataset

    ds = ImageMCQDataset(dataset="TinySquaresPort")
    kit_text = "".join(m["value"] for m in ds.build_prompt(ds.data.iloc[0]) if m["type"] == "text")
    (tmp_path / "imgs").mkdir()
    ours = build_mcq_message(rows[0], str(tmp_path / "imgs"))
    assert kit_text == "".join(m["value"] for m in ours if m["type"] == "text")
    assert np.isfinite(res["accuracy"])
