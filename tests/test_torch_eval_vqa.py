"""The port's VQA adapter (eval/vqa.py) against the JAX package's, on
qwen25_vl_tiny in f32 on the CPU, one set of numpy weights through the
bridge: `VQAChat.generate` emits the JAX greedy ids on image and video
messages (fps and nframe sampling) with first-token logits within 1e-4 of
the largest |logit|; its KV-cached decode (a prefill over a fresh raw
arena, then T = 1 steps over it: K1 raw mode's plain version here) equals
a full re-forward per token; `run_mcq_tsv` and `run_videomme_tsv` write
the JAX rows; `extract_option` and the prompt builders are bitwise the
JAX package's."""

import base64
import csv
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import numpy_params, one_cpu_thread, warm_cpu_math  # noqa: F401  (autouse fixtures)

from streaming_vlm_tpu.config import qwen25_vl_tiny
from streaming_vlm_tpu.eval import vqa as jvqa
from streaming_vlm_tpu.streaming.protocol import FakeTokenizer
from streaming_vlm_tpu.video import ingest as jingest
from streaming_vlm_tpu_torch.eval import vqa
from streaming_vlm_tpu_torch.models.bridge import from_jax_params
from streaming_vlm_tpu_torch.models.qwen25_vl import model as tm
from streaming_vlm_tpu_torch.video.ingest import patchify_frames

CFG = qwen25_vl_tiny()
FTOK = FakeTokenizer(CFG.tokens)
PIX = dict(min_pixels=28 * 28, max_pixels=16 * 28 * 28)


def decode(ids):
    return " ".join(str(i) for i in ids)


def letter(ids):
    """A deterministic answer letter from the first generated id."""
    return "ABCD"[ids[0] % 4] + ". something" if ids else ""


@pytest.fixture(scope="module")
def both():
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(CFG, seed=5))
    return params, from_jax_params(CFG, jax.tree_util.tree_map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("vqa")
    arr = np.random.default_rng(0).integers(0, 255, size=(56, 84, 3)).astype(np.uint8)
    Image.fromarray(arr).save(d / "img.png")
    jingest.build_native()
    jingest.write_test_video(str(d / "clip.mp4"), w=64, h=48, n_frames=25, fps=10)
    return d


def _chats(both, fn=decode, **kw):
    params, model = both
    return (jvqa.VQAChat(CFG, params, FTOK, fn, **PIX, **kw),
            vqa.VQAChat(CFG, model, FTOK, fn, **PIX, **kw))


def _first_logits(monkeypatch):
    """Record each side's first-token logits (the prefill's)."""
    got = {"jax": [], "port": []}
    jax_prefill, port_prefill = jvqa._cached_prefill_jit, vqa._prefill

    def jax_wrap(*a):
        run = jax_prefill(*a)

        def rec(*b):
            r = run(*b)
            got["jax"].append(np.asarray(r[2]))
            return r

        return rec

    def port_wrap(*a):
        r = port_prefill(*a)
        got["port"].append(r.numpy())
        return r

    monkeypatch.setattr(jvqa, "_cached_prefill_jit", jax_wrap)
    monkeypatch.setattr(vqa, "_prefill", port_wrap)
    return got


@pytest.mark.parametrize("kind", ["image", "video fps", "video nframe"])
def test_generate_equals_the_jax_package(both, media, monkeypatch, kind):
    kw = {"video fps": dict(fps=2.0), "video nframe": dict(nframe=6)}.get(kind, {})
    jchat, tchat = _chats(both, max_new_tokens=6, **kw)
    item = ({"type": "image", "value": str(media / "img.png")} if kind == "image"
            else {"type": "video", "value": str(media / "clip.mp4")})
    msgs = [item, {"type": "text", "value": "Which option is correct?\nA. x\nB. y\nAnswer:"}]
    got = _first_logits(monkeypatch)
    want = jchat.generate(msgs)
    assert tchat.generate(msgs) == want and len(want.split()) >= 1
    (j,), (t,) = got["jax"], got["port"]
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * np.abs(j).max())


def test_cached_decode_equals_a_full_reforward(both, media):
    """The KV-cached greedy path emits the tokens of forward_full re-run
    over the whole sequence for each token."""
    _, model = both
    _, chat = _chats(both, max_new_tokens=8)
    msgs = [{"type": "image", "value": str(media / "img.png")},
            {"type": "text", "value": "Describe the image in a few words."}]
    cached = chat.generate(msgs)
    frames = chat._load_image(str(media / "img.png"))
    v = CFG.vision
    patches, grid = patchify_frames(frames, patch_size=v.patch_size,
                                    temporal_patch_size=v.temporal_patch_size,
                                    merge_size=v.spatial_merge_size)
    n = patches.shape[0] // v.spatial_merge_unit
    ids = np.asarray(FTOK(
        f"<|im_start|>system\n{chat.system_prompt}<|im_end|>\n<|im_start|>user\n"
        f"<|vision_start|>{'<|image_pad|>' * n}<|vision_end|>Describe the image in a few "
        "words.<|im_end|>\n<|im_start|>assistant\n"), np.int32)
    out = []
    for _ in range(8):
        logits = tm.forward_full(CFG, model, ids, pixel_patches=torch.from_numpy(patches),
                                 image_grid_thw=np.array([list(grid)]))[-1]
        nxt = int(torch.argmax(logits))
        if nxt == CFG.tokens.im_end:
            break
        out.append(nxt)
        ids = np.concatenate([ids, [nxt]]).astype(np.int32)
    assert len(out) == 8 and cached == decode(out)


def _png_b64(seed):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 255, size=(56, 84, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_run_mcq_tsv_writes_the_jax_rows(both, tmp_path):
    tsv = tmp_path / "mcq.tsv"
    with open(tsv, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["index", "image", "question", "hint", "A", "B", "C", "D", "answer"])
        w.writerow([0, _png_b64(0), "What is shown?", "", "cat", "dog", "car", "sky", "A"])
        w.writerow([1, _png_b64(1), "Pick one.", "a hint", "x", "y", "z", "", "B"])
        w.writerow([2, _png_b64(2), "And now?", "nan", "p", "q", "", "", "B"])
    jchat, tchat = _chats(both, fn=letter)
    res = {}
    for side, (run, chat) in {"jax": (jvqa.run_mcq_tsv, jchat),
                              "port": (vqa.run_mcq_tsv, tchat)}.items():
        res[side] = run(chat, str(tsv), str(tmp_path / f"{side}.jsonl"))
    assert res["port"] == res["jax"] and res["jax"]["total"] == 3
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()


def test_run_videomme_tsv_writes_the_jax_rows(both, media, tmp_path):
    vdir = tmp_path / "video"
    vdir.mkdir()
    jingest.write_test_video(str(vdir / "clip0.mp4"), w=64, h=48, n_frames=30, fps=10)
    rows = [{"index": "0", "video": "clip0", "question": "What moves across the frame?",
             "candidates": "['A. a square', 'B. a circle', 'C. text', 'D. nothing']",
             "answer": "A"},
            {"index": "1", "video": "clip0", "question": "What color dominates?",
             "candidates": "['A. red', 'B. green', 'C. blue', 'D. black']", "answer": "C",
             "video_path": str(media / "clip.mp4")}]
    tsv = tmp_path / "VideoMME_tiny.tsv"
    with open(tsv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[1]), delimiter="\t")
        w.writeheader()
        w.writerows(rows)
    jchat, tchat = _chats(both, fn=letter, fps=1.0)
    for side, (run, chat) in {"jax": (jvqa.run_videomme_tsv, jchat),
                              "port": (vqa.run_videomme_tsv, tchat)}.items():
        assert run(chat, str(tsv), str(tmp_path / f"{side}.jsonl"), worker=0,
                   num_workers=1)["total"] == 2
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()


def test_prompt_builders_and_extract_option_bitwise(tmp_path):
    assert (vqa.MCQ_INSTRUCTION, vqa.VIDEOMME_SYS, vqa.VIDEOMME_FRAMES_TMPL_NOSUB) == (
        jvqa.MCQ_INSTRUCTION, jvqa.VIDEOMME_SYS, jvqa.VIDEOMME_FRAMES_TMPL_NOSUB)
    row = {"index": "3", "image": "", "image_path": "/x.png", "question": "Q?", "hint": "h",
           "A": "a", "B": "b", "C": "nan", "D": "", "answer": "A"}
    assert vqa.build_mcq_message(row, str(tmp_path)) == jvqa.build_mcq_message(row, str(tmp_path))
    vrow = {"video": "v1", "question": "Q?", "candidates": "['A. 1', 'B. 2']"}
    assert vqa.build_videomme_message(vrow, "/data") == jvqa.build_videomme_message(vrow, "/data")
    for pred in ("B. dog", "b", "unrelated", "", "  C ", "D.", "a.", "E", "AB", "x. A", "c"):
        for opts in (["A", "B"], ["A", "B", "C", "D"], ["C"]):
            assert vqa.extract_option(pred, opts) == jvqa.extract_option(pred, opts), (pred, opts)
    assert [vqa._pow2_bucket(n) for n in (1, 128, 129, 700)] == \
        [jvqa._pow2_bucket(n) for n in (1, 128, 129, 700)] == [128, 128, 256, 1024]
