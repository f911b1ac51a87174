"""The port's command line (cli.py, `python -m streaming_vlm_tpu_torch`)
against the JAX package's: each command's parser has the JAX parser's
options, defaults and choices plus `--device`; the same argv makes the same
library calls with the same arguments on both sides (weights, dtypes and
callables aside); a real CPU `serve` over a tiny HF directory written by
transformers' save_pretrained, with a tokenizer built offline by
`tokenizers`, writes its WebVTT; `convert` round-trips through
`load_model`; `--mesh`, `--parallel_mode pp|sp` and a JAX-written
(`params.msgpack`) serving checkpoint are refused, naming their ROADMAP
items."""

import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_cpu import one_cpu_thread, warm_cpu_math  # noqa: F401  (autouse fixtures)

from streaming_vlm_tpu import cli as jcli
from streaming_vlm_tpu.config import qwen25_vl_tiny as jax_tiny
from streaming_vlm_tpu_torch import cli

REPO = Path(__file__).resolve().parent.parent


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _parser(fn, monkeypatch):
    def stop(self, *a, **kw):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as e:
        fn([])
    monkeypatch.undo()
    return e.value.parser


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.type, a.required,
                     a.const)
            for a in parser._actions if a.dest != "help"}


def test_the_ten_commands_and_main_lists_them():
    assert list(cli.COMMANDS) == list(jcli.COMMANDS) and len(cli.COMMANDS) == 10
    r = subprocess.run([sys.executable, "-m", "streaming_vlm_tpu_torch"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and all(c in r.stdout for c in jcli.COMMANDS)


@pytest.mark.parametrize("name", list(jcli.COMMANDS))
def test_parser_equals_the_jax_parser_plus_device(name, monkeypatch):
    mine = _options(_parser(cli.COMMANDS[name], monkeypatch))
    theirs = _options(_parser(jcli.COMMANDS[name], monkeypatch))
    assert mine.pop("device") == (("--device",), "cuda", ("cuda", "cpu"), None, None, False,
                                  None)
    assert mine == theirs


# ---------------------------------------------------------------------------
# the same argv -> the same library calls


def _norm(x):
    """A call's arguments with the sides' own types made comparable."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, _norm(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {("WEIGHTS" if k in ("params", "model") else k): _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    if isinstance(x, torch.dtype) or "jax" in type(x).__module__ or "numpy" in type(x).__module__:
        return "DTYPE" if "float" in str(x) else x
    if callable(x) and not isinstance(x, type):
        return "<callable>"
    return x


class _Obj:
    """What a patched class returns: records nothing more, does nothing."""

    def __getattr__(self, k):
        return lambda *a, **kw: []

    def __eq__(self, other):  # the sides' stand-ins are alike
        return isinstance(other, _Obj)

    __hash__ = None


def _record(monkeypatch, side, calls):
    """Patch each library entry point the CLI calls with a recorder."""
    import importlib
    import inspect

    pkg = "streaming_vlm_tpu" if side == "jax" else "streaming_vlm_tpu_torch"
    mod = jcli if side == "jax" else cli

    def rec(name, orig, ret=None):
        sig = inspect.signature(orig)

        def f(*a, **kw):
            args = dict(sig.bind(*a, **kw).arguments)
            args.pop("device", None)  # the port's one argument more
            if args.get("mesh", 0) is None:  # the JAX Trainer's default, passed explicitly
                args.pop("mesh")
            calls.append((name, _norm(args)))
            return _Obj() if ret == "obj" else ret
        return f

    def load_model(model_path, dtype_name="bfloat16", quantize="none", device=None):
        calls.append(("load_model", model_path, dtype_name, quantize))
        return jax_tiny(), "WEIGHTS", "TOKENIZER", "DTYPE"

    monkeypatch.setattr(mod, "load_model", load_model)
    targets = {
        "serve": [("streaming_inference", None)],
        "eval.efficiency": [("run_efficiency", None)],
        "eval.soak": [("run_soak", "obj")],
        "eval.ovobench": [("evaluate_ovobench", []), ("evaluate_results", {})],
        "data.dataset": [("StreamDataset", "obj")],
        "train.trainer": [("Trainer", "obj"), ("TrainConfig", None)],
        "eval.infstream": [(n, None) for n in ("generate_segments", "merge_results",
                                               "score_segments")] + [("merge_scores", {})],
        "eval.livesports": [(n, None) for n in ("generate_commentary",
                                                "generate_livecc_commentary",
                                                "generate_plain_captions")]
        + [(n, {}) for n in ("judge_events", "judge_competitors")] + [("merge_event_outputs", 0)],
        "eval.judge": [("openai_judge_fn", None)],
        "eval.vqa": [("VQAChat", "obj"), ("run_mcq_tsv", {})],
        "demo.app": [("LiveCaptionServer", "obj"), ("stream_segments", [])],
        "demo.multiapp": [("MultiLiveCaptionServer", "obj")],
        "streaming.protocol": [("hf_encode_fn", None)],
        "models.convert": [("load_hf_checkpoint", (None, "WEIGHTS")),
                           ("save_serving_checkpoint", None)],
    }
    for m, names in targets.items():
        module = importlib.import_module(f"{pkg}.{m}")
        for n, ret in names:
            monkeypatch.setattr(module, n, rec(n, getattr(module, n), ret))
    if side == "jax":  # the JAX convert picks its platform; nothing to do here
        import jax

        monkeypatch.setattr(jax.config, "update", lambda *a, **kw: None)


ARGVS = [
    ("serve", "--model_path m --video_path v.mp4 --output_dir o.vtt --pos_mode append --all_text "
              "--window_size 4 --chunk_duration 0.5 --text_round 3 --text_sink 8 "
              "--text_sliding_window 9 --temperature 0.5 --repetition_penalty 1.2 "
              "--previous_text pre --query q --duration 7 --skip_first_chunk 2 --kv_capacity 4096 "
              "--recompute --emit_json --quiet --trace_dir tr --quantize none"),
    ("serve", "--model_path m --video_path v.mp4"),
    ("efficiency", "--model_path m --video_path v --baseline_mode b --duration 5 "
                   "--temperature 0.1 --pos_mode append --all_text --previous_text p "
                   "--output_dir od"),
    ("soak", "--model_path m --n_chunks 7 --kv_capacity 2048 --quantize none"),
    ("ovobench", "--model_path m --benchmark_path b.jsonl --video_root r --out_path o "
                 "--worker 1 --num_workers 3"),
    ("train", "--model_path m --train_annotation_paths a.jsonl b.jsonl --output_dir od "
              "--learning_rate 2e-5 --max_steps 3 --grad_accum 2 --save_steps 1 --text_sink 4 "
              "--text_sliding_window 5 --remat dots"),
    ("infstream", "generate --model_path m --eval_metadata e --out_path o --start_line 1 "
                  "--end_line 4 --start_time 10 --duration 20 --temperature 0.3"),
    ("infstream", "merge --out_path o --shards a b"),
    ("infstream", "score --out_path o --merged_a a --merged_b b --eval_metadata e "
                  "--judge_model jm"),
    ("infstream", "aggregate --out_path o --shards a"),
    ("livesports", "streaming --model_path m --events_path e --out_dir d --worker 1 "
                   "--num_workers 2"),
    ("livesports", "livecc --model_path m --events_path e --out_dir d"),
    ("livesports", "caption --model_path m --events_path e --out_dir d"),
    ("livesports", "judge --events_path e --out_dir d --out_path o --judge_model jm"),
    ("livesports", "judge --events_path e --out_dir d --pred_dir_b b --out_path o"),
    ("livesports", "merge --out_dir d --out_path o"),
    ("vqa", "--model_path m --tsv t --out_path o --worker 1 --num_workers 2 --max_new_tokens 3"),
    ("demo", "--model_path m --video_path a.mp4 b.mp4 --port 9 --host h --query q "
             "--previous_text p --realtime --quantize none"),
    ("demo", "--model_path m --video_path a.mp4"),
    ("convert", "--model_path m --out o --quant none --dtype float32 --cpu"),
]


@pytest.mark.parametrize("cmd,argv", ARGVS, ids=[f"{c}-{i}" for i, (c, _) in enumerate(ARGVS)])
def test_the_same_argv_makes_the_same_library_calls(cmd, argv, monkeypatch):
    calls = {}
    for side in ("jax", "port"):
        calls[side] = []
        with monkeypatch.context() as m:
            _record(m, side, calls[side])
            cli_mod = jcli if side == "jax" else cli
            cli_mod.COMMANDS[cmd](argv.split())
    # the single-video demo's generation runs on a thread, not recorded here
    for side in calls:
        calls[side] = [c for c in calls[side] if c[0] != "stream_segments"]
    assert calls["port"] == calls["jax"] and calls["jax"]


@pytest.mark.parametrize("argv", ["--mesh data=2", "--parallel_mode pp", "--parallel_mode sp"])
def test_train_refuses_a_mesh_and_pp_sp(argv, monkeypatch):
    """The refusals that stay true, before the model loads: a mesh of more
    ranks than the world (one process, no torchrun) and pp / sp without a
    mesh. The working modes run under torchrun
    (test_train_under_torchrun_with_a_mesh)."""
    monkeypatch.setattr(cli, "load_model", lambda *a, **kw: pytest.fail("loaded a model"))
    match = "needs 2 ranks, the world has 1" if "mesh" in argv else "needs --mesh"
    with pytest.raises(ValueError, match=match):
        cli.cmd_train(f"--model_path m --train_annotation_paths a {argv}".split())


def test_a_jax_serving_checkpoint_is_refused(tmp_path):
    (tmp_path / "serving_config.json").write_text('{"format": 1, "quant": "int8"}')
    (tmp_path / "params.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="queue 1 item 7"):
        cli.load_model(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# a real run over a tiny HF directory

SPECIALS = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645,
            "<|vision_start|>": 151652, "<|vision_end|>": 151653, "<|image_pad|>": 151655,
            "<|video_pad|>": 151656}
WORDS = {"\n": 198, "user": 872, "assistant": 77091, "previous": 19702, " text": 1467,
         "Time": 1462}


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny Qwen2.5-VL saved by transformers (the JAX tiny config's widths,
    the real vocabulary's size, so the Qwen special ids exist) and a
    word-level tokenizer that maps the special tokens and the protocol's
    words to Qwen's ids, every other character to one id of its own."""
    from tokenizers import Regex, Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast, Qwen2_5_VLConfig
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import (
        Qwen2_5_VLForConditionalGeneration,
    )

    d = tmp_path_factory.mktemp("hf")
    c = jax_tiny()
    v, t = c.vision, c.text
    hf_cfg = Qwen2_5_VLConfig(
        vocab_size=151680, hidden_size=t.hidden_size, intermediate_size=t.intermediate_size,
        num_hidden_layers=t.num_hidden_layers, num_attention_heads=t.num_attention_heads,
        num_key_value_heads=t.num_key_value_heads, rms_norm_eps=t.rms_norm_eps,
        rope_theta=t.rope_theta, tie_word_embeddings=False,
        rope_scaling=dict(type="mrope", mrope_section=list(t.mrope_section)),
        vision_config=dict(
            depth=v.depth, hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
            num_heads=v.num_heads, in_channels=v.in_channels, patch_size=v.patch_size,
            temporal_patch_size=v.temporal_patch_size, spatial_merge_size=v.spatial_merge_size,
            window_size=v.window_size, fullatt_block_indexes=list(v.fullatt_block_indexes),
            out_hidden_size=v.out_hidden_size, tokens_per_second=v.tokens_per_second,
            hidden_act="silu"),
    )
    torch.manual_seed(0)
    Qwen2_5_VLForConditionalGeneration(hf_cfg).eval().save_pretrained(str(d))
    vocab = {"<unk>": 0, **SPECIALS, **WORDS}
    vocab.update({chr(i): 1000 + i for i in range(32, 127) if chr(i) not in vocab})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Split(
        Regex(r"previous| text|user|assistant|Time|\n|."), behavior="isolated")
    tok.add_special_tokens(list(SPECIALS))
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                            eos_token="<|im_end|>").save_pretrained(str(d))
    return d


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from streaming_vlm_tpu_torch.video import ingest

    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    ingest.write_test_video(path, w=84, h=56, n_frames=30, fps=10)
    return path


def test_serve_on_the_cpu_writes_its_vtt(hf_dir, clip, tmp_path, capsys):
    """`serve --device cpu` (W8A8 by default) over the HF directory: the
    tokenizer's special ids are Qwen's, two chunks stream, the VTT holds
    both cues and the NDJSON lines are on stdout."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(str(hf_dir))
    assert tok("<|im_start|>previous text\nTime", add_special_tokens=False)["input_ids"] == [
        151644, 19702, 1467, 198, 1462]
    vtt = tmp_path / "out.vtt"
    cli.cmd_serve(f"--model_path {hf_dir} --video_path {clip} --output_dir {vtt} --device cpu "
                  "--window_size 2 --text_round 2 --text_sink 8 --text_sliding_window 8 "
                  "--kv_capacity 2048 --duration 2 --emit_json --quiet".split())
    text = vtt.read_text()
    assert text.startswith("WEBVTT") and text.count(" --> ") == 2
    assert "00:00:01.000 --> 00:00:02.000" in text
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith('{"type"')]
    assert len(lines) == 2


@pytest.mark.parametrize("quant", ["int8", "none"])
def test_convert_round_trips_through_load_model(hf_dir, tmp_path, quant):
    from streaming_vlm_tpu_torch.models.convert import load_hf_checkpoint
    from streaming_vlm_tpu_torch.ops.quant import is_model_quantized, quantize_model

    out = tmp_path / "serving"
    cli.cmd_convert(f"--model_path {hf_dir} --out {out} --quant {quant} --dtype float32 "
                    "--cpu".split())
    assert (out / "serving_config.json").exists() and (out / "tokenizer.json").exists()
    cfg, model, tok, dtype = cli.load_model(str(out), "float32", device="cpu")
    hf_cfg, want = load_hf_checkpoint(str(hf_dir), device="cpu", dtype=torch.float32)
    if quant == "int8":
        quantize_model(want)
    assert cfg == hf_cfg and dtype == torch.float32
    assert is_model_quantized(model) == (quant == "int8")
    sd, ref = model.state_dict(), want.state_dict()
    assert sd.keys() == ref.keys()
    for k in ref:
        assert sd[k].dtype == ref[k].dtype and torch.equal(sd[k], ref[k]), k
    assert tok("<|im_end|>", add_special_tokens=False)["input_ids"] == [151645]
    # --quantize int8 on a float checkpoint quantizes at load
    if quant == "none":
        assert is_model_quantized(cli.load_model(str(out), "float32", "int8", device="cpu")[1])
    assert np.isfinite(float(next(iter(sd.values())).float().sum()))


def test_train_under_torchrun_with_a_mesh(hf_dir, tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 2 -m
    streaming_vlm_tpu_torch train --device cpu --mesh seq=2 --parallel_mode
    sp` over the tiny HF directory: two gloo ranks train one step of ring
    attention; rank 0 writes the metrics and the trainer state, each rank
    its own parameter file."""
    import json

    from streaming_vlm_tpu_torch.video import ingest

    vid = str(tmp_path / "clip.mp4")
    ingest.write_test_video(vid, w=56, h=56, n_frames=20, fps=10)
    conv = [{"role": "user", "content": [{"type": "video", "video": vid, "video_start": 0.0,
                                          "video_end": 2.0, "previous": "earlier words"}]},
            {"role": "assistant", "content": [{"type": "text", "text_stream": [
                [0.0, 0.9, "hello"], [1.0, 1.9, "world"]]}]}]
    ann = tmp_path / "train.jsonl"
    ann.write_text(json.dumps(conv) + "\n")
    out = tmp_path / "run"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--standalone", "-m", "streaming_vlm_tpu_torch", "train", "--device", "cpu",
           "--mesh", "seq=2", "--parallel_mode", "sp", "--model_path", str(hf_dir),
           "--train_annotation_paths", str(ann), "--output_dir", str(out), "--max_steps", "1",
           "--grad_accum", "1", "--save_steps", "1", "--text_sink", "4",
           "--text_sliding_window", "4", "--remat", "none"]
    r = subprocess.run(cmd, env=env, cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and np.isfinite(rows[0]["loss"]) and rows[0]["labeled_tokens"] > 0
    ck = out / "checkpoint-1"
    assert sorted(p.name for p in ck.iterdir()) == [
        "opt_state-rank0.pt", "opt_state-rank1.pt", "params-rank0.pt", "params-rank1.pt",
        "trainer_state.json"]
