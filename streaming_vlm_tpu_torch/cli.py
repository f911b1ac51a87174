"""Command-line entry points of the port.

Port of streaming_vlm_tpu/cli.py, the same ten commands with the same
options, defaults and choices:
  serve       - streaming inference over a video (WebVTT, NDJSON)
  convert     - HF checkpoint -> the port's serving checkpoint
  efficiency  - the paper's policies (a)-(d) (eval/efficiency.py)
  soak        - constant-memory / latency-flatness check (eval/soak.py)
  ovobench    - OVO-Bench MCQ eval (eval/ovobench.py)
  train       - SFT (train/trainer.py)
  demo        - live caption demo over HTTP (demo/app.py, demo/multiapp.py)
  infstream   - Inf-Stream-Eval generate / merge / score / aggregate
  livesports  - LiveSports-3K-CC generators, judge and merge
  vqa         - VLMEvalKit-format MCQ TSV through eval/vqa.VQAChat

One option more than the JAX CLI: `--device` (default cuda; cpu on
request), where the model is built and run, the counterpart of JAX's
platform choice (`convert --cpu` is kept, meaning `--device cpu`). On the
card the kernels run (K1, K2 or K3, and K5 under `--quantize int8`);
nothing falls back to the CPU. `serve --trace_dir` writes a torch.profiler
Chrome trace.

Usage: python -m streaming_vlm_tpu_torch <command> [args]
Model loading: --model_path points at a HF Qwen2.5-VL / Qwen2-VL directory
(config.json + safetensors + tokenizer files) or at a serving checkpoint
written by `convert`; the tokenizer is read with transformers'
AutoTokenizer.
"""

from __future__ import annotations

import argparse
import json
import sys

DEVICES = ("cuda", "cpu")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where the model is built and run (default: the card)")


def load_model(model_path: str, dtype_name: str = "bfloat16", quantize: str = "none",
               device: str = "cuda"):
    """Load an HF directory or a serving checkpoint of the port (+ its
    tokenizer) onto `device`. quantize='int8' makes the model W8A8
    (`ops.quant.quantize_model`) unless the checkpoint is already
    quantized. Returns (cfg, model, tokenizer, dtype)."""
    import os

    import torch

    from .models.convert import SERVING_CONFIG, load_hf_checkpoint, load_serving_checkpoint

    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    if os.path.exists(os.path.join(model_path, SERVING_CONFIG)):
        # a pre-converted serving checkpoint (`convert`): no safetensors
        # parse and no quantization pass at startup; a float one takes the
        # requested dtype
        cfg, model, _ = load_serving_checkpoint(model_path, device=device, dtype=dtype)
    else:
        cfg, model = load_hf_checkpoint(model_path, device=device, dtype=dtype)
    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_path)
    except Exception as e:
        raise RuntimeError(f"cannot load tokenizer from {model_path}: {e}")
    if quantize == "int8":
        from .ops.quant import is_model_quantized, quantize_model

        if not is_model_quantized(model):
            quantize_model(model)
    return cfg, model, tokenizer, dtype


def cmd_convert(argv):
    """HF checkpoint -> serving checkpoint (the port's state dict, pre-
    quantized by default): `serve --model_path` then starts without the
    safetensors parse and the quantization pass. Tokenizer files are
    copied alongside so the output directory is self-contained."""
    import glob as _glob
    import os
    import shutil

    p = argparse.ArgumentParser(prog="convert")
    p.add_argument("--model_path", required=True, help="HF checkpoint dir")
    p.add_argument("--out", required=True, help="serving checkpoint dir")
    p.add_argument("--quant", default="int8", choices=["int8", "none"])
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--cpu", action="store_true",
                   help="convert on the host CPU (no card needed; --device cpu)")
    _add_device(p)
    args = p.parse_args(argv)

    import torch

    from .models.convert import load_hf_checkpoint, save_serving_checkpoint

    device = "cpu" if args.cpu else args.device
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    cfg, model = load_hf_checkpoint(args.model_path, device=device, dtype=dtype)
    save_serving_checkpoint(args.out, cfg, model, quant=args.quant)
    for pat in ("tokenizer*", "vocab.*", "merges.txt", "special_tokens_map.json",
                "preprocessor_config.json", "chat_template.*"):
        for f in _glob.glob(os.path.join(args.model_path, pat)):
            shutil.copy(f, args.out)
    print(f"serving checkpoint written to {args.out} (quant={args.quant})")


def cmd_serve(argv):
    p = argparse.ArgumentParser(prog="serve")
    p.add_argument("--model_path", required=True)
    p.add_argument("--video_path", required=True)
    p.add_argument("--output_dir", default=None, help="WebVTT output path")
    p.add_argument("--pos_mode", default="shrink", choices=["shrink", "append"])
    p.add_argument("--all_text", action="store_true")
    p.add_argument("--window_size", type=int, default=16)
    p.add_argument("--chunk_duration", type=float, default=1.0)
    p.add_argument("--text_round", type=int, default=16)
    p.add_argument("--text_sink", type=int, default=512)
    p.add_argument("--text_sliding_window", type=int, default=512)
    p.add_argument("--temperature", type=float, default=0.9)
    p.add_argument("--repetition_penalty", type=float, default=1.05)
    p.add_argument("--previous_text", default="")
    p.add_argument("--query", default="Commentate on this match")
    p.add_argument("--duration", type=float, default=None)
    p.add_argument("--skip_first_chunk", type=int, default=0)
    p.add_argument("--kv_capacity", type=int, default=16384)
    p.add_argument("--recompute", action="store_true")
    p.add_argument("--emit_json", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--trace_dir", default=None,
                   help="capture the run as a torch.profiler Chrome trace under this dir")
    p.add_argument("--quantize", default="int8", choices=["int8", "none"],
                   help="int8 W8A8 weights (kernel K5 on the card; the serving default) - "
                        "'none' keeps the checkpoint dtype")
    _add_device(p)
    args = p.parse_args(argv)

    from .config import SamplingConfig, StreamConfig
    from .serve import streaming_inference

    cfg, model, tokenizer, dtype = load_model(
        args.model_path, quantize=args.quantize, device=args.device
    )
    stream = StreamConfig(
        chunk_duration=args.chunk_duration,
        window_size=args.window_size,
        text_round=args.text_round,
        text_sink=args.text_sink,
        text_sliding_window=args.text_sliding_window,
        pos_mode=args.pos_mode,
        all_text=args.all_text,
        kv_capacity=args.kv_capacity,
    )
    streaming_inference(
        cfg=cfg,
        model=model,
        tokenizer=tokenizer,
        video_path=args.video_path,
        output_dir=args.output_dir,
        stream=stream,
        sampling=SamplingConfig(
            temperature=args.temperature, repetition_penalty=args.repetition_penalty
        ),
        previous_text=args.previous_text,
        query=args.query,
        duration=args.duration,
        skip_first_chunk=args.skip_first_chunk,
        quiet=args.quiet,
        emit_json=args.emit_json,
        recompute=args.recompute,
        trace_dir=args.trace_dir,
        dtype=dtype,
    )


def cmd_efficiency(argv):
    p = argparse.ArgumentParser(prog="efficiency")
    p.add_argument("--model_path", required=True)
    p.add_argument("--video_path", required=True)
    p.add_argument("--baseline_mode", default="d", choices=["a", "b", "c", "d"])
    p.add_argument("--duration", type=float, default=1000.0)
    p.add_argument("--temperature", type=float, default=0.9)
    p.add_argument("--pos_mode", default="shrink", choices=["shrink", "append"])
    p.add_argument("--all_text", action="store_true")
    p.add_argument("--previous_text", default="")
    p.add_argument("--output_dir", default="output/efficiency")
    _add_device(p)
    args = p.parse_args(argv)

    from .eval.efficiency import run_efficiency

    cfg, model, tokenizer, dtype = load_model(args.model_path, device=args.device)
    run_efficiency(
        cfg=cfg,
        model=model,
        tokenizer=tokenizer,
        video_path=args.video_path,
        baseline_mode=args.baseline_mode,
        duration=args.duration,
        previous_text=args.previous_text,
        temperature=args.temperature,
        pos_mode=args.pos_mode,
        all_text=args.all_text,
        output_dir=args.output_dir,
        model_name=args.model_path,
        dtype=dtype,
    )


def cmd_soak(argv):
    p = argparse.ArgumentParser(prog="soak")
    p.add_argument("--model_path", default=None, help="HF dir; default: random 3B")
    p.add_argument("--n_chunks", type=int, default=120)
    p.add_argument("--kv_capacity", type=int, default=10240)
    p.add_argument("--quantize", default="int8", choices=["int8", "none"])
    _add_device(p)
    args = p.parse_args(argv)

    import torch

    from .config import StreamConfig, qwen25_vl_3b
    from .eval.soak import run_soak

    if args.model_path:
        cfg, model, tokenizer, dtype = load_model(
            args.model_path, quantize=args.quantize, device=args.device
        )
    else:
        from .models.qwen25_vl import model as m

        cfg, dtype = qwen25_vl_3b(), torch.bfloat16
        gen = torch.Generator(device=args.device).manual_seed(0)
        if args.quantize == "int8":  # built W8A8 directly: no float decoder
            model = m.random_quantized_model(cfg, gen, device=args.device, dtype=dtype)
        else:
            model = m.init_params(cfg, gen, device=args.device, dtype=dtype)
    stream = StreamConfig(kv_capacity=args.kv_capacity, prefill_buckets=(640, 1024))
    report = run_soak(
        cfg=cfg,
        model=model,
        stream=stream,
        n_chunks=args.n_chunks,
        grid=(1, 32, 64),
        dtype=dtype,
    )
    print(report.to_json())
    assert report.kv_constant, "KV occupancy is not constant in steady state!"


def cmd_ovobench(argv):
    p = argparse.ArgumentParser(prog="ovobench")
    p.add_argument("--model_path", required=True)
    p.add_argument("--benchmark_path", required=True, help="formatted MCQ jsonl")
    p.add_argument("--video_root", default="")
    p.add_argument("--out_path", default="output/ovobench_preds.jsonl")
    p.add_argument("--worker", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=1)
    _add_device(p)
    args = p.parse_args(argv)

    from .eval.ovobench import evaluate_ovobench, evaluate_results
    from .streaming.protocol import hf_encode_fn

    cfg, model, tokenizer, dtype = load_model(args.model_path, device=args.device)
    results = evaluate_ovobench(
        cfg=cfg,
        model=model,
        encode=hf_encode_fn(tokenizer),
        benchmark_path=args.benchmark_path,
        video_root=args.video_root,
        out_path=args.out_path,
        worker=args.worker,
        num_workers=args.num_workers,
    )
    print(json.dumps(evaluate_results(results), indent=2))


def cmd_train(argv):
    p = argparse.ArgumentParser(prog="train")
    p.add_argument("--model_path", required=True)
    p.add_argument("--train_annotation_paths", nargs="+", required=True)
    p.add_argument("--output_dir", default="runs/sft")
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--grad_accum", type=int, default=64)
    p.add_argument("--save_steps", type=int, default=20)
    p.add_argument("--text_sink", type=int, default=512)
    p.add_argument("--text_sliding_window", type=int, default=512)
    p.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    p.add_argument(
        "--mesh", default=None,
        help="device mesh as axis=N[,axis=N...] (e.g. 'data=2,model=4' for FSDP+TP, "
             "'stage=4' for pipeline, 'seq=4' for ring-attention sequence parallelism); "
             "run one process a rank: python -m torch.distributed.run --nproc_per_node N "
             "-m streaming_vlm_tpu_torch train ...",
    )
    p.add_argument(
        "--parallel_mode", default="gspmd", choices=["gspmd", "pp", "sp"],
        help="how the loss distributes over --mesh (TrainConfig.parallel_mode); pp and sp "
             "need --mesh",
    )
    _add_device(p)
    args = p.parse_args(argv)
    mesh, device = _train_mesh(args)  # before the model loads

    from .data.dataset import StreamDataset
    from .streaming.protocol import hf_encode_fn
    from .train.trainer import TrainConfig, Trainer

    cfg, model, tokenizer, dtype = load_model(args.model_path, device=device)
    ds = StreamDataset(
        args.train_annotation_paths,
        cfg=cfg,
        encode=hf_encode_fn(tokenizer),
        text_sink=args.text_sink,
        text_sliding_window=args.text_sliding_window,
    )
    trainer = Trainer(
        cfg,
        model,
        TrainConfig(
            output_dir=args.output_dir,
            learning_rate=args.learning_rate,
            max_steps=args.max_steps,
            grad_accum=args.grad_accum,
            save_steps=args.save_steps,
            remat=args.remat,
            parallel_mode=args.parallel_mode,
        ),
        mesh=mesh,
    )
    trainer.train(ds)


def _train_mesh(args):
    """train's mesh and device: none and --device without --mesh; with
    --mesh, the process group from torchrun's environment (WORLD_SIZE > 1:
    gloo on the CPU, NCCL on the cards, each rank on cuda:LOCAL_RANK) and
    the named mesh over it. ValueError for pp / sp without --mesh, or a
    mesh of more ranks than the world has."""
    if not args.mesh:
        if args.parallel_mode != "gspmd":
            raise ValueError(f"train: --parallel_mode {args.parallel_mode} needs --mesh")
        return None, args.device
    import os

    import torch.distributed as dist

    from .parallel.distributed import initialize
    from .parallel.mesh import make_mesh

    shape = {k: int(v) for k, v in (kv.split("=", 1) for kv in args.mesh.split(","))}
    device = args.device
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = str(initialize(device="cpu" if args.device == "cpu" else None))
    return make_mesh(shape), device


def cmd_infstream(argv):
    """Inf-Stream-Eval: generate / merge / score / aggregate."""
    p = argparse.ArgumentParser(prog="infstream")
    p.add_argument("mode", choices=["generate", "merge", "score", "aggregate"])
    p.add_argument("--model_path")
    p.add_argument("--eval_metadata")
    p.add_argument("--out_path", required=True)
    p.add_argument("--start_line", type=int, default=0)
    p.add_argument("--end_line", type=int, default=None)
    p.add_argument("--start_time", type=int, default=1000)
    p.add_argument("--duration", type=int, default=100)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--shards", nargs="*", default=[], help="merge/aggregate inputs")
    p.add_argument("--merged_a")
    p.add_argument("--merged_b")
    p.add_argument("--judge_model", default="gpt-4o-mini")
    _add_device(p)
    args = p.parse_args(argv)

    from .eval import infstream

    if args.mode == "generate":
        cfg, model, tokenizer, dtype = load_model(args.model_path, device=args.device)
        infstream.generate_segments(
            cfg=cfg, model=model, tokenizer=tokenizer,
            eval_metadata=args.eval_metadata, out_path=args.out_path,
            start_time=args.start_time, duration=args.duration,
            temperature=args.temperature, start_line=args.start_line,
            end_line=args.end_line, dtype=dtype,
        )
    elif args.mode == "merge":
        infstream.merge_results(args.shards, args.out_path)
    elif args.mode == "score":
        from .eval.judge import openai_judge_fn

        infstream.score_segments(
            merged_a=args.merged_a, merged_b=args.merged_b,
            eval_metadata=args.eval_metadata,
            judge=openai_judge_fn(args.judge_model), out_path=args.out_path,
        )
    else:
        print(json.dumps(infstream.merge_scores(args.shards)))


def cmd_livesports(argv):
    """LiveSports-3K-CC: streaming / livecc / caption generators + judge."""
    p = argparse.ArgumentParser(prog="livesports")
    p.add_argument("mode", choices=["streaming", "livecc", "caption", "judge", "merge"])
    p.add_argument("--model_path")
    p.add_argument("--events_path")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--worker", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--pred_dir_b", help="judge: competitor dir (default event_cc)")
    p.add_argument("--out_path", help="judge votes / merge jsonl path")
    p.add_argument("--judge_model", default="gpt-4o-mini")
    _add_device(p)
    args = p.parse_args(argv)

    from .eval import livesports

    if args.mode == "merge":
        n = livesports.merge_event_outputs(args.out_dir, args.out_path)
        print(f"merged {n} events -> {args.out_path}")
        return
    if args.mode == "judge":
        from .eval.judge import openai_judge_fn

        judge = openai_judge_fn(args.judge_model)
        if args.pred_dir_b:
            summary = livesports.judge_competitors(
                events_path=args.events_path, pred_dir_a=args.out_dir,
                pred_dir_b=args.pred_dir_b, judge=judge, out_path=args.out_path,
            )
        else:
            summary = livesports.judge_events(
                events_path=args.events_path, pred_dir=args.out_dir,
                judge=judge, out_path=args.out_path,
            )
        print(json.dumps(summary))
        return

    cfg, model, tokenizer, dtype = load_model(args.model_path, device=args.device)
    kw = dict(
        cfg=cfg, model=model, tokenizer=tokenizer,
        events_path=args.events_path, out_dir=args.out_dir,
        worker=args.worker, num_workers=args.num_workers, dtype=dtype,
    )
    if args.mode == "streaming":
        livesports.generate_commentary(**kw)
    elif args.mode == "livecc":
        livesports.generate_livecc_commentary(**kw)
    else:
        kw.pop("dtype")
        livesports.generate_plain_captions(**kw)


def cmd_vqa(argv):
    """VLMEvalKit-protocol MCQ eval over a TSV through VQAChat."""
    p = argparse.ArgumentParser(prog="vqa")
    p.add_argument("--model_path", required=True)
    p.add_argument("--tsv", required=True)
    p.add_argument("--out_path", required=True)
    p.add_argument("--worker", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--max_new_tokens", type=int, default=1)
    _add_device(p)
    args = p.parse_args(argv)

    from .eval.vqa import VQAChat, run_mcq_tsv
    from .streaming.protocol import hf_encode_fn

    cfg, model, tokenizer, dtype = load_model(args.model_path, device=args.device)
    chat = VQAChat(
        cfg, model, hf_encode_fn(tokenizer),
        lambda ids: tokenizer.decode(ids, skip_special_tokens=True),
        max_new_tokens=args.max_new_tokens,
    )
    res = run_mcq_tsv(
        chat, args.tsv, args.out_path,
        worker=args.worker, num_workers=args.num_workers,
    )
    print(json.dumps(res))


def cmd_demo(argv):
    """Live caption demo: browser player + SSE commentary stream. With
    several --video_path entries: one batched lane per video, all streams
    served at once on one card (demo/multiapp.py)."""
    p = argparse.ArgumentParser(prog="demo")
    p.add_argument("--model_path", required=True)
    p.add_argument("--video_path", required=True, nargs="+",
                   help="one video = single-stream demo; several = one "
                        "batched lane per video on one card")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--query", default="Commentate on this match")
    p.add_argument("--previous_text", default="")
    p.add_argument("--realtime", action="store_true",
                   help="pace each stream to its video clock (live-camera "
                        "simulation) instead of flat-out")
    p.add_argument("--render_out", default=None,
                   help="also burn caption bubbles into an mp4 at this path "
                        "(single-video demo only)")
    p.add_argument("--quantize", default="int8", choices=["int8", "none"])
    _add_device(p)
    args = p.parse_args(argv)

    from .demo.app import LiveCaptionServer, stream_segments

    cfg, model, tokenizer, dtype = load_model(
        args.model_path, quantize=args.quantize, device=args.device
    )

    if len(args.video_path) > 1:
        from .demo.multiapp import MultiLiveCaptionServer

        assert args.render_out is None, "--render_out is single-video only"
        MultiLiveCaptionServer(
            cfg, model, tokenizer, args.video_path,
            queries=[args.query] * len(args.video_path),
            previous_text=args.previous_text, realtime=args.realtime,
            host=args.host, port=args.port, dtype=dtype,
        ).serve_forever()
        return
    args.video_path = args.video_path[0]

    # ONE generation fanned out through a replay feed: every SSE connection
    # (a second viewer, an EventSource auto-reconnect) subscribes to the same
    # stream instead of starting a duplicate generation on the card
    import threading

    from .demo.app import SegmentFeed

    feed = SegmentFeed()

    def produce():
        collected = []
        try:
            for seg in stream_segments(
                cfg=cfg, model=model, tokenizer=tokenizer,
                video_path=args.video_path, query=args.query,
                previous_text=args.previous_text, dtype=dtype,
            ):
                collected.append(seg)
                feed.push(seg)
        finally:
            feed.finish()
        if args.render_out:
            from .demo.render import render_caption_video

            render_caption_video(args.video_path, collected, args.render_out)
            print(f"rendered captions -> {args.render_out}")

    threading.Thread(target=produce, daemon=True).start()
    LiveCaptionServer(
        args.video_path, feed.subscribe, host=args.host, port=args.port
    ).serve_forever()


COMMANDS = {
    "serve": cmd_serve,
    "convert": cmd_convert,
    "efficiency": cmd_efficiency,
    "soak": cmd_soak,
    "ovobench": cmd_ovobench,
    "train": cmd_train,
    "demo": cmd_demo,
    "infstream": cmd_infstream,
    "livesports": cmd_livesports,
    "vqa": cmd_vqa,
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in COMMANDS:
        print(f"usage: python -m streaming_vlm_tpu_torch {{{'|'.join(COMMANDS)}}} [args]")
        sys.exit(1)
    COMMANDS[sys.argv[1]](sys.argv[2:])


if __name__ == "__main__":
    main()
