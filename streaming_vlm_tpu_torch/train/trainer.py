"""SFT trainer on the port: streaming-aligned training loop with gradient
accumulation, checkpoint / auto-resume and jsonl metrics.

Port of streaming_vlm_tpu/train/trainer.py (reference recipe: per-device
batch 1, grad-accum 64, bf16, lr 1e-5, frozen ViT, save_steps 20,
save_total_limit 10, auto-resume from the newest checkpoint holding a
trainer_state.json). One process and one card: the JAX Trainer's mesh and
its "pp" / "sp" parallel modes are not ported yet (ROADMAP.md, queue 1,
item 5) and raise ValueError.

Checkpoints are in the port's own format: `checkpoint-<micro-step>/`
holding params.pt (the model's state_dict), opt_state.pt (the optimizer's
state) and trainer_state.json ({"step": micro-steps}), written only at
optimizer boundaries and pruned to save_total_limit. A checkpoint written
by the JAX Trainer (flax msgpack) is not read.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..data.dataset import StreamExample
from ..models.qwen25_vl import model as vlm
from ..utils.buckets import bucket_for
from .step import MultiSteps, apply_updates, global_norm, make_optimizer, sft_loss, trained_params


@dataclasses.dataclass
class TrainConfig:
    output_dir: str = "runs/sft"
    learning_rate: float = 1e-5
    warmup_steps: int = 10
    max_steps: int = 1000
    grad_accum: int = 64
    grad_clip: float = 1.0
    weight_decay: float = 0.0
    save_steps: int = 20
    save_total_limit: int = 10
    log_every: int = 1
    seed: int = 42
    seq_buckets: tuple = (512, 1024, 2048, 4096, 8192)
    vis_buckets: tuple = (256, 512, 1024, 2048, 4096)
    # activation checkpointing of each decoder layer: "full" matches the
    # reference's gradient_checkpointing recipe; "none" is faster when
    # memory allows, "dots" in between
    remat: str = "full"
    # examples decoded ahead on a background thread while the card steps
    # (order-preserving, so a run equals prefetch=0's). 0 = synchronous.
    prefetch: int = 2
    # the JAX Trainer's mesh modes; only "gspmd" (one card here) is ported
    parallel_mode: str = "gspmd"


def find_resume_checkpoint(output_dir: str) -> Optional[str]:
    """Latest checkpoint-* dir containing trainer_state.json (reference
    train.py:24-63)."""
    if not os.path.isdir(output_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m and os.path.exists(os.path.join(output_dir, name, "trainer_state.json")):
            step = int(m.group(1))
            if step > best_step:
                best, best_step = os.path.join(output_dir, name), step
    return best


_bucket = bucket_for  # one bucket-search (utils/buckets.py), two configs


class Trainer:
    def __init__(self, cfg: ModelConfig, model, train_cfg: TrainConfig, *, mesh=None):
        if mesh is not None or train_cfg.parallel_mode != "gspmd":
            raise ValueError(
                f"Trainer: parallel_mode={train_cfg.parallel_mode!r} and mesh= are not ported "
                "(one card; the mesh modes are ROADMAP.md queue 1 item 5, parallelism)")
        self.cfg = cfg
        self.tc = train_cfg
        self.model = model
        self.optimizer = MultiSteps(
            make_optimizer(
                learning_rate=train_cfg.learning_rate,
                weight_decay=train_cfg.weight_decay,
                grad_clip=train_cfg.grad_clip,
                warmup_steps=train_cfg.warmup_steps,
                total_steps=train_cfg.max_steps,
            ),
            train_cfg.grad_accum,
        )
        self.params = trained_params(model)  # model.text's, frozen tower
        self.opt_state = self.optimizer.init(self.params)
        # self.step counts MICRO-batches; max_steps / save_steps / the LR
        # schedule are framed in OPTIMIZER steps (one per grad_accum
        # micro-batches), as the reference's HF Trainer counts them
        self.step = 0
        os.makedirs(train_cfg.output_dir, exist_ok=True)
        self._metrics_f = open(os.path.join(train_cfg.output_dir, "metrics.jsonl"), "a")
        # optional W&B mirror of the metrics stream (reference report_to=wandb);
        # gated on install + WANDB_PROJECT
        self._wandb = None
        if os.environ.get("WANDB_PROJECT"):
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=os.environ["WANDB_PROJECT"], resume="allow")
            except Exception:
                self._wandb = None

    @property
    def _device(self) -> torch.device:
        return self.model.text.embed.weight.device

    # ------------------------------------------------------------------ step
    def _train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loss, count = sft_loss(self.cfg, self.model, batch, remat=self.tc.remat)
        grads = torch.autograd.grad(loss, self.params)
        updates, self.opt_state = self.optimizer.update(grads, self.opt_state, self.params)
        apply_updates(self.params, updates)
        return {"loss": loss.detach(), "labeled_tokens": count, "grad_norm": global_norm(grads)}

    @torch.no_grad()
    def _prepare_batch(self, ex: StreamExample) -> Dict[str, torch.Tensor]:
        """Pad to buckets; run the frozen ViT per turn; merge vision embeds."""
        dev = self._device
        T = len(ex.input_ids)
        t_pad = _bucket(T, self.tc.seq_buckets)
        ids = np.full(t_pad, self.cfg.tokens.pad, np.int64)
        ids[:T] = ex.input_ids
        labels = np.full(t_pad, -100, np.int64)
        labels[:T] = ex.labels
        pos = np.zeros((3, t_pad), np.float32)
        pos[:, :T] = ex.positions
        dtype = self.model.text.embed.weight.dtype
        vis_parts = [vlm.encode_video_frames(self.cfg, self.model, frames, grid, dtype=dtype)
                     for frames, grid in zip(ex.frames, ex.grids)]
        batch = {
            "input_ids": torch.from_numpy(ids)[None].to(dev),
            "labels": torch.from_numpy(labels)[None].to(dev),
            "positions": torch.from_numpy(pos)[None].to(dev),
        }
        if vis_parts:
            vis = torch.cat(vis_parts)
            nv = vis.shape[0]
            nv_pad = _bucket(nv, self.tc.vis_buckets)
            vis = torch.cat([vis, vis.new_zeros(nv_pad - nv, vis.shape[1])])
            slots = np.full(nv_pad, t_pad, np.int64)  # out of range -> dropped
            slots[:nv] = ex.vision_slots
            batch["vis_embeds"] = vis[None]
            batch["vis_slots"] = torch.from_numpy(slots)[None].to(dev)
        return batch

    # ------------------------------------------------------------------ loop
    def train(self, dataset, *, resume: bool = True, max_steps: Optional[int] = None):
        if resume:
            ckpt = find_resume_checkpoint(self.tc.output_dir)
            if ckpt:
                self.load_checkpoint(ckpt)
        max_steps = max_steps or self.tc.max_steps

        rng = np.random.default_rng(self.tc.seed)
        order = rng.permutation(len(dataset))
        di = self.step % max(len(dataset), 1)
        ga = max(self.tc.grad_accum, 1)

        # data pipeline: ONE background worker decodes example di + prefetch
        # while the card runs step di (order-preserving, so runs are
        # bitwise-identical to prefetch=0); dataset-level retry/resample
        # still happens inside __getitem__ on the worker
        pf = max(int(self.tc.prefetch), 0)
        pool = ThreadPoolExecutor(max_workers=1) if pf else None

        def fetch(j: int):
            return dataset[int(order[j % len(order)])]

        pending = collections.deque(pool.submit(fetch, di + k) for k in range(pf)) if pf else None
        try:
            while self.step // ga < max_steps:
                if pf:
                    ex = pending.popleft().result()
                    pending.append(pool.submit(fetch, di + pf))
                else:
                    ex = fetch(di)
                di += 1
                batch = self._prepare_batch(ex)
                t0 = time.perf_counter()
                metrics = self._train_step(batch)
                self.step += 1
                opt_boundary = self.step % ga == 0
                if self.step % self.tc.log_every == 0:
                    # float() is the loop's only sync with the card
                    rec = {
                        "step": self.step,
                        "opt_step": self.step // ga,
                        "loss": float(metrics["loss"]),
                        "labeled_tokens": int(metrics["labeled_tokens"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "step_time": time.perf_counter() - t0,
                    }
                    self._metrics_f.write(json.dumps(rec) + "\n")
                    self._metrics_f.flush()
                    if self._wandb:
                        self._wandb.log(rec, step=self.step)
                # save every save_steps OPTIMIZER steps (at accumulation
                # boundaries only, so resumed runs never replay partial
                # updates)
                if opt_boundary and (self.step // ga) % self.tc.save_steps == 0:
                    self.save_checkpoint()
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
        return self.model

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self):
        path = os.path.join(self.tc.output_dir, f"checkpoint-{self.step}")
        os.makedirs(path, exist_ok=True)
        cpu = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
        torch.save({k: cpu(v) for k, v in self.model.state_dict().items()},
                   os.path.join(path, "params.pt"))
        torch.save(_map_tensors(self.opt_state, cpu), os.path.join(path, "opt_state.pt"))
        with open(os.path.join(path, "trainer_state.json"), "w") as f:
            json.dump({"step": self.step}, f)
        # prune old checkpoints (save_total_limit)
        ckpts = sorted(
            (int(m.group(1)), name)
            for name in os.listdir(self.tc.output_dir)
            if (m := re.fullmatch(r"checkpoint-(\d+)", name))
        )
        while len(ckpts) > self.tc.save_total_limit:
            _, name = ckpts.pop(0)
            shutil.rmtree(os.path.join(self.tc.output_dir, name))

    def load_checkpoint(self, path: str):
        with open(os.path.join(path, "trainer_state.json")) as f:
            self.step = json.load(f)["step"]
        dev = self._device
        self.model.load_state_dict(torch.load(os.path.join(path, "params.pt")))
        state = torch.load(os.path.join(path, "opt_state.pt"))
        self.opt_state = _map_tensors(state, lambda t: t.to(dev))


def _map_tensors(x: Any, fn) -> Any:
    """fn over every tensor of a nest of dicts and lists."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map_tensors(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map_tensors(v, fn) for v in x)
    return x
