"""Distillation training on one GPU: the entry point (port of the repo root's train.py).

Alternating generator and critic updates, DMD-style (dmd.py generator_loss
/ critic_loss) or SiD, of a causal generator distilled from a frozen real
score, with a trainable fake score:

    python -m realtime_video_tpu_torch.train --steps 100 \\
        [--config realtime_video_tpu_torch/configs/train_dmd_t2v_1.3B.yaml] \\
        [--prompts prompts.txt] [--loss dmd|sid] [--tiny] [--text-encoder umt5|seeded] \\
        [--device cuda|cpu] [--ckpt-dir DIR --save-every N --resume]

The three networks come from the config's `model_name` (its
`checkpoint_path` when the file exists, else random from seeds 0 / 1 / 2)
in bf16 on the card (`--device`, default the CUDA card; no CPU fallback:
pass `--device cpu` to run there), or with `--tiny` a 2-layer, 64-wide f32
model on 8x8 latents. The config also gives the denoising steps, the
guidance scale and the seed; its `random_heads` replaces the
zero-initialised output heads with N(0, 0.05) draws, so that fresh random
networks give a nonzero DMD gradient (configs/train_dmd_t2v_1.3B.yaml sets
it). `--text-encoder seeded` stands in for umT5 with a fixed random
embedding per prompt. Each DiT layer that keeps a graph runs under
`torch.utils.checkpoint` (the same values and gradients): without it the
activations of a 1.3B step at 6 latent frames of 60x104 outgrow one 80 GB
card. Checkpoints are `torch.save` files (`step_<n>.pt`: the generator and
fake-score trees, both optimizers' states), and `--resume` continues from
the latest; step n's draws come from a generator seeded with (seed, n), so
a resumed run repeats the uninterrupted one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import logging
import os
import re
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from realtime_video_tpu_torch.config import (
    SAMPLE_NEG_PROMPT,
    WanModelConfig,
    load_server_config,
)
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.models.text_encoder import SeededTextEncoder
from realtime_video_tpu_torch.training.distillation import DMD, SiD
from realtime_video_tpu_torch.training.draws import TorchDraws
from realtime_video_tpu_torch.training.losses import trainable, tree_leaves
from realtime_video_tpu_torch.training.train_step import adamw
from realtime_video_tpu_torch.utils.dataset import TextDataset
from realtime_video_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

TINY = WanModelConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2)
#: the distillation run of configs/train_dmd_t2v_1.3B.yaml
TRAIN_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                            "train_dmd_t2v_1.3B.yaml")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--prompts", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--loss", default="dmd", choices=["dmd", "sid"])
    ap.add_argument("--lr", type=float, default=1e-6)
    ap.add_argument("--critic-lr", type=float, default=4e-6)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--num-frames", type=int, default=6)
    ap.add_argument("--latent", type=int, nargs=2, default=[60, 104])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--text-encoder", default="umt5", choices=["umt5", "seeded"],
                    help="umt5: serving/models.load_text_encoder (umT5-xxl, or what its "
                         "switches select); seeded: a fixed random embedding per prompt")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--resume", action="store_true")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Trainer:
    """What `build` makes: the loss object over its three networks, the
    trainable trees and their optimizers, the text encoder."""
    args: argparse.Namespace
    config: Any
    model: DMD
    gen_params: Dict[str, Any]
    fake_params: Dict[str, Any]
    gen_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    text_encoder: Any
    prompts: List[str]
    latent_hw: tuple
    device: torch.device
    seed: int


def random_head(net: WanDiffusion, seed: int) -> None:
    """Replace the zero-initialised output head with N(0, 0.05) draws (seeded)."""
    w = net.params["head"]["head"]["w"]
    gen = torch.Generator(device=w.device).manual_seed(seed)
    w.copy_(torch.randn(w.shape, generator=gen, device=w.device) * 0.05)


def build(args: argparse.Namespace) -> Trainer:
    device = resolve_device(args.device)
    config = load_server_config(args.config)
    seed = int(config.get("seed", 0))
    if args.tiny:
        def mk(s):
            return WanDiffusion(cfg=TINY, dtype=torch.float32, seed=s, device=device,
                                fuse_qkv=False)
        latent_hw = (8, 8)
    else:
        name = config.get("model_name", "t2v-1.3B")

        def mk(s):
            return WanDiffusion(model_name=name, checkpoint_path=config.get("checkpoint_path", ""),
                                timestep_shift=config.get("timestep_shift", 5.0), seed=s,
                                device=device, fuse_qkv=False)
        latent_hw = tuple(args.latent)
    generator, real_score, fake_score = mk(0), mk(1), mk(2)
    if config.get("random_heads", False):
        for i, net in enumerate((generator, real_score, fake_score)):
            random_head(net, 20 + i)
    model = {"dmd": DMD, "sid": SiD}[args.loss](generator, real_score, fake_score, config)
    cfg = generator.cfg
    if args.text_encoder == "umt5":
        from realtime_video_tpu_torch.serving.models import load_text_encoder

        text_encoder = load_text_encoder(config, device)
    else:
        text_encoder = SeededTextEncoder(device, cfg.text_len, cfg.text_dim)
    prompts = TextDataset(args.prompts).prompt_list if args.prompts else ["a cat surfing"]
    gen_params, fake_params = trainable(generator.params), trainable(fake_score.params)
    wd = config.get("weight_decay", 0.01)
    return Trainer(args, config, model, gen_params, fake_params,
                   adamw(gen_params, args.lr, wd), adamw(fake_params, args.critic_lr, wd),
                   text_encoder, prompts, latent_hw, device, seed)


def grad_norm(params: Dict[str, Any]) -> float:
    """The global L2 norm of the gradients of `params`' leaves (0 for none)."""
    sq = [g.detach().float().square().sum() for g in
          (t.grad for t in tree_leaves(params).values()) if g is not None]
    return float(torch.stack(sq).sum().sqrt()) if sq else 0.0


def save(tr: Trainer, step: int) -> str:
    os.makedirs(tr.args.ckpt_dir, exist_ok=True)
    path = os.path.join(tr.args.ckpt_dir, f"step_{step}.pt")
    state = {"step": step,
             "generator": {k: v.detach() for k, v in tree_leaves(tr.gen_params).items()},
             "fake_score": {k: v.detach() for k, v in tree_leaves(tr.fake_params).items()},
             "gen_opt": tr.gen_opt.state_dict(), "critic_opt": tr.critic_opt.state_dict()}
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    found = [(int(m.group(1)), p) for p in glob.glob(os.path.join(ckpt_dir, "step_*.pt"))
             if (m := re.search(r"step_(\d+)\.pt$", p))]
    return max(found)[1] if found else None


def restore(tr: Trainer, path: str) -> int:
    """Load a checkpoint into the trees (in place) and the optimizers; returns
    the step to continue from."""
    state = torch.load(path, map_location=tr.device, weights_only=True)
    with torch.no_grad():
        for name, tree in (("generator", tr.gen_params), ("fake_score", tr.fake_params)):
            for k, t in tree_leaves(tree).items():
                t.copy_(state[name][k])
    tr.gen_opt.load_state_dict(state["gen_opt"])
    tr.critic_opt.load_state_dict(state["critic_opt"])
    return int(state["step"])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


#: the ranges `train_step` marks with its `span`
SPANS = ("generator_step", "critic_step")


def train_step(tr: Trainer, step: int, span=None) -> Dict[str, float]:
    """One generator update, then one critic update; returns the step's
    losses, gradient norms, times and peak memory. `span(name)`, when given,
    is a context manager entered around each update (a profiler's range),
    named as in SPANS."""
    span = span or (lambda name: contextlib.nullcontext())
    args, model, dev = tr.args, tr.model, tr.device
    gen = model.generator
    draws = TorchDraws(tr.seed * 1_000_003 + step, dev)
    prompt = tr.prompts[step % len(tr.prompts)]
    with torch.no_grad():
        embeds = tr.text_encoder([prompt])["prompt_embeds"].to(dev, torch.bfloat16)
        neg = tr.text_encoder([SAMPLE_NEG_PROMPT])["prompt_embeds"].to(dev, torch.bfloat16)
        cross = gen.compute_crossattn_cache(embeds.to(gen.dtype), params=tr.gen_params)
        cross_u = gen.compute_crossattn_cache(neg.to(gen.dtype), params=tr.gen_params)
    h, w = tr.latent_hw
    noise = draws.normal((args.batch, args.num_frames, gen.cfg.in_dim, h, w), gen.dtype, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out: Dict[str, float] = {"step": step}
    _sync(dev)
    t0 = time.perf_counter()
    with span(SPANS[0]):
        tr.gen_opt.zero_grad(set_to_none=True)
        g_loss, _ = model.generator_loss(tr.gen_params, tr.fake_params, noise, cross, cross_u,
                                         draws)
        g_loss.backward()
        out["gen_grad_norm"] = grad_norm(tr.gen_params)
        tr.gen_opt.step()
        _sync(dev)
    t1 = time.perf_counter()
    with span(SPANS[1]):
        tr.critic_opt.zero_grad(set_to_none=True)
        c_loss, _ = model.critic_loss(tr.fake_params, tr.gen_params, noise, cross, draws)
        c_loss.backward()
        out["critic_grad_norm"] = grad_norm(tr.fake_params)
        tr.critic_opt.step()
        _sync(dev)
    t2 = time.perf_counter()
    out.update(gen_loss=float(g_loss.detach()), critic_loss=float(c_loss.detach()),
               gen_ms=(t1 - t0) * 1e3, critic_ms=(t2 - t1) * 1e3)
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def run(tr: Trainer) -> List[Dict[str, float]]:
    """The training loop from the resumed step (or 0) to --steps; returns one
    record per step."""
    args = tr.args
    start = 0
    if args.ckpt_dir and args.resume:
        path = latest_checkpoint(args.ckpt_dir)
        if path is not None:
            start = restore(tr, path)
            log.info("resumed from %s (step %d)", path, start)
    records = []
    for step in range(start, args.steps):
        rec = train_step(tr, step)
        records.append(rec)
        if step % args.log_every == 0:
            log.info("step %d: gen %.4f critic %.4f (%.0f + %.0f ms)", step, rec["gen_loss"],
                     rec["critic_loss"], rec["gen_ms"], rec["critic_ms"])
        if args.ckpt_dir and (step + 1) % args.save_every == 0:
            save(tr, step + 1)
    if args.ckpt_dir and args.steps > start and args.steps % args.save_every:
        save(tr, args.steps)
    return records


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return run(build(args))


if __name__ == "__main__":
    main()
