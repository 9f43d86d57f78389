"""A tiny configuration of the benchmark for CPU tests: the cell's code
paths at toy sizes (the port's plain CPU kernels), with the port's configs
for the names it uses swapped for tiny ones while a test runs."""
from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_cell(int8_qk: bool = False):
    cfg = json.loads((ROOT / "gpubench/configs/t2v-1.3b-int8.json").read_text())
    cfg.update(dim=64, ffn_dim=128, num_heads=2, num_layers=2, text_dim=32)
    cfg["port"] = dict(cfg["port"], model_name="t2v-tiny", int8_qk_attention=int8_qk)
    cfg["text_encoder"] = {"vocab_size": 512, "dim": 32, "dim_attn": 32, "dim_ffn": 64,
                           "num_heads": 2, "num_layers": 2, "num_buckets": 32,
                           "max_dist": 128, "text_len": 512}
    cfg["vae"] = {"dim": 8, "z_dim": 16, "dim_mult": [1, 1, 2, 2], "num_res_blocks": 1,
                  "temperal_downsample": [False, True, True]}
    cfg["session"] = dict(cfg["session"], width=64, height=64)
    mix = {"kind": "closed_loop", "clients": 1, "blocks_deck": {"3": 1},
           "prompt_words": [8, 12], "check_sessions": 1}
    work = {"name": "t2v-1.3b-int8.stream", "config": "t2v-1.3b-int8",
            "traffic": "stream", "chips": 1}
    return cfg, mix, work


def use_tiny_port(monkeypatch, cfg) -> None:
    """Point the port's configs for the names the run uses at cfg's sizes."""
    from realtime_video_tpu_torch import config as port

    monkeypatch.setitem(port.WAN_CONFIGS, "t2v-tiny", port.WanModelConfig(
        dim=cfg["dim"], ffn_dim=cfg["ffn_dim"], num_heads=cfg["num_heads"],
        num_layers=cfg["num_layers"], text_dim=cfg["text_dim"]))
    monkeypatch.setitem(port.T5_CONFIGS, "umt5-xxl", port.T5Config(**cfg["text_encoder"]))
    v = dict(cfg["vae"])
    monkeypatch.setitem(port.VAE_CONFIGS, "wan2.1", port.VAEConfig(
        dim=v["dim"], z_dim=v["z_dim"], dim_mult=tuple(v["dim_mult"]),
        num_res_blocks=v["num_res_blocks"], temperal_downsample=tuple(v["temperal_downsample"])))


def args(seed: int = 2**31 + 11, seconds: float = 8.0, trace: int = 0):
    return argparse.Namespace(workload="t2v-1.3b-int8.stream", seed=seed, seconds=seconds,
                              trace=trace, control=False)


__all__ = ["tiny_cell", "use_tiny_port", "args", "copy"]
