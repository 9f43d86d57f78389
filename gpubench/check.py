"""How `correct` is decided: what the window produced, against the float32
reference (`reference/`), on a sample of the sessions it finished.

The sample, drawn from the seed, holds a longest finished session (one of
them, drawn from the seed, where several are as long) and
`check_sessions - 1` others. For each, with the same weights, prompt and
noise as the program had (drawn again here from the seed), the reference
computes:
  * block 0 from scratch: the umT5 embedding, the text K/V, the int8
    calibration and quanta, the 4-step denoise -> x0_block0, compared with
    the latents the program produced;
  * warm block 2 (the first with the anti-drift re-encode), following the
    program's state: the re-encode of the program's frame that the session
    re-encodes, the program's two latest latents, the context prefill
    through the KV cache and the denoise -> x0_warm;
  * the streamed VAE decode of the program's latents of blocks 0-2 through
    its cache -> px_block0 and px_warm, compared with the frames the
    program's host copies hold.
Each number is ||program - reference|| / ||reference|| (float64 sums), the
largest over the sample; `correct` holds when each is at most its limit
(the configuration's `limits`). The reference classes, the latent's shape
and the frames each latent decodes to are the configuration's
(`layout.py`).

The control (`control=True`) puts the reference at int4 in the program's
place: its outputs are judged under the same names and limits, so that the
run's `correct` reads the control's (the program's own numbers are kept
beside them as `program.<number>`, outside `correct`). Warm block 2 and the
decode follow the program's state in both: the control's warm block starts
from the same re-encoded frame and latents as the program's did.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from gpubench import layout
from gpubench.reference import umt5
from gpubench.reference.wan_dit import relative_error
from gpubench.reference.wan_vae import frames_of_latents
from gpubench.weights import sub_seed

NUMBERS = ("x0_block0", "x0_warm", "px_block0", "px_warm")
WARM_BLOCK = 2


def sample(finished: list, n: int, seed: int) -> list:
    if not finished:
        return []
    rng = np.random.default_rng(sub_seed(seed, "check"))
    most = max(r.spec.num_blocks for r in finished)
    tied = [r for r in finished if r.spec.num_blocks == most]
    longest = tied[int(rng.integers(len(tied)))]
    rest = [r for r in finished if r is not longest]
    picks = rng.choice(len(rest), size=min(max(n - 1, 0), len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(picks)]


def session_draws(cfg: dict, seed: int, index: int, num_blocks: int, blocks: int, device):
    """(initial noise, per-block renoise draws) of a session, bf16-rounded
    as the program receives them."""
    s = cfg["session"]
    shape = layout.latent_shape(cfg, num_blocks * s["num_frame_per_block"])
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "session", index))
    noise = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    block_shape = (1, s["num_frame_per_block"]) + shape[2:]
    draws = [[torch.randn(block_shape, generator=gen, dtype=torch.float32, device=device)
              .to(torch.bfloat16).float() for _ in range(s["num_denoising_steps"])]
             for _ in range(blocks)]
    return noise.to(torch.bfloat16).float(), draws


def program_outputs(cfg: dict, record) -> Dict[str, torch.Tensor]:
    nfpb = cfg["session"]["num_frame_per_block"]
    lat = torch.from_numpy(record.latents).float()
    out = {"x0_block0": lat[:, :nfpb], "px_block0": torch.from_numpy(record.frames[0]) * 2 - 1}
    if record.spec.num_blocks > WARM_BLOCK:
        w = WARM_BLOCK * nfpb
        out["x0_warm"] = lat[:, w:w + nfpb]
        out["px_warm"] = torch.from_numpy(record.frames[WARM_BLOCK]) * 2 - 1
    return out


def reference_outputs(cfg: dict, seed: int, record, emb: torch.Tensor, dit, vae,
                      device) -> Dict[str, torch.Tensor]:
    s = cfg["session"]
    nfpb = s["num_frame_per_block"]
    t_stride = layout.vae_stride(cfg)[0]
    warm = record.spec.num_blocks > WARM_BLOCK
    noise, draws = session_draws(cfg, seed, record.spec.index, record.spec.num_blocks,
                                 WARM_BLOCK + 1 if warm else 1, device)
    steps = dit.schedule.steps(s["num_denoising_steps"])
    lat = torch.from_numpy(record.latents).to(device)
    cross = dit.cross_kv(emb)
    out = {"x0_block0": dit.block(emb, noise[:, :nfpb], draws[0], steps, None,
                                  s["kv_cache_num_frames"], cross)}
    blocks = WARM_BLOCK + 1 if warm else 1
    pixels = vae.decode_stream(lat[0, :blocks * nfpb])
    out["px_block0"] = pixels[frames_of_latents(0, nfpb, t_stride)][3:][None]
    if warm:
        w = WARM_BLOCK * nfpb
        frame = torch.from_numpy(record.frames[WARM_BLOCK - 1][0, 0]).to(device) * 2 - 1
        first = vae.encode_frame(frame)
        k = s["kv_cache_num_frames"]
        context = torch.cat([first[None, None], lat[:, w - (k - 1):w]], 1)
        out["x0_warm"] = dit.block(emb, noise[:, w:w + nfpb], draws[WARM_BLOCK], steps,
                                   context, k, cross)
        out["px_warm"] = pixels[frames_of_latents(w, nfpb, t_stride)][None]
    return {k: v.cpu() for k, v in out.items()}


def readings(cfg: dict, seed: int, sessions: list, device, qmax: int = 127) -> List[dict]:
    """The reference's outputs at `qmax` for each session (weights,
    calibration and quanta made anew)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = cfg["session"]
    t5 = cfg["text_encoder"]
    embs = []
    for r in sessions:
        ids, mask = umt5.tokenize(r.spec.prompt, t5["text_len"], t5["vocab_size"])
        embs.append(umt5.encode(t5, seed, ids, mask, device))
    dit = layout.reference(cfg, "dit")(cfg, seed, device, qmax=qmax,
                                       int8_qk=cfg["port"]["int8_qk_attention"],
                                       shift=s["timestep_shift"])
    dit.calibrate(dit.schedule.steps(s["num_denoising_steps"]), load_seed=seed)
    vae = layout.reference(cfg, "vae")(cfg["vae"], seed, device, qmax=qmax)
    vae.calibrate(load_seed=seed + 1)
    with torch.no_grad():
        return [reference_outputs(cfg, seed, r, e, dit, vae, device)
                for r, e in zip(sessions, embs)]


def compare(got: List[dict], want: List[dict]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for g, w in zip(got, want):
        for name in NUMBERS:
            if name in w:
                out[name] = max(out.get(name, 0.0), relative_error(g[name], w[name]))
    return out


def check_sessions(cfg: dict, mix: dict, seed: int, finished: list, device,
                   control: bool = False) -> Dict[str, dict]:
    """{number: {"value", "limit"}} for the sample. With `control`, the
    numbers are those of the int4 reference in the program's place, and the
    program's own are kept as {"program." + number: ...}."""
    chosen = sample(finished, mix.get("check_sessions", 1), seed)
    if not chosen:
        return {}
    want = readings(cfg, seed, chosen, device)
    got = compare([program_outputs(cfg, r) for r in chosen], want)
    limits = cfg["limits"]
    out = {name: {"value": v, "limit": limits[name]} for name, v in got.items()}
    if control:
        low = readings(cfg, seed, chosen, device, qmax=7)
        out = {name: {"value": v, "limit": limits[name]}
               for name, v in compare(low, want).items()}
        out.update({"program." + name: {"value": v, "limit": limits[name]}
                    for name, v in got.items()})
    return out
