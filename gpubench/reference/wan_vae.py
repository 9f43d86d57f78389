"""Plain float32 Wan 2.1 causal 3D VAE (Wan's vae.py): the streaming decode
through its per-conv caches and the fresh encode, with the int8 tier's 3x3
convs (spatial 3x3 and 3x3x3: per-output-channel weight quanta, a static
input scale calibrated as stated below). 1x1 and time convs, the norms and
the mid-block attention stay float. Activations are [C, T, H, W].

Causality: each causal conv keeps the last 2 input frames of the stream
(zeros at its start) in front of the next chunk. A decode stream starts with
one latent (1 frame out, no time upsampling), then takes one latent a call
(4 frames each). Calibration (the program's recipe, drawn again here): a
float decode of normal latents [1, 2, 8, 8, z] and a fresh encode of one
uniform [-1, 1] 64 x 64 frame from a generator seeded with the VAE's load
seed; amax of each conv's input over them.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from gpubench import weights
from gpubench.reference import quant

#: the Wan 2.1 VAE's published latent statistics
LATENT_MEAN = (-0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
               0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
LATENT_STD = (2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
              3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)


class WanVAE:
    """The VAE of config `cfg` with the weights of `seed`. qmax: 127, 7 or
    None (float). Call `calibrate` before a quantised decode or encode."""

    def __init__(self, cfg: dict, seed: int, device, qmax: Optional[int] = 127):
        self.cfg, self.device, self.qmax = cfg, torch.device(device), qmax
        self.w = {k: v.float() for k, v in weights.vae_flat(cfg, seed, self.device).items()}
        self.amax: Optional[Dict[tuple, float]] = None
        self._quanta: Dict[tuple, tuple] = {}
        self.record: Optional[Dict[tuple, float]] = None
        z = cfg["z_dim"]
        if z == len(LATENT_MEAN):
            self.mean = torch.tensor(LATENT_MEAN, device=self.device)
            self.std = torch.tensor(LATENT_STD, device=self.device)
        else:
            self.mean, self.std = torch.zeros(z, device=self.device), torch.ones(z, device=self.device)

    # -- convs ----------------------------------------------------------------

    def _int8(self, path: tuple) -> bool:
        w = self.w[path + ("w",)]
        return self.qmax is not None and self.amax is not None and (
            (w.dim() == 5 and w.shape[1] == 3) or (w.dim() == 4 and w.shape[0] == 3))

    def conv(self, path: tuple, x: torch.Tensor, stride=1, pad=((1, 1), (1, 1))):
        """x [C, T, H, W] -> the valid-in-time conv of the weights at path
        ([kt, kh, kw, ci, co] or [kh, kw, ci, co]), spatial padding pad."""
        w, b = self.w[path + ("w",)], self.w[path + ("b",)]
        if self.record is not None:
            self.record[path] = max(self.record.get(path, 0.0), float(x.abs().amax()))
        if w.dim() == 4:
            w = w[None]
        if self._int8(path):
            if path not in self._quanta:
                co = w.shape[-1]
                wq, s = quant.weight_quanta(w.reshape(-1, co), self.qmax)
                self._quanta[path] = ((wq * s).reshape(w.shape),
                                      quant.act_scale(self.amax[path], self.qmax))
            w, a = self._quanta[path]
            x = quant.fake_quant_act(x, a, self.qmax)
        (h0, h1), (w0, w1) = pad
        x = F.pad(x, (w0, w1, h0, h1))
        y = F.conv3d(x[None], w.permute(4, 3, 0, 1, 2), stride=(1, stride, stride))[0]
        return y + b[:, None, None, None]

    def causal(self, path: tuple, x: torch.Tensor, cache: dict, stride=1):
        """A causal conv with its 2-frame cache (kt > 1), or a plain one."""
        kt = self.w[path + ("w",)].shape[0]
        if self.w[path + ("w",)].dim() == 5 and kt > 1:
            prev = cache.get(path)
            if prev is None:
                prev = torch.zeros((x.shape[0], 2) + x.shape[2:], device=x.device)
            xin = torch.cat([prev, x], 1)
            cache[path] = xin[:, -2:]
            x = xin
        k = self.w[path + ("w",)].shape[-3]
        return self.conv(path, x, stride, ((k // 2, k // 2), (k // 2, k // 2)))

    # -- blocks ---------------------------------------------------------------

    def rms(self, path: tuple, x: torch.Tensor) -> torch.Tensor:
        g = self.w[path + ("gamma",)]
        return x * torch.rsqrt(x.square().mean(0, keepdim=True) + 1e-12) * g[:, None, None, None]

    def res(self, path: tuple, x: torch.Tensor, cache: dict) -> torch.Tensor:
        h = self.conv(path + ("shortcut",), x, pad=((0, 0), (0, 0))) \
            if path + ("shortcut", "w") in self.w else x
        y = self.causal(path + ("conv1",), F.silu(self.rms(path + ("norm1",), x)), cache)
        y = self.causal(path + ("conv2",), F.silu(self.rms(path + ("norm2",), y)), cache)
        return y + h

    def attn(self, path: tuple, x: torch.Tensor) -> torch.Tensor:
        c, t, hh, ww = x.shape
        y = self.rms(path + ("norm",), x).permute(1, 2, 3, 0).reshape(t, hh * ww, c)
        qkv = y @ self.w[path + ("to_qkv", "w")] + self.w[path + ("to_qkv", "b")]
        q, k, v = qkv.chunk(3, -1)
        p = torch.softmax(q @ k.transpose(-1, -2) * c ** -0.5, -1)
        o = (p @ v) @ self.w[path + ("proj", "w")] + self.w[path + ("proj", "b")]
        return x + o.reshape(t, hh, ww, c).permute(3, 0, 1, 2)

    def up_time(self, path: tuple, x: torch.Tensor, cache: dict, first: bool):
        c, t, hh, ww = x.shape
        key = path + ("time_cache",)
        if first:
            cache[key] = torch.zeros((c, 2, hh, ww), device=x.device)
            return x
        prev = cache[key]
        y = self.conv(path + ("time_conv",), torch.cat([prev, x], 1), pad=((0, 0), (0, 0)))
        if t >= 2:
            cache[key] = x[:, -2:]
        else:  # Wan's rule: the padding frame takes `last` where the cache is nonzero
            last = x[:, -1:]
            cache[key] = torch.cat([torch.where(prev[:, -1:] == 0, 0.0, last), last], 1)
        return y.reshape(2, c, t, hh, ww).permute(1, 2, 0, 3, 4).reshape(c, 2 * t, hh, ww)

    def resample(self, path: tuple, mode: str, x: torch.Tensor, cache: dict, first: bool):
        if mode == "upsample3d":
            x = self.up_time(path, x, cache, first)
        if mode.startswith("upsample"):
            x = x.repeat_interleave(2, 2).repeat_interleave(2, 3)
            return self.conv(path + ("conv",), x)
        x = self.conv(path + ("conv",), x, stride=2, pad=((0, 1), (0, 1)))
        if mode == "downsample3d":
            if not first:
                raise NotImplementedError("the benchmark encodes single fresh frames")
            cache[path + ("time_cache",)] = x
        return x

    def stages(self, path: tuple, plan, x, cache, first):
        for i, spec in enumerate(plan):
            x = self.res(path + (i,), x, cache) if spec[0] == "res" else \
                self.resample(path + (i,), spec[1], x, cache, first)
        return x

    # -- decode / encode --------------------------------------------------------

    def decode_chunk(self, z: torch.Tensor, cache: dict, first: bool) -> torch.Tensor:
        """Normalised latents z [Tz, C, h, w] of one call -> pixels [T, 3, H, W]
        in [-1, 1]; `cache` carries the stream."""
        x = z.permute(1, 0, 2, 3) * self.std[:, None, None, None] + self.mean[:, None, None, None]
        x = self.conv(("conv2",), x, pad=((0, 0), (0, 0)))
        d = ("decoder",)
        x = self.causal(d + ("conv1",), x, cache)
        x = self.res(d + ("middle_res1",), x, cache)
        x = self.attn(d + ("middle_attn",), x)
        x = self.res(d + ("middle_res2",), x, cache)
        x = self.stages(d + ("upsamples",), weights.decoder_plan(self.cfg)[1], x, cache, first)
        x = self.causal(d + ("head_conv",), F.silu(self.rms(d + ("head_norm",), x)), cache)
        return torch.clamp(x, -1.0, 1.0).permute(1, 0, 2, 3)

    def decode_stream(self, latents: torch.Tensor) -> torch.Tensor:
        """latents [Tz, C, h, w] decoded as a session does (the first alone,
        then one a call) -> [1 + 4 (Tz - 1), 3, H, W]."""
        cache: dict = {}
        outs = [self.decode_chunk(latents[:1], cache, True)]
        for i in range(1, latents.shape[0]):
            outs.append(self.decode_chunk(latents[i:i + 1], cache, False))
        return torch.cat(outs)

    def encode_frame(self, pixels: torch.Tensor) -> torch.Tensor:
        """One fresh frame [3, H, W] in [-1, 1] -> its normalised latent [C, h, w]."""
        cache: dict = {}
        e = ("encoder",)
        x = self.causal(e + ("conv1",), pixels[:, None], cache)
        x = self.stages(e + ("downsamples",), weights.encoder_plan(self.cfg)[1], x, cache, True)
        x = self.res(e + ("middle_res1",), x, cache)
        x = self.attn(e + ("middle_attn",), x)
        x = self.res(e + ("middle_res2",), x, cache)
        x = self.causal(e + ("head_conv",), F.silu(self.rms(e + ("head_norm",), x)), cache)
        mu = self.conv(("conv1",), x, pad=((0, 0), (0, 0)))[: self.cfg["z_dim"], 0]
        return (mu - self.mean[:, None, None]) / self.std[:, None, None]

    def calibrate(self, load_seed: int) -> None:
        z = self.cfg["z_dim"]
        gen = torch.Generator(device=self.device).manual_seed(load_seed)
        zc = torch.randn((1, 2, 8, 8, z), generator=gen, device=self.device)
        pxc = torch.rand((1, 1, 64, 64, 3), generator=gen, device=self.device) * 2.0 - 1.0
        self.amax, self.record = None, {}
        self.decode_stream(zc[0].permute(0, 3, 1, 2))
        self.encode_frame(pxc[0, 0].permute(2, 0, 1))
        self.amax, self.record = self.record, None
        self._quanta.clear()


def frames_of_latents(first: int, count: int, t_stride: int = 4) -> List[int]:
    """Indices, in a stream's decoded frames, of latents [first, first + count)
    (the first latent decodes to one frame, each later one to t_stride)."""
    out: List[int] = []
    for j in range(first, first + count):
        out += [0] if j == 0 else list(range(1 + t_stride * (j - 1), 1 + t_stride * j))
    return out
