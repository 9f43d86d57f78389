"""The benchmark's model weights, made on the device from the run's seed.

Every weight is drawn by this module, never by the program: the program's
loaders receive them through `install_hooks` (its random-init functions are
replaced for the run), and the reference draws the same tensors again, a
layer at a time, after the program's state is freed. A group of leaves (one
DiT or umT5 layer, the DiT's top-level leaves, the whole VAE, a slab of the
token embedding) comes from one `torch.randn` call of a generator seeded from
(seed, group), so any group can be drawn alone and gives the same numbers.

Distributions: linears normal with Xavier's variance 2 / (fan_in + fan_out)
(the DiT's text and time MLPs 0.02, as Wan's init), convs 1 / fan_in,
biases 0.02, norm scales 1 + 0.1 n. Unlike the program's own random init,
the DiT's head and the VAE's attention projection are not zero, so that the
output depends on every layer.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

Path = Tuple


class Leaf(NamedTuple):
    path: Path
    shape: Tuple[int, ...]
    kind: str  # "normal": std * n; "one": 1 + std * n
    std: float
    dtype: torch.dtype


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit generator seed for one group of leaves."""
    digest = hashlib.sha256(repr((int(seed),) + tuple(tags)).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def draw(specs: List[Leaf], seed: int, tags: tuple, device) -> Dict[Path, torch.Tensor]:
    """The group's leaves, from one f32 normal draw sliced in spec order."""
    total = sum(math.prod(leaf.shape) for leaf in specs)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))
    flat = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    out, off = {}, 0
    for leaf in specs:
        n = math.prod(leaf.shape)
        x = flat[off:off + n].view(leaf.shape) * leaf.std
        if leaf.kind == "one":
            x = x + 1.0
        out[leaf.path] = x.to(leaf.dtype)
        off += n
    return out


def _xavier(a: int, b: int) -> float:
    return math.sqrt(2.0 / (a + b))


def _linear(path, din, dout, std, dtype=torch.bfloat16, bias=True) -> List[Leaf]:
    leaves = [Leaf(path + ("w",), (din, dout), "normal", std, dtype)]
    if bias:
        leaves.append(Leaf(path + ("b",), (dout,), "normal", 0.02, dtype))
    return leaves


# ---------------------------------------------------------------------------
# Wan DiT
# ---------------------------------------------------------------------------


def dit_layer_specs(cfg: dict) -> List[Leaf]:
    """One transformer layer's leaves (q, k, v unfused, as the program's init)."""
    d, f = cfg["dim"], cfg["ffn_dim"]
    leaves: List[Leaf] = []
    for group in ("self_attn", "cross_attn"):
        for name in ("q", "k", "v", "o"):
            leaves += _linear((group, name), d, d, _xavier(d, d))
        leaves.append(Leaf((group, "norm_q", "scale"), (d,), "one", 0.1, torch.bfloat16))
        leaves.append(Leaf((group, "norm_k", "scale"), (d,), "one", 0.1, torch.bfloat16))
    leaves += _linear(("ffn", "fc1"), d, f, _xavier(d, f))
    leaves += _linear(("ffn", "fc2"), f, d, _xavier(f, d))
    leaves.append(Leaf(("modulation",), (1, 6, d), "normal", d ** -0.5, torch.float32))
    leaves.append(Leaf(("norm3", "scale"), (d,), "one", 0.1, torch.bfloat16))
    leaves.append(Leaf(("norm3", "bias"), (d,), "normal", 0.02, torch.bfloat16))
    return leaves


def dit_top_specs(cfg: dict) -> List[Leaf]:
    d = cfg["dim"]
    patch = cfg["in_dim"] * math.prod(cfg["patch_size"])
    head_out = cfg["out_dim"] * math.prod(cfg["patch_size"])
    f32 = torch.float32
    return (_linear(("patch_embedding",), patch, d, _xavier(patch, d))
            + _linear(("text_embedding", "fc1"), cfg["text_dim"], d, 0.02)
            + _linear(("text_embedding", "fc2"), d, d, 0.02)
            + _linear(("time_embedding", "fc1"), cfg["freq_dim"], d, 0.02, f32)
            + _linear(("time_embedding", "fc2"), d, d, 0.02, f32)
            + _linear(("time_projection", "fc"), d, 6 * d, _xavier(d, 6 * d), f32)
            + _linear(("head", "head"), d, head_out, _xavier(d, head_out))
            + [Leaf(("head", "modulation"), (1, 2, d), "normal", d ** -0.5, f32)])


def _dit_tags(cfg: dict, key: int, *group) -> tuple:
    """A DiT group's tags: key 0 is the DiT that the run's seed draws, any
    other key (a second DiT of the process) draws other weights."""
    return ("dit", cfg["dim"]) + group + ((key,) if key else ())


def dit_layer(cfg: dict, seed: int, i: int, device, key: int = 0) -> Dict[Path, torch.Tensor]:
    return draw(dit_layer_specs(cfg), seed, _dit_tags(cfg, key, "layer", i), device)


def dit_top(cfg: dict, seed: int, device, key: int = 0) -> Dict[Path, torch.Tensor]:
    return draw(dit_top_specs(cfg), seed, _dit_tags(cfg, key, "top"), device)


def _nest(flat: Dict[Path, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def _stacked(layer_specs: List[Leaf], layers: int, make_layer, device) -> dict:
    """Layer-stacked leaves [L, ...], each layer drawn as its own group."""
    flat = {leaf.path: torch.empty((layers,) + leaf.shape, dtype=leaf.dtype, device=device)
            for leaf in layer_specs}
    for i in range(layers):
        for path, value in make_layer(i).items():
            flat[path][i] = value
    return _nest(flat)


def dit_params(cfg: dict, seed: int, device, key: int = 0) -> dict:
    """The whole DiT of `key` in the program's tree layout (blocks stacked on
    a layer axis)."""
    tree = _nest(dit_top(cfg, seed, device, key))
    tree["blocks"] = _stacked(dit_layer_specs(cfg), cfg["num_layers"],
                              lambda i: dit_layer(cfg, seed, i, device, key), device)
    return tree


# ---------------------------------------------------------------------------
# umT5 encoder
# ---------------------------------------------------------------------------

#: token-embedding rows per group
EMBED_ROWS = 65536


def t5_layer_specs(cfg: dict) -> List[Leaf]:
    d, da, dff, nh = cfg["dim"], cfg["dim_attn"], cfg["dim_ffn"], cfg["num_heads"]
    bf16 = torch.bfloat16
    return [Leaf(("norm1", "scale"), (d,), "one", 0.1, bf16),
            Leaf(("attn", "q", "w"), (d, da), "normal", (d * da) ** -0.5, bf16),
            Leaf(("attn", "k", "w"), (d, da), "normal", d ** -0.5, bf16),
            Leaf(("attn", "v", "w"), (d, da), "normal", d ** -0.5, bf16),
            Leaf(("attn", "o", "w"), (da, d), "normal", da ** -0.5, bf16),
            Leaf(("norm2", "scale"), (d,), "one", 0.1, bf16),
            Leaf(("ffn", "gate", "w"), (d, dff), "normal", d ** -0.5, bf16),
            Leaf(("ffn", "fc1", "w"), (d, dff), "normal", d ** -0.5, bf16),
            Leaf(("ffn", "fc2", "w"), (dff, d), "normal", dff ** -0.5, bf16),
            Leaf(("rel_emb",), (cfg["num_buckets"], nh), "normal",
                 (2 * cfg["num_buckets"] * nh) ** -0.5, torch.float32)]


def t5_layer(cfg: dict, seed: int, i: int, device) -> Dict[Path, torch.Tensor]:
    return draw(t5_layer_specs(cfg), seed, ("t5", cfg["dim"], "layer", i), device)


def t5_norm(cfg: dict, seed: int, device) -> torch.Tensor:
    spec = [Leaf(("scale",), (cfg["dim"],), "one", 0.1, torch.bfloat16)]
    return draw(spec, seed, ("t5", cfg["dim"], "norm"), device)[("scale",)]


def t5_embedding_rows(cfg: dict, seed: int, slab: int, device) -> torch.Tensor:
    """Rows [slab * EMBED_ROWS, ...) of the token embedding, bf16."""
    rows = min(EMBED_ROWS, cfg["vocab_size"] - slab * EMBED_ROWS)
    spec = [Leaf(("emb",), (rows, cfg["dim"]), "normal", 1.0, torch.bfloat16)]
    return draw(spec, seed, ("t5", cfg["dim"], "embedding", slab), device)[("emb",)]


def t5_params(cfg: dict, seed: int, device) -> dict:
    slabs = -(-cfg["vocab_size"] // EMBED_ROWS)
    return {"token_embedding": torch.cat([t5_embedding_rows(cfg, seed, s, device)
                                          for s in range(slabs)]),
            "blocks": _stacked(t5_layer_specs(cfg), cfg["num_layers"],
                               lambda i: t5_layer(cfg, seed, i, device), device),
            "norm": {"scale": t5_norm(cfg, seed, device)}}


# ---------------------------------------------------------------------------
# Wan 2.1 VAE
# ---------------------------------------------------------------------------


def encoder_plan(cfg: dict):
    dims = [cfg["dim"] * u for u in [1] + list(cfg["dim_mult"])]
    plan = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        cur = din
        for _ in range(cfg["num_res_blocks"]):
            plan.append(("res", cur, dout))
            cur = dout
        if i != len(cfg["dim_mult"]) - 1:
            plan.append(("resample", "downsample3d" if cfg["temperal_downsample"][i]
                         else "downsample2d", dout))
    return dims, plan


def decoder_plan(cfg: dict):
    mult = list(cfg["dim_mult"])
    dims = [cfg["dim"] * u for u in [mult[-1]] + mult[::-1]]
    up = list(cfg["temperal_downsample"])[::-1]
    plan = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        cur = din // 2 if i in (1, 2, 3) else din
        for _ in range(cfg["num_res_blocks"] + 1):
            plan.append(("res", cur, dout))
            cur = dout
        if i != len(mult) - 1:
            plan.append(("resample", "upsample3d" if up[i] else "upsample2d", dout))
    return dims, plan


def vae_specs(cfg: dict) -> List[Leaf]:
    bf16 = torch.bfloat16
    leaves: List[Leaf] = []

    def conv(path, kt, kh, kw, cin, cout):
        std = (kt * kh * kw * cin) ** -0.5
        leaves.append(Leaf(path + ("w",), (kt, kh, kw, cin, cout), "normal", std, bf16))
        leaves.append(Leaf(path + ("b",), (cout,), "normal", 0.02, bf16))

    def conv2d(path, cin, cout):
        leaves.append(Leaf(path + ("w",), (3, 3, cin, cout), "normal", (9 * cin) ** -0.5, bf16))
        leaves.append(Leaf(path + ("b",), (cout,), "normal", 0.02, bf16))

    def gamma(path, n):
        leaves.append(Leaf(path + ("gamma",), (n,), "one", 0.1, bf16))

    def res(path, cin, cout):
        gamma(path + ("norm1",), cin)
        conv(path + ("conv1",), 3, 3, 3, cin, cout)
        gamma(path + ("norm2",), cout)
        conv(path + ("conv2",), 3, 3, 3, cout, cout)
        if cin != cout:
            conv(path + ("shortcut",), 1, 1, 1, cin, cout)

    def attn(path, dim):
        gamma(path + ("norm",), dim)
        leaves.extend(_linear(path + ("to_qkv",), dim, 3 * dim, dim ** -0.5))
        leaves.extend(_linear(path + ("proj",), dim, dim, dim ** -0.5))

    def stage(path, plan):
        for i, spec in enumerate(plan):
            if spec[0] == "res":
                res(path + (i,), spec[1], spec[2])
                continue
            mode, dim = spec[1], spec[2]
            if mode.startswith("upsample"):
                conv2d(path + (i, "conv"), dim, dim // 2)
                if mode == "upsample3d":
                    conv(path + (i, "time_conv"), 3, 1, 1, dim, 2 * dim)
            else:
                conv2d(path + (i, "conv"), dim, dim)
                if mode == "downsample3d":
                    conv(path + (i, "time_conv"), 3, 1, 1, dim, dim)

    z = cfg["z_dim"]
    enc_dims, enc_plan = encoder_plan(cfg)
    dec_dims, dec_plan = decoder_plan(cfg)
    e, dd = ("encoder",), ("decoder",)
    conv(e + ("conv1",), 3, 3, 3, 3, enc_dims[0])
    stage(e + ("downsamples",), enc_plan)
    res(e + ("middle_res1",), enc_dims[-1], enc_dims[-1])
    attn(e + ("middle_attn",), enc_dims[-1])
    res(e + ("middle_res2",), enc_dims[-1], enc_dims[-1])
    gamma(e + ("head_norm",), enc_dims[-1])
    conv(e + ("head_conv",), 3, 3, 3, enc_dims[-1], 2 * z)
    conv(dd + ("conv1",), 3, 3, 3, z, dec_dims[0])
    res(dd + ("middle_res1",), dec_dims[0], dec_dims[0])
    attn(dd + ("middle_attn",), dec_dims[0])
    res(dd + ("middle_res2",), dec_dims[0], dec_dims[0])
    stage(dd + ("upsamples",), dec_plan)
    gamma(dd + ("head_norm",), dec_dims[-1])
    conv(dd + ("head_conv",), 3, 3, 3, dec_dims[-1], 3)
    conv(("conv1",), 1, 1, 1, 2 * z, 2 * z)
    conv(("conv2",), 1, 1, 1, z, z)
    return leaves


def vae_flat(cfg: dict, seed: int, device) -> Dict[Path, torch.Tensor]:
    return draw(vae_specs(cfg), seed, ("vae", cfg["dim"], cfg["z_dim"]), device)


def vae_params(cfg: dict, seed: int, device) -> dict:
    """The VAE in the program's tree layout: stage entries are lists."""
    tree = _nest(vae_flat(cfg, seed, device))

    def listify(node):
        if isinstance(node, dict):
            if node and all(isinstance(k, int) for k in node):
                return [listify(node[i]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)
