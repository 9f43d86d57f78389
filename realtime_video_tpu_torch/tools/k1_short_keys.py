"""Where K1's time goes on a short key length: the i2v image cross attention
(32760 queries against 257 CLIP tokens, 40 heads, head dim 128) on a GPU.

    python -m realtime_video_tpu_torch.tools.k1_short_keys [--out chiprun_out]

K1 (`csrc/attention_sm90.cu`) runs one thread block of 128 query rows per
head (10240 blocks at this shape), one block per SM (its shared memory
holds q, two K and two V stages), and walks the window's 128-row K tiles:
3 tiles at Lk 257, the last with one live row. The script times, with CUDA
events over 20 launches each:

  * a sweep of Lk at Lq 32760 (1 to 4 K tiles a block): the kernel alone on
    the bound pre-pass's maxima, the pre-pass alone, the route (both), and
    torch SDPA flash on the same call;
  * the window [0, hi) on a longer K (hi 255 of 256, hi 257 of 384): the
    last tile masked on the fragment as at Lk 257, but loaded whole, inside
    the tensor (no zero fill past its end);
  * a sweep of Lq at Lk 257 (the number of blocks);
  * the int8 QK^T route at Lk 257, its pre-pass alone, and so its kernel.

From the kernel's times it fits, by least squares over the Lk sweep's
whole-tile cases (Lk a multiple of 128), the time of one block as
`t_block + tiles * t_tile` (each wave of 132 blocks runs one block per SM
back to back), and the extra time of a block whose last tile is partial
over the whole-tile fit. Each case carries its bound: the larger of the
bytes it must move over 3.35 TB/s and its operations over 989 TFLOP/s
(bf16), as chip_smoke.py counts them. The rows and the fit go to
`<out>/k1_short_keys.json`.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
SMS = 132


def cuda_ms(fn, n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def bound_ms(lq: int, lk: int, heads: int, hd: int) -> float:
    io = 2.0 * heads * hd * (2 * lq + 2 * lk)  # q, out, k, v in bf16
    flop = 4.0 * heads * hd * lq * lk
    return max(io / HBM_BYTES_PER_S, flop / BF16_FLOPS) * 1e3


def case(hk, lq: int, lk: int, hi=None, heads: int = 40, hd: int = 128, seed: int = 0) -> dict:
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    inv = hd ** -0.5
    q = hk.prescale(rnd(1, lq, heads, hd), inv)
    k, v = rnd(1, lk, heads, hd), rnd(1, lk, heads, hd)
    hi = lk if hi is None else hi
    maxima = hk.logit_bound_maxima(q, k, inv)
    blocks = math.ceil(lq / 128) * heads
    row = dict(lq=lq, lk=lk, hi=hi, heads=heads, k_tiles=math.ceil(hi / 128), blocks=blocks,
               waves=blocks / SMS, bound_ms=bound_ms(lq, hi, heads, hd))
    row["kernel_ms"] = cuda_ms(lambda: hk._launch_sm90(q, k, v, inv, maxima, hk._MODE_WINDOW,
                                                       0, hi, 1, lk, -1))
    row["block_us"] = row["kernel_ms"] * 1e3 / row["waves"]
    if hi < lk:
        return row
    row["prepass_ms"] = cuda_ms(lambda: hk._maxima_launch(q, k, inv))
    row["route_ms"] = cuda_ms(lambda: hk.window_attention(q, k, v, 0, lk, scale=inv,
                                                          route="window"))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        row["sdpa_flash_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                              scale=inv))
    return row


def int8_case(hk, lq: int, lk: int, heads: int = 40, hd: int = 128, seed: int = 0) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    inv = hd ** -0.5
    q = hk.prescale(rnd(1, lq, heads, hd), inv)
    k, v = rnd(1, lk, heads, hd), rnd(1, lk, heads, hd)
    seg = hk.segment_rows(lk)
    route = cuda_ms(lambda: hk._launch_int8(q, k, v, inv, hk._MODE_WINDOW, 0, lk, 1, lk, -1,
                                            seg=seg))
    prepass = cuda_ms(lambda: hk._quantize_launch(q, k, seg, inv))
    return dict(lq=lq, lk=lk, heads=heads, segment_rows=seg, route_ms=route,
                prepass_ms=prepass, kernel_ms=route - prepass)


def fit(rows) -> dict:
    """Least squares of the per-block time over the K tiles of the whole-tile
    cases: t_block + tiles * t_tile; and each partial case's excess over it."""
    whole = [r for r in rows if r["hi"] % 128 == 0]
    n = len(whole)
    xs = [r["k_tiles"] for r in whole]
    ys = [r["block_us"] for r in whole]
    mx, my = sum(xs) / n, sum(ys) / n
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    resid = max(abs(my + slope * (x - mx) - y) for x, y in zip(xs, ys))
    t_block = my - slope * mx
    partial = {f"lk{r['lk']}_hi{r['hi']}": r["block_us"] - (t_block + slope * r["k_tiles"])
               for r in rows if r["hi"] % 128}
    return dict(t_block_us=t_block, t_tile_us=slope, max_residual_us=resid,
                partial_tile_excess_us=partial)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_short_keys needs a CUDA device")
    from realtime_video_tpu_torch.ops import hopper_attention as hk

    hk.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    lk_rows = [case(hk, 32760, lk) for lk in (64, 128, 129, 256, 257, 384, 512)]
    lk_rows += [case(hk, 32760, 256, hi=255), case(hk, 32760, 384, hi=257)]
    lq_rows = [case(hk, lq, 257) for lq in (4096, 8192, 16384)]
    int8 = int8_case(hk, 32760, 257)
    result = dict(card=card, lk_sweep=lk_rows, lq_sweep_at_lk_257=lq_rows,
                  int8qk_lk_257=int8, per_block_fit=fit(lk_rows))
    for r in lk_rows + lq_rows:
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in r.items()}), flush=True)
    print(json.dumps(int8), flush=True)
    print(json.dumps(result["per_block_fit"]), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "k1_short_keys.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
