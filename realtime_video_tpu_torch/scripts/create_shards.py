"""Pack loose ODE-pair .npz records into training shards (port of the repo's
scripts/create_shards.py, which replaces the reference's
scripts/create_lmdb_iterative.py / create_lmdb_14b_shards.py).

    python -m realtime_video_tpu_torch.scripts.create_shards --src ode_dumps/ \\
        --out shards/ [--shard-size 64] [--lmdb]

Every `*.npz` under --src holds one record (`ode_latent`, `prompts`) or
`num_items` of them (`ode_latent_<i>`, `prompts_<i>`, as
`generate_ode_pairs` writes); they are repacked `--shard-size` to an npz
shard (`utils/dataset.save_ode_shard`), or with --lmdb to an LMDB
environment each (`utils/lmdb_io`), which needs the `lmdb` package.
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import numpy as np

from realtime_video_tpu_torch.utils.dataset import save_ode_shard


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="dir of per-item .npz dumps")
    ap.add_argument("--out", required=True)
    ap.add_argument("--shard-size", type=int, default=64)
    ap.add_argument("--lmdb", action="store_true")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Write the shards; returns how many."""
    args = parse_args(argv)
    if args.lmdb:
        try:
            import lmdb  # noqa: F401
        except ImportError as e:
            raise ImportError("--lmdb needs the lmdb package; without it, write npz "
                              "shards (drop --lmdb)") from e
    files = sorted(glob.glob(os.path.join(args.src, "*.npz")))
    os.makedirs(args.out, exist_ok=True)
    records, shard_idx = [], 0
    for f in files:
        data = np.load(f, allow_pickle=True)
        n = int(data["num_items"]) if "num_items" in data else 1
        for i in range(n):
            records.append({
                "ode_latent": data[f"ode_latent_{i}"] if n > 1 else data["ode_latent"],
                "prompts": str(data[f"prompts_{i}"] if n > 1 else data["prompts"]),
            })
            if len(records) >= args.shard_size:
                _flush(records, args, shard_idx)
                records, shard_idx = [], shard_idx + 1
    if records:
        _flush(records, args, shard_idx)
        shard_idx += 1
    print(f"wrote {shard_idx} shards to {args.out}")
    return shard_idx


def _flush(records, args, shard_idx: int) -> None:
    if not args.lmdb:
        save_ode_shard(os.path.join(args.out, f"shard_{shard_idx:04d}.npz"), records)
        return
    import lmdb

    from realtime_video_tpu_torch.utils.lmdb_io import store_arrays_to_lmdb

    env = lmdb.open(os.path.join(args.out, f"shard{shard_idx:04d}"), map_size=1 << 40)
    store_arrays_to_lmdb(env, {"latents": np.stack([r["ode_latent"] for r in records]),
                               "prompts": [r["prompts"] for r in records]})
    with env.begin(write=True) as txn:
        txn.put(b"length", str(len(records)).encode())
    env.close()


if __name__ == "__main__":
    main()
