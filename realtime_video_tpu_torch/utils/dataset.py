"""Datasets for distillation training (a copy of
realtime_video_tpu/utils/dataset.py, which imports no JAX; reference
utils/dataset.py).

The reference packs teacher ODE trajectories into LMDB shards
(utils/lmdb.py, scripts/create_lmdb_*.py). LMDB is optional (imported when a
LMDB dataset is opened); the native storage is a directory of npz shards
with the same record schema (`ode_latent` [steps+1, F, C, h, w], `prompts`
str), which memory-maps from local disk.
"""
from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional

import numpy as np


class TextDataset:
    """Prompt lines file (utils/dataset.py:12-34)."""

    def __init__(self, prompt_path: str, extended_prompt_path: Optional[str] = None):
        with open(prompt_path, encoding="utf-8") as f:
            self.prompt_list = [line.rstrip() for line in f if line.strip()]
        self.extended_prompt_list = None
        if extended_prompt_path:
            with open(extended_prompt_path, encoding="utf-8") as f:
                self.extended_prompt_list = [line.rstrip() for line in f if line.strip()]
            assert len(self.extended_prompt_list) == len(self.prompt_list)

    def __len__(self) -> int:
        return len(self.prompt_list)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        item = {"prompts": self.prompt_list[idx], "idx": idx}
        if self.extended_prompt_list is not None:
            item["extended_prompts"] = self.extended_prompt_list[idx]
        return item


class ODERegressionNpzDataset:
    """Directory of npz shards with keys ode_latent_{i} / prompts_{i}
    (native replacement for ODERegressionLMDBDataset, utils/dataset.py:37-69)."""

    def __init__(self, data_path: str, max_pair: int = int(1e8)):
        self.files = sorted(glob.glob(os.path.join(data_path, "*.npz")))
        if not self.files:
            raise FileNotFoundError(f"no npz shards under {data_path}")
        self._shards = [np.load(f, mmap_mode="r", allow_pickle=True) for f in self.files]
        self._index: List = []
        for si, sh in enumerate(self._shards):
            n = int(sh["num_items"]) if "num_items" in sh else len(
                [k for k in sh.files if k.startswith("ode_latent_")]
            )
            for i in range(n):
                self._index.append((si, i))
        self._index = self._index[:max_pair]

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        si, i = self._index[idx]
        sh = self._shards[si]
        return {
            "ode_latent": np.asarray(sh[f"ode_latent_{i}"]),
            "prompts": str(sh[f"prompts_{i}"]),
        }


class ShardingLMDBDataset:
    """Multi-shard LMDB dataset (utils/dataset.py:72-124). Requires lmdb."""

    def __init__(self, data_path: str, max_pair: int = int(1e8)):
        import lmdb  # optional dependency

        self.envs = []
        self.counts = []
        for shard in sorted(glob.glob(os.path.join(data_path, "shard*"))) or [data_path]:
            env = lmdb.open(shard, readonly=True, lock=False, readahead=False)
            self.envs.append(env)
            with env.begin() as txn:
                self.counts.append(int(txn.get(b"length").decode()))
        self.total = min(sum(self.counts), max_pair)

    def _locate(self, idx: int):
        for si, c in enumerate(self.counts):
            if idx < c:
                return si, idx
            idx -= c
        raise IndexError

    def __len__(self) -> int:
        return self.total

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        from realtime_video_tpu_torch.utils.lmdb_io import retrieve_row_from_lmdb

        si, local = self._locate(idx)
        env = self.envs[si]
        latent = retrieve_row_from_lmdb(env, "latents", np.float16, local)
        prompt = retrieve_row_from_lmdb(env, "prompts", str, local)
        return {"ode_latent": latent, "prompts": prompt}


class TextImagePairDataset:
    """(prompt, image) pairs from a folder of images + caption txts
    (utils/dataset.py:127-214, simplified to the fields training uses)."""

    def __init__(self, data_path: str, image_exts=(".jpg", ".jpeg", ".png")):
        self.items = []
        for ext in image_exts:
            self.items += sorted(glob.glob(os.path.join(data_path, f"*{ext}")))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        from PIL import Image

        path = self.items[idx]
        image = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        image = (image - 0.5) * 2.0
        caption_path = os.path.splitext(path)[0] + ".txt"
        prompt = ""
        if os.path.exists(caption_path):
            with open(caption_path, encoding="utf-8") as f:
                prompt = f.read().strip()
        return {"image": image.transpose(2, 0, 1), "prompts": prompt}


def save_ode_shard(path: str, records: List[Dict[str, Any]]) -> None:
    """Pack records into one npz shard (replaces scripts/create_lmdb_*.py)."""
    payload: Dict[str, Any] = {"num_items": np.asarray(len(records))}
    for i, rec in enumerate(records):
        payload[f"ode_latent_{i}"] = np.asarray(rec["ode_latent"])
        payload[f"prompts_{i}"] = np.asarray(rec["prompts"])
    np.savez_compressed(path, **payload)
