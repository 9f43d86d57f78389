"""Disk cache for finished quantised parameter trees (port of
realtime_video_tpu/utils/qcache.py).

A warm server start loads the int8 tiers' finished trees from disk instead of
building, calibrating and quantising them again (the reference ships prebuilt
TRT engines and quantised weights for the same reason).

Keys fold in a hash of the source of every module that shapes the cached
numbers (`code_hash`), so a change to that code misses instead of loading
stale quanta; trees derived from a checkpoint also key on the file's
identity (`file_sig`).

Entries are `torch.save` files of host tensors, written to a temporary file
and renamed into place, so a writer killed mid-write leaves no truncated
entry under a live key; an entry that does not load is a miss. Each tensor is
stored as a view of its whole storage (`torch.save` keeps size, stride and
offset), so a hit gives back the layout that was built, e.g. the K-major
int8 weights the kernels' layout checks require.

Disable with RTV_QUANT_CACHE=0; entries live in RTV_QUANT_CACHE_DIR
(default: `~`), named `.rtv_<prefix>_<key>.pt`. An int8 t2v-1.3B DiT entry
is about 1.4 GB.
"""
from __future__ import annotations

import hashlib
import os
from typing import Any, Callable, Dict, Tuple

import torch

__all__ = ["cache_key", "code_hash", "file_sig", "cached_tree", "enabled"]


def enabled() -> bool:
    return os.getenv("RTV_QUANT_CACHE", "1") in ("1", "true")


def code_hash(module) -> str:
    """Short hash of a module's source file."""
    with open(module.__file__, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:8]


def file_sig(path: str) -> str:
    """Cheap identity of a checkpoint file or directory: path, mtime, size."""
    try:
        st = os.stat(path)
        return f"{path}:{int(st.st_mtime)}:{st.st_size}"
    except OSError:
        return f"{path}:missing"


def cache_key(*parts: Any) -> str:
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]


def _path(prefix: str, key: str) -> str:
    base = os.path.expanduser(os.getenv("RTV_QUANT_CACHE_DIR", "~"))
    return os.path.join(base, f".rtv_{prefix}_{key}.pt")


def move_tree(tree: Any, device) -> Any:
    """The tree with every tensor on `device` in its layout: each storage is
    copied whole, once, and every tensor over it rebuilt as the same view
    (size, stride, offset). Other leaves pass through."""
    storages: Dict[Tuple[int, torch.dtype], torch.Tensor] = {}

    def move(node):
        if isinstance(node, torch.Tensor):
            st = node.untyped_storage()
            key = (st.data_ptr(), node.dtype)
            if key not in storages:
                whole = torch.empty(0, dtype=node.dtype, device=node.device).set_(
                    st, 0, (st.nbytes() // node.element_size(),), (1,))
                storages[key] = whole.to(device)
            return storages[key].as_strided(node.shape, node.stride(), node.storage_offset())
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(move(v) for v in node)
        return node

    return move(tree)


def cached_tree(prefix: str, key: str, build: Callable[[], Any], device="cpu",
                log=None) -> Any:
    """The tree cached under (prefix, key), its tensors on `device`; on a miss
    `build()` makes it, and it is stored before being returned as built.
    Non-tensor leaves (configs, scalars) are stored as they are."""
    path = _path(prefix, key)
    if enabled() and os.path.exists(path):
        try:
            # the entry is one this program wrote (its configs need pickle)
            tree = move_tree(torch.load(path, map_location="cpu", weights_only=False), device)
            if log is not None:
                log.info("quantised-param cache HIT %s", path)
            return tree
        except Exception:  # noqa: BLE001 — a truncated or corrupt entry is a miss
            if log is not None:
                log.warning("quantised-param cache CORRUPT %s: rebuilding", path)
            try:
                os.remove(path)
            except OSError:
                pass
    tree = build()
    if enabled():
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            torch.save(move_tree(tree, "cpu"), tmp)
            os.replace(tmp, path)
            if log is not None:
                log.info("quantised-param cache stored %s", path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
    return tree
