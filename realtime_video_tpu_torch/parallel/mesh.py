"""Device meshes over torch.distributed (port of realtime_video_tpu/parallel/mesh.py).

The JAX package drives every device from one process and lets GSPMD place
the collectives. The port runs one process per rank (`parallel/launch.py`)
and names the mesh's axes with a `torch.distributed.device_mesh.DeviceMesh`:

  * "tp": tensor parallel, attention heads and FFN columns of the DiT
    (`parallel/sharding.py`), the collectives explicit in `models/wan_dit.py`
    (`parallel/collectives.py`);
  * "dp": data parallel, the batch of the training step;
  * "sp" (or "sp_r" x "sp_u"): sequence parallel, the teacher's tokens
    (`parallel/sequence.py`).

Every function that takes a mesh also takes None, the one-device path, and
the helpers below read None as an axis of size 1.
"""
from __future__ import annotations

import math
import os
import tempfile
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Optional[Dict[str, int]] = None, device_type: str = "cuda") -> DeviceMesh:
    """A DeviceMesh over every rank of the initialised world: shape e.g.
    {"dp": 2, "tp": 2}; {} or None puts the whole world on "tp" (with a
    "dp" of 1), as the JAX function does. The sizes must multiply to the
    world size. `device_type` "cuda" (the default: one card a rank under
    NCCL, or a card shared by ranks under gloo) or "cpu" (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel/launch.run starts the ranks)")
    world = dist.get_world_size()
    if not shape:
        shape = {"dp": 1, "tp": world}
    n = math.prod(shape.values())
    if n != world:
        raise ValueError(f"mesh {shape} needs {n} ranks, the world has {world}")
    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape.keys()))


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    """{"dp": 1, "tp": 1} over a world of one rank, which this initialises
    (a file store in a temporary directory; gloo for "cpu", NCCL for
    "cuda") when no process group exists yet."""
    if not dist.is_initialized():
        store = os.path.join(tempfile.mkdtemp(prefix="rtv_mesh_"), "init")
        dist.init_process_group("gloo" if device_type == "cpu" else "nccl",
                                init_method=f"file://{store}", rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError("single_device_mesh is a world of one rank")
    return make_mesh({"dp": 1, "tp": 1}, device_type)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """Ranks along `axis` (1 for no mesh or a mesh without that axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This rank's coordinate along `axis` (0 for no mesh)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh: Optional[DeviceMesh], axis: str):
    """The process group of this rank's line along `axis`, or None where
    the axis has one rank."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def rank_device(device_type: str = "cuda") -> torch.device:
    """The device this rank computes on: its card (rank modulo the cards,
    so ranks that share a card run on it) or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())
