"""The VAE split by image rows over devices, driven from one process (port of
the "sp"-sharded VAE of realtime_video_tpu/models/vae_wrapper.py:48-79 and
serving/models.py:165-178, where GSPMD shards the activations along H over
chips 1..N and inserts the conv halo exchanges).

The serving process drives every card itself, so the split is no set of
ranks: the VAE's params are copied to each of its devices (`replicate`), an
activation is a list of N row shards, shard s on devices[s] (`split_rows`;
`vae.join_rows` gathers them), and `models/vae.py` runs its one graph over
the list, the unsplit VAE being one shard. There each shard takes its halo rows from its neighbours as a
peer copy before every conv that reads them (`vae._Walk.halo`; at the
image's top and bottom edges the conv's zero padding stands in):

  * a kt x 3 x 3 causal conv takes one row above and one below, exchanged on
    the spliced input (cached frames + the chunk), so the neighbours' cached
    rows come across with it and each shard's cache holds its own rows only,
    as the H-sharded cache of the JAX package does; the fresh T = 1 chunk's
    tap skip takes the same halo;
  * an upsample takes one low-resolution row each way before the nearest 2x
    (one upsampled row of each is read), which also serves the phase-folded
    conv (`vae.fuse_decoder_upsample`);
  * the encoder's stride-2 downsample (ZeroPad (0, 1, 0, 1)) takes one row
    from below only, so every shard height must be even at each stage;
  * the mid-block attention attends over the whole frame: each shard keeps
    its queries and gathers every shard's keys and values;
  * an int8 conv without a static activation scale takes the largest of the
    shards' per-call scales, the unsplit conv's scale (`vae._Walk.scales`).

1x1 convs, norms, time convs and their caches are per pixel or per row, so
each shard runs them alone. The latent height must divide by N (every stage
then splits evenly); nothing is padded.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from realtime_video_tpu_torch.utils.qcache import move_tree


def replicate(params, devices: Sequence[torch.device]) -> list:
    """The param tree once on each device, in its layout (the int8 convs'
    K-major views kept); shards on one device share one copy, and the device
    the tree lies on takes it as it is."""
    home = params["conv2"]["w"].device
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = params if d == home else move_tree(params, d)
    return [copies[d] for d in devices]


def check_rows(h: int, n: int) -> None:
    """Raise unless a latent height h splits into n equal row shards."""
    if h % n:
        raise ValueError(f"latent height {h} does not split over {n} row shards: the "
                         f"latent height must divide by the shard count (nothing is padded)")


def split_rows(x: torch.Tensor, devices: Sequence[torch.device], axis: int) -> List[torch.Tensor]:
    """x cut along `axis` into len(devices) equal row shards, shard s on
    devices[s] (one device: x as it is, moved there)."""
    if x.shape[axis] % len(devices):
        raise ValueError(f"{tuple(x.shape)} does not split over {len(devices)} row shards "
                         f"along axis {axis}")
    return [part.to(d, non_blocking=True)
            for part, d in zip(x.chunk(len(devices), dim=axis), devices)]
