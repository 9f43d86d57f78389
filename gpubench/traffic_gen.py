"""The one traffic generator: reads a mix's parameters from
`gpubench/traffic/<name>.json` and yields the sessions of a closed loop.

A mix gives `blocks_deck` ({block count: sessions}): the deck is dealt
whole, shuffled, and dealt again, reshuffled, for as long as the loop asks.
The shuffles are the same for every seed, so every seed offers the same
sessions in the same order and a window of a given length holds the same
work. The seed draws each session's prompt: a word count drawn uniformly
from `prompt_words` (inclusive) of lowercase words of 3 to 9 letters. A new
mix is a new file.

The harness runs one kind of loop: `closed_loop` with one client, each
session a text-to-video `GenerationSession` of the cell's configuration. A
mix that asks for anything else (another `kind`, more `clients`, or a key
this generator does not know, such as a session option) is refused, never
run as something it did not ask for.

A mix may place the port over the cell's cards: `placement` holds keys of
the port's server config that `serving/models.vae_placement` reads
(`vae_sp_devices`: the VAE split by rows over cards 1..N beside the DiT on
card 0; `vae_device_index`: the VAE on a card of its own), passed through
as they are; any other key is refused.
"""
from __future__ import annotations

import itertools
import json
from pathlib import Path
from typing import Iterator, NamedTuple

import numpy as np

from gpubench.weights import sub_seed

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
#: the keys a mix may hold, and the values the harness implements
KEYS = {"kind", "clients", "why", "blocks_deck", "prompt_words", "check_sessions",
        "placement"}
IMPLEMENTED = {"kind": ("closed_loop",), "clients": (1,)}
PLACEMENT_KEYS = {"vae_sp_devices", "vae_device_index"}


class SessionSpec(NamedTuple):
    index: int
    prompt: str
    num_blocks: int


def check(mix: dict) -> dict:
    """The mix, or ValueError naming what the harness does not implement."""
    unknown = sorted(set(mix) - KEYS)
    if unknown:
        raise ValueError(f"traffic keys the harness does not implement: {unknown}")
    for key, allowed in IMPLEMENTED.items():
        if mix.get(key) not in allowed:
            raise ValueError(f"traffic {key}={mix.get(key)!r}: the harness implements "
                             f"only {list(allowed)}")
    unknown = sorted(set(mix.get("placement", {})) - PLACEMENT_KEYS)
    if unknown:
        raise ValueError(f"placement keys the port's server config does not read: {unknown}")
    return mix


def load(name: str) -> dict:
    return check(json.loads((TRAFFIC_DIR / f"{name}.json").read_text()))


def deck(mix: dict) -> list:
    return [int(k) for k, n in sorted(mix["blocks_deck"].items(), key=lambda kv: int(kv[0]))
            for _ in range(int(n))]


def sessions(mix: dict, seed: int) -> Iterator[SessionSpec]:
    """The mix's sessions for `seed`, without end."""
    check(mix)
    rng = np.random.default_rng(sub_seed(seed, "traffic"))
    order = np.random.default_rng(sub_seed(0, "deck order"))
    cards = deck(mix)
    lo, hi = mix["prompt_words"]
    index = itertools.count()
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while True:
        for blocks in order.permutation(cards):
            words = [''.join(rng.choice(letters, int(rng.integers(3, 10))))
                     for _ in range(int(rng.integers(lo, hi + 1)))]
            yield SessionSpec(next(index), " ".join(words), int(blocks))
