"""Misc helpers (reference: utils/misc.py); a copy of
realtime_video_tpu/utils/misc.py, which cannot be imported without JAX."""
from __future__ import annotations

import random
import threading
from typing import Dict, List

import numpy as np


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


def merge_dict_list(dict_list: List[Dict]) -> Dict:
    """Merge a list of dicts of arrays by stacking/averaging scalars
    (utils/misc.py:25-38)."""
    if not dict_list:
        return {}
    out = {}
    for key in dict_list[0]:
        vals = [d[key] for d in dict_list]
        first = np.asarray(vals[0])
        if first.ndim == 0:
            out[key] = float(np.mean([np.asarray(v) for v in vals]))
        else:
            out[key] = np.concatenate([np.asarray(v) for v in vals], axis=0)
    return out


class AtomicCounter:
    """Thread-safe counter (utils/misc.py:41-49)."""

    def __init__(self, initial: int = 0):
        self.value = initial
        self._lock = threading.Lock()

    def increment(self, num: int = 1) -> int:
        with self._lock:
            self.value += num
            return self.value
