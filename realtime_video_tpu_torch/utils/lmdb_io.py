"""LMDB array (de)serialisation helpers (a copy of
realtime_video_tpu/utils/lmdb_io.py; reference utils/lmdb.py:4-72).

The functions take an open lmdb environment, so the lmdb package is needed
only by whoever opens one (`utils/dataset.ShardingLMDBDataset`); the
npz-shard dataset in utils/dataset.py is the native default.
"""
from __future__ import annotations

from typing import Any

import numpy as np


def get_array_shape_from_lmdb(env, array_name: str):
    with env.begin() as txn:
        shape_str = txn.get(f"{array_name}_shape".encode()).decode()
    return tuple(int(x) for x in shape_str.strip("()").split(",") if x.strip())

def store_arrays_to_lmdb(env, arrays_dict, start_index: int = 0) -> None:
    """Write {name: array[N, ...]} rows into lmdb at increasing indices."""
    with env.begin(write=True) as txn:
        for name, arr in arrays_dict.items():
            for i, row in enumerate(arr):
                key = f"{name}_{start_index + i}".encode()
                if isinstance(row, str):
                    txn.put(key, row.encode())
                else:
                    txn.put(key, np.ascontiguousarray(row).tobytes())


def retrieve_row_from_lmdb(env, array_name: str, dtype: Any, row_index: int, shape=None):
    """Read one row; str dtype returns decoded text (utils/lmdb.py:44-72)."""
    key = f"{array_name}_{row_index}".encode()
    with env.begin() as txn:
        buf = txn.get(key)
    if dtype is str:
        return buf.decode()
    arr = np.frombuffer(buf, dtype=dtype)
    if shape is None:
        full = get_array_shape_from_lmdb(env, array_name)
        shape = full[1:]
    return arr.reshape(shape)
