"""File-backed token dataset, as ``repro.data.dataset``: a flat binary
uint16 (or uint32, for ids of 2**16 and up) token stream beside a
``.meta.json`` of its dtype and count, read through ``np.memmap``, cut into
fixed-length windows visited in a per-epoch seeded shuffle. A file either
package writes, the other reads."""
from __future__ import annotations

import json

import numpy as np


def write_token_file(path: str, tokens: np.ndarray):
    tokens = np.asarray(tokens)
    dtype = np.uint16 if tokens.max() < 2**16 else np.uint32
    tokens.astype(dtype).tofile(path)
    with open(path + ".meta.json", "w") as f:
        json.dump({"dtype": dtype.__name__, "count": int(tokens.size)}, f)


class MemmapTokenDataset:
    def __init__(self, path: str, seq_len: int, *, seed: int = 0):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        self._data = np.memmap(path, dtype=np.dtype(meta["dtype"]), mode="r")
        self.seq_len = seq_len
        self.seed = seed
        self.num_windows = len(self._data) // seq_len

    def window(self, epoch: int, idx: int) -> np.ndarray:
        """Window ``idx`` (mod the count) of ``epoch``'s shuffle, int32."""
        order = np.random.default_rng(self.seed + epoch).permutation(
            self.num_windows)
        s = int(order[idx % self.num_windows]) * self.seq_len
        return np.asarray(self._data[s:s + self.seq_len], np.int32)

    def batch(self, epoch: int, start: int, batch_size: int) -> np.ndarray:
        return np.stack([self.window(epoch, start + i)
                         for i in range(batch_size)])
