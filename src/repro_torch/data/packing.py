"""Document packing, as ``repro.data.packing``: variable-length documents
concatenated, each followed by an EOS id, into rows of ``seq_len`` tokens
(a trailing partial row dropped), with a loss mask that is 0 at each
document's EOS position and 1 elsewhere."""
from __future__ import annotations

import numpy as np


def pack_documents(docs, seq_len: int, *, eos_id: int = 0):
    """docs: an iterable of 1-D int arrays -> (tokens (N, S) int32,
    loss_mask (N, S) float32)."""
    stream, boundaries = [], []
    for d in docs:
        stream.extend(int(t) for t in d)
        stream.append(eos_id)
        boundaries.append(len(stream) - 1)
    n = len(stream) // seq_len
    toks = np.asarray(stream[:n * seq_len], np.int32).reshape(n, seq_len)
    mask = np.ones_like(toks, np.float32)
    ends = np.asarray(boundaries, np.int64)
    ends = ends[ends < n * seq_len]
    mask.reshape(-1)[ends] = 0.0
    return toks, mask
