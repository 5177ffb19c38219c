"""``batch_iterator`` of ``fastmax_tpu/data/packed_dataset.py``, copied. The
packed-chunk readers are not ported yet."""

from __future__ import annotations

import numpy as np


def batch_iterator(dataset, batch_size: int, drop_last: bool = True):
    """Batch an iterable of (block,) arrays into (B, block) matrices."""
    buf = []
    for item in dataset:
        buf.append(item)
        if len(buf) == batch_size:
            yield np.stack(buf)
            buf = []
    if buf and not drop_last:
        yield np.stack(buf)
