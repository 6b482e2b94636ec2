"""Scratch memory kept between launches by the kernels that combine
partial results across blocks in the same launch.

The W8A16 and W8A8 GEMVs (their splits of K, ``kernels/qmatmul.py``) and
the decode attention kernels (their chunks of a row's slots,
``kernels/decode_attention.py``) write each block's partials to a
workspace and count arrivals in an int32 counter per output group; the
last block of a group to arrive adds the partials in a fixed order and
sets its counter back to 0.  The workspace's elements are f32; the W8A8
GEMV stores its int32 partial sums in them, 4 bytes each, as int32.  One
workspace and one counter array serve every such kernel on a (device,
stream): launches on one stream run in order and each leaves every
counter at 0, so each launch finds the pair as it needs it.  The pair
grows to the largest launch seen and is kept, so a decode tick allocates
nothing and launches nothing for it.
"""
from __future__ import annotations

from typing import Tuple

import torch

# (device index, stream) -> [workspace, counters]
_SCRATCH = {}


def get(device: torch.device, stream: int, work_elems: int,
        n_counters: int) -> Tuple[int, int]:
    """Pointers to at least ``work_elems`` f32 of workspace and
    ``n_counters`` int32 counters (all 0) for launches on ``stream``."""
    entry = _SCRATCH.setdefault((device.index, stream), [None, None])
    if entry[0] is None or entry[0].numel() < work_elems:
        entry[0] = torch.empty(work_elems, dtype=torch.float32, device=device)
    if entry[1] is None or entry[1].numel() < n_counters:
        entry[1] = torch.zeros(n_counters, dtype=torch.int32, device=device)
    return entry[0].data_ptr(), entry[1].data_ptr()
