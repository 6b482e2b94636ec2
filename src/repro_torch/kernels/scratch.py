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

A CUDA graph keeps the pointers it captured.  Growing replaces the pair
of the stream, so a captured step holds on to the pair it was captured
with (:func:`held`) for as long as it may replay; a pair may grow only
outside a capture, in the warm-up that runs every launch of the step
first (``runtime/graphs.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

# (device index, stream) -> [workspace, counters]
_SCRATCH = {}


def get(device: torch.device, stream: int, work_elems: int,
        n_counters: int) -> Tuple[int, int]:
    """Pointers to at least ``work_elems`` f32 of workspace and
    ``n_counters`` int32 counters (all 0) for launches on ``stream``.
    Raises if the pair would have to grow while ``stream`` is being
    captured into a CUDA graph."""
    entry = _SCRATCH.setdefault((device.index, stream), [None, None])
    grow_work = entry[0] is None or entry[0].numel() < work_elems
    grow_counters = entry[1] is None or entry[1].numel() < n_counters
    if (grow_work or grow_counters) and device.type == "cuda" and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "the split kernels' workspace would grow inside a CUDA graph "
            "capture: run the step once on the capture stream first")
    if grow_work:
        entry[0] = torch.empty(work_elems, dtype=torch.float32, device=device)
    if grow_counters:
        entry[1] = torch.zeros(n_counters, dtype=torch.int32, device=device)
    return entry[0].data_ptr(), entry[1].data_ptr()


def held(device: torch.device, stream: int) -> Tuple[torch.Tensor, ...]:
    """The tensors of ``stream``'s pair as it stands (none if no launch
    on it needed one): what a step captured on ``stream`` points to."""
    entry = _SCRATCH.get((device.index, stream), ())
    return tuple(t for t in entry if t is not None)
