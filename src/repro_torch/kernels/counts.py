"""The kernel wrappers' launch counts, read and added to as one record.

Each wrapper that launches a CUDA kernel adds one to its ``.launches``
where it launches (``qmatmul_w8a16`` also to its path's count in
``.launches_by_path``) and registers itself here.  A CUDA graph records
launches without running them and replays them without calling the
wrappers, so a captured step (``runtime/graphs.py``) reads the counts
around its capture with :func:`snapshot`, takes back what the capture
added (:func:`recorded`) and adds it again on every replay with
:func:`add`: the counts stay the number of launches that ran.

A record maps ``name`` (the wrapper's ``.launches``) and ``name[path]``
(its ``.launches_by_path[path]``) to a count.  An entry point that runs
plain PyTorch in place of a kernel (the attention gradient,
``flash_attention.flash_attention_bwd``) counts its ``.calls`` instead,
registered with ``attr="calls"``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Tuple

Counts = Dict[str, int]

_COUNTED: Dict[str, Tuple[Callable, str]] = {}


def register(fn: Callable, attr: str = "launches") -> Callable:
    """Count ``fn.<attr>`` (and ``fn.launches_by_path``, if it has one)
    in every record."""
    _COUNTED[fn.__name__] = (fn, attr)
    return fn


def snapshot() -> Counts:
    """Every registered wrapper's counts as they stand."""
    out = {}
    for name, (fn, attr) in _COUNTED.items():
        out[name] = getattr(fn, attr)
        for path, n in getattr(fn, "launches_by_path", {}).items():
            out[f"{name}[{path}]"] = n
    return out


def difference(after: Counts, before: Counts) -> Counts:
    """What was counted between two snapshots (zero entries left out)."""
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def add(delta: Counts, times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counts (a negative ``times`` takes
    it back)."""
    for key, n in delta.items():
        name, _, path = key.partition("[")
        fn, attr = _COUNTED[name]
        if path:
            fn.launches_by_path[path[:-1]] += n * times
        else:
            setattr(fn, attr, getattr(fn, attr) + n * times)


@contextlib.contextmanager
def recorded() -> Iterator[Counts]:
    """Record what the body counts and take it back on exit: the body's
    launches were captured, not run.  Yields the record, filled in on
    exit (also when the body raises)."""
    record: Counts = {}
    before = snapshot()
    try:
        yield record
    finally:
        record.update(difference(snapshot(), before))
        add(record, -1)
