"""Steps captured as CUDA graphs: the port's counterpart of the
reference's ``jax.jit`` with the KV cache donated (one compiled shape
over buffers updated in place).

:class:`CapturedStep` wraps ``fn(params, cache, *inputs) -> outputs``:
``cache`` a dict of tensors that ``fn`` updates in place, ``inputs`` and
``outputs`` tuples of tensors.  On the card, its first call, and the
first after ``params``, the cache or an input's shape or dtype changed:

1. allocates a static buffer for each input on the cache's device and
   copies the inputs in;
2. warms up: runs ``fn`` once on the capture stream, on a copy of the
   cache, so that every kernel is loaded, every lazy setting made and
   every split kernel's workspace (``kernels/scratch.py``) sized before
   the capture;
3. captures ``fn`` on the static buffers and the caller's params and
   cache into a ``torch.cuda.CUDAGraph`` with a private memory pool, in
   the ``"global"`` capture mode, so that an op that would wait for the
   card or allocate outside the pool raises;
4. keeps the params, the cache and the workspace the graph points to
   alive, and takes back the launch counts the capture added
   (``kernels/counts.py``): the capture ran nothing.

Every call copies its inputs into the static buffers, replays the graph,
adds the capture's launch counts, and returns the static outputs, which
the next call overwrites: the caller copies them out first (``.cpu()``).
A call whose params or cache are not the tensors captured (leaf by leaf,
by identity) captures anew; no graph replays against other tensors.  A
capture or a replay that fails raises: nothing falls back to running
``fn`` eagerly on the card.

On the CPU (a cache the caller put there) there is nothing to capture:
every call runs ``fn`` eagerly on the static inputs and copies its
results into static outputs, the buffers the card's path returns.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.quant import QTensor
from repro_torch.kernels import counts, scratch

Tensor = torch.Tensor


class GraphCaptureError(RuntimeError):
    """A step could not be captured as a CUDA graph."""


def _tree_leaves(tree) -> List[Tensor]:
    """The tensors of a param tree (dicts, lists, tuples, QTensors), in
    order."""
    out: List[Tensor] = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, QTensor):
            out.append(node.values)
            out.append(node.scale)
        elif isinstance(node, Tensor):
            out.append(node)

    walk(tree)
    return out


def _same(a, b) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


# device index -> the side stream every capture on it warms up and
# captures on
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=index)
    return _CAPTURE_STREAMS[index]


class CapturedStep:
    """``fn`` behind static buffers, captured as one CUDA graph on the
    card (see the module's docstring).

    ``captures`` counts the bindings to new tensors (on the card, each a
    capture); ``launches`` holds the launch counts one replay adds;
    ``pool_bytes`` the bytes the last capture's private pool holds
    (``torch.cuda.memory_reserved`` after less before, and
    ``memory_allocated`` likewise, as ``(reserved, allocated)``)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.captures = 0
        self.launches: counts.Counts = {}
        self.pool_bytes: Tuple[int, int] = (0, 0)
        self.release()

    def release(self) -> None:
        """Drop the graph, its pool and every tensor held for it."""
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: Tuple[Tensor, ...] = ()
        self.outputs: Tuple[Tensor, ...] = ()
        self.scratch: Tuple[Tensor, ...] = ()
        self._leaves: List[Tensor] = []
        self._cache_keys: Tuple = ()
        self._cache_leaves: Tuple = ()
        self._specs: Tuple = ()

    def bound_to(self, params, cache: dict, inputs) -> bool:
        """True when a call with these arguments replays the graph as it
        stands (no capture)."""
        specs = tuple((x.shape, x.dtype) for x in inputs)
        return (bool(self._cache_leaves) and specs == self._specs
                and tuple(cache) == self._cache_keys
                and _same(tuple(cache.values()), self._cache_leaves)
                and _same(_tree_leaves(params), self._leaves))

    def __call__(self, params, cache: dict, *inputs: Tensor
                 ) -> Tuple[Tensor, ...]:
        with torch.inference_mode():
            if not self.bound_to(params, cache, inputs):
                self._bind(params, cache, inputs)
            else:
                for buf, x in zip(self.inputs, inputs):
                    buf.copy_(x)
                self._run(params, cache)
            return self.outputs

    def _run(self, params, cache) -> None:
        if self.graph is None:
            outs = self.fn(params, cache, *self.inputs)
            for buf, o in zip(self.outputs, outs):
                buf.copy_(o)
            return
        self.graph.replay()
        counts.add(self.launches)

    def _bind(self, params, cache: dict, inputs) -> None:
        self.release()
        device = next(iter(cache.values())).device
        self.inputs = tuple(x.to(device, copy=True) for x in inputs)
        self._leaves = _tree_leaves(params)
        self._cache_keys = tuple(cache)
        self._cache_leaves = tuple(cache.values())
        self._specs = tuple((x.shape, x.dtype) for x in inputs)
        self.captures += 1
        if device.type != "cuda":
            self.outputs = tuple(o.clone() for o in
                                 self.fn(params, cache, *self.inputs))
            return
        try:
            self._capture(params, cache, device)
        except BaseException:
            self.release()
            raise
        self._run(params, cache)

    def _capture(self, params, cache: dict, device: torch.device) -> None:
        side = capture_stream(device)
        main = torch.cuda.current_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            copy = {k: v.clone() for k, v in cache.items()}
            self.fn(params, copy, *self.inputs)
            del copy
        main.wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        allocated = torch.cuda.memory_allocated(device)
        graph = torch.cuda.CUDAGraph()
        try:
            with counts.recorded() as self.launches, \
                    torch.cuda.graph(graph, stream=side,
                                     capture_error_mode="global"):
                outs = self.fn(params, cache, *self.inputs)
        except Exception as e:
            raise GraphCaptureError(
                f"capturing {getattr(self.fn, '__name__', self.fn)!r} as a "
                f"CUDA graph failed: {e}") from e
        self.graph = graph
        self.outputs = tuple(outs)
        self.scratch = scratch.held(device, side.cuda_stream)
        self.pool_bytes = (torch.cuda.memory_reserved(device) - reserved,
                           torch.cuda.memory_allocated(device) - allocated)
