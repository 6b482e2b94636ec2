"""Steps captured as CUDA graphs: the port's counterpart of the
reference's ``jax.jit`` with the KV cache donated (one compiled shape
over buffers updated in place).

:class:`CapturedStep` wraps ``fn(params, cache, *inputs) -> outputs``:
``cache`` a dict of tensors that ``fn`` updates in place (empty for a
step without one, which then runs on its first input's device),
``inputs`` and ``outputs`` tuples of tensors.  It keeps one graph per
binding: the params and cache leaves (by identity) and the inputs'
shapes and dtypes it was called with.  On the card, the first call of a
binding:

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

Every later call of a binding copies its inputs into the binding's static
buffers (without waiting for the card when an input lies on it or in
pinned memory), replays its graph, adds the capture's launch counts, and
returns its static outputs, which the next call of that binding
overwrites: the caller copies them out first (``.cpu()``).  No graph
replays against tensors it did not capture.  At most ``max_bindings``
bindings are kept: a new one past that evicts the least recently called,
whose graph and pool are released, so that engines taking turns on one
step (the memo in ``runtime/steps.py``) each replay their own graph.  A
capture or a replay that fails raises: nothing falls back to running
``fn`` eagerly on the card.

On the CPU (a cache the caller put there) there is nothing to capture:
every call runs ``fn`` eagerly on the binding's static inputs and copies
its results into its static outputs, the buffers the card's path
returns.
"""
from __future__ import annotations

from collections import OrderedDict
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


# device index -> the side stream every capture on it warms up and
# captures on
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=index)
    return _CAPTURE_STREAMS[index]


# bindings a captured step keeps by default: a few engines (or lanes) of
# one config taking turns.  Every lane and every replica of one config
# binds the memoized step anew (its own cache), so more than four in use
# in turn would capture again at every call; chip_smoke.py's multiplex
# phase keeps at most four of one config in use (two lanes of a
# hot-swap, two replicas and a dedicated engine)
MAX_BINDINGS = 4


class Binding:
    """One graph of a captured step and every tensor it points to:
    ``graph`` (None on the CPU), its static ``inputs`` and ``outputs``,
    the workspace it holds (``scratch``), ``launches`` (the launch counts
    one replay adds) and ``pool_bytes`` (the bytes the capture's private
    pool holds: ``torch.cuda.memory_reserved`` after less before, and
    ``memory_allocated`` likewise, as ``(reserved, allocated)``)."""

    def __init__(self, leaves: List[Tensor], cache: dict,
                 inputs: Tuple[Tensor, ...]):
        self.leaves = leaves
        self.cache_leaves = tuple(cache.values())
        self.inputs = inputs
        self.outputs: Tuple[Tensor, ...] = ()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.scratch: Tuple[Tensor, ...] = ()
        self.launches: counts.Counts = {}
        self.pool_bytes: Tuple[int, int] = (0, 0)


class CapturedStep:
    """``fn`` behind static buffers, captured as one CUDA graph per
    binding on the card (see the module's docstring).

    ``captures`` counts the bindings made (on the card, each a capture),
    ``bindings`` those kept; :meth:`binding` returns the one a call would
    replay."""

    def __init__(self, fn: Callable, max_bindings: int = MAX_BINDINGS):
        if max_bindings < 1:
            raise ValueError(f"max_bindings must be >= 1, got {max_bindings}")
        self.fn = fn
        self.max_bindings = max_bindings
        self.captures = 0
        self.release()

    def release(self) -> None:
        """Drop every graph, its pool and every tensor held for it."""
        self._bindings: "OrderedDict[tuple, Binding]" = OrderedDict()

    @property
    def bindings(self) -> int:
        return len(self._bindings)

    def binding(self, params, cache: dict, *inputs: Tensor
                ) -> Optional[Binding]:
        """The binding that a call on ``params``, ``cache`` and inputs of
        these shapes and dtypes replays, or None if none is kept (the
        call would bind anew)."""
        return self._bindings.get(self._key(_tree_leaves(params), cache,
                                            inputs))

    @staticmethod
    def _key(leaves: List[Tensor], cache: dict, inputs) -> tuple:
        # identities are unique while the binding holds the tensors
        return (tuple(map(id, leaves)), tuple(cache),
                tuple(map(id, cache.values())),
                tuple((x.shape, x.dtype) for x in inputs))

    def __call__(self, params, cache: dict, *inputs: Tensor
                 ) -> Tuple[Tensor, ...]:
        with torch.inference_mode():
            leaves = _tree_leaves(params)
            key = self._key(leaves, cache, inputs)
            b = self._bindings.get(key)
            if b is None:
                return self._bind(key, leaves, params, cache, inputs).outputs
            self._bindings.move_to_end(key)
            for buf, x in zip(b.inputs, inputs):
                buf.copy_(x, non_blocking=x.is_cuda or x.is_pinned())
            self._run(b, params, cache)
            return b.outputs

    def _run(self, b: Binding, params, cache) -> None:
        if b.graph is None:
            outs = self.fn(params, cache, *b.inputs)
            for buf, o in zip(b.outputs, outs):
                buf.copy_(o)
            return
        b.graph.replay()
        counts.add(b.launches)

    def _bind(self, key: tuple, leaves: List[Tensor], params, cache: dict,
              inputs) -> Binding:
        while len(self._bindings) >= self.max_bindings:
            self._bindings.popitem(last=False)
        # a step with no cache (the prefill) runs where its inputs lie
        device = next(iter(cache.values()) if cache else iter(inputs)).device
        b = Binding(leaves, cache,
                     tuple(x.to(device, copy=True) for x in inputs))
        self.captures += 1
        if device.type != "cuda":
            b.outputs = tuple(o.clone() for o in
                              self.fn(params, cache, *b.inputs))
        else:
            self._capture(b, params, cache, device)
            self._run(b, params, cache)
        self._bindings[key] = b
        return b

    def _capture(self, b: Binding, params, cache: dict,
                 device: torch.device) -> None:
        side = capture_stream(device)
        main = torch.cuda.current_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            copy = {k: v.clone() for k, v in cache.items()}
            self.fn(params, copy, *b.inputs)
            del copy
        main.wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        allocated = torch.cuda.memory_allocated(device)
        graph = torch.cuda.CUDAGraph()
        try:
            with counts.recorded() as b.launches, \
                    torch.cuda.graph(graph, stream=side,
                                     capture_error_mode="global"):
                outs = self.fn(params, cache, *b.inputs)
        except Exception as e:
            raise GraphCaptureError(
                f"capturing {getattr(self.fn, '__name__', self.fn)!r} as a "
                f"CUDA graph failed: {e}") from e
        b.graph = graph
        b.outputs = tuple(outs)
        b.scratch = scratch.held(device, side.cuda_stream)
        b.pool_bytes = (torch.cuda.memory_reserved(device) - reserved,
                        torch.cuda.memory_allocated(device) - allocated)
