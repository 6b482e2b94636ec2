"""Optimizers built in-tree: AdamW and Adafactor (the port of
``repro/optim/optimizers.py``).

AdamW keeps f32 m and v (and f32 master weights when the params are
low-precision); Adafactor keeps factored second moments (row and column)
for the big 2-D weights.  Every state is a tree (dicts, lists, the
states' NamedTuples) that checkpoints treat as they treat the params:
AdamW's mirrors the params, Adafactor's the reference's stacked layout
(:func:`adafactor_init`).

Where the reference builds new trees and lets XLA update them in place
(the launcher donates params and state to the jitted step), the port
writes them in place: each update runs under ``torch.no_grad()`` and
overwrites m, v (or vr, vc), the master copy and the params leaf by
leaf, with the reference's arithmetic in the reference's order, so the
values are the functional form's; the functions still return ``(params,
state)``.  :func:`clip_by_global_norm` scales the gradients in place for
the same reason: a full-width model's params, grads and AdamW moments
fill most of one card, and a second copy of any of them would not fit.
The step counter and the learning rate stay on the params' device, so a
step never waits for the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

Tensor = torch.Tensor


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map(f, *trees):
    """``f`` over the leaves of ``trees`` (the first tree's structure:
    dicts, lists, tuples and NamedTuples are nodes, None is an empty
    subtree and stays None, anything else is a leaf)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in first}
    if _is_namedtuple(first):
        return type(first)(*(tree_map(f, *xs) for xs in zip(*trees)))
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(f, *xs) for xs in zip(*trees))
    return f(*trees)


def tree_leaves(tree) -> list:
    """The leaves in the reference's order (``jax.tree_util``: a dict's
    keys sorted, lists and tuples in order, None left out)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for node in tree for x in tree_leaves(node)]
    return [tree]


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place so that their global L2 norm is at most
    ``max_norm``; returns ``(grads, gnorm)``, the norm before scaling as
    a () f32 tensor on the grads' device."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in leaves))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    for g in leaves:
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, gnorm


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[Tensor], Tensor]:
    """Linear warm-up over ``warmup`` steps, then a cosine decay to 0 at
    ``total``; a function of the step tensor, on its device."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * torch.clamp(step / max(1, warmup), max=1.0)
        frac = torch.clamp((step - warmup) / max(1, total - warmup),
                           0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def _device_of(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: Tensor            # () int32, on the params' device
    m: object
    v: object
    master: object          # f32 master copy when params are low-precision


def adamw_init(params, *, keep_master: bool = True) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    master = (tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                       params) if keep_master else None)
    return AdamWState(
        torch.zeros((), dtype=torch.int32, device=_device_of(params)),
        zeros, tree_map(torch.zeros_like, zeros), master)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *,
                 lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step, written into ``params`` and ``state`` in place;
    returns them."""
    state.step.add_(1)
    step = state.step.float()
    lr_t = lr(state.step) if callable(lr) else lr
    bc1 = 1.0 - torch.pow(b1, step)
    bc2 = 1.0 - torch.pow(b2, step)
    ps = tree_leaves(params)
    bases = tree_leaves(state.master) if state.master is not None else ps
    for p, base, g, m, v in zip(ps, bases, tree_leaves(grads),
                                tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        pf = base.float()
        new = pf - lr_t * (m / bc1 / (torch.sqrt(v / bc2) + eps)
                           + weight_decay * pf)
        base.copy_(new)
        if base is not p:
            p.copy_(new)
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; no momentum)
# ---------------------------------------------------------------------------

class AdafactorState(NamedTuple):
    step: Tensor   # () int32, on the params' device
    vr: object     # row second-moment (or full v for <2D leaves)
    vc: object     # col second-moment ((1,) placeholders for <2D leaves)


@dataclasses.dataclass(frozen=True)
class _Stack:
    """The tensors that stand for one leaf of the reference's tree: the
    same path in each dict of a layer list, stacked on the leading axes
    ``lead`` as the reference stacks them (``(L,)``; the vlm's
    ``(groups, per group)`` plain layers and ``(groups,)`` cross layers),
    or one tensor outside such a list (``lead`` empty)."""
    tensors: tuple
    lead: tuple

    @property
    def shape(self) -> tuple:
        return self.lead + tuple(self.tensors[0].shape)

    def value(self) -> Tensor:
        if not self.lead:
            return self.tensors[0]
        return torch.stack(self.tensors).reshape(self.shape)

    def write(self, new: Tensor) -> None:
        if not self.lead:
            self.tensors[0].copy_(new)
            return
        rows = new.reshape((-1,) + tuple(self.tensors[0].shape))
        for t, row in zip(self.tensors, rows):
            t.copy_(row)


def _signature(tree):
    if isinstance(tree, dict):
        return tuple((k, _signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(_signature(x) for x in tree)
    return None


def _layer_stacks(layers: list):
    """A layer list in the reference's stacked layout: one stack of every
    layer where they share one structure; else the reference's groups
    (the vlm's plain layers and the cross layer closing each group): the
    layers up to the last one whose structure differs from the first's
    are G groups, G the count of that closing structure.  The closing
    structure stacks on (G,) and each other structure on (G, per group),
    as the reference's nested ``vmap`` lays them (``groups.xattn`` and
    ``groups.plain``, the latter (G, 1) at one plain layer a group); the
    layers after it (the leftover) stack on one axis."""
    def stack(items, lead):
        return tree_map(lambda *ts: _Stack(ts, lead), *items)

    sigs = [_signature(x) for x in layers]
    if len(set(sigs)) == 1:
        return stack(layers, (len(layers),))
    end = max(i for i, s in enumerate(sigs) if s != sigs[0]) + 1
    closing = sigs[end - 1]
    groups = sigs[:end].count(closing)
    out = []
    for sig in dict.fromkeys(sigs[:end]):
        items = [x for x, s in zip(layers[:end], sigs) if s == sig]
        if len(items) % groups:
            raise ValueError(
                f"a layer list of mixed structure is stacked as {groups} "
                f"groups closed by one layer each, but one structure "
                f"occurs {len(items)} times in them, not a multiple of "
                f"{groups}")
        out.append(stack(items, (groups,) if sig == closing
                         else (groups, len(items) // groups)))
    if end < len(layers):
        out.append(stack(layers[end:], (len(layers) - end,)))
    return out


def _stacks(tree):
    """``tree`` with each layer list (a list of dicts) folded into its
    stacked form (:func:`_layer_stacks`), and every other tensor a
    :class:`_Stack` of one: the reference's stacked layout."""
    if isinstance(tree, dict):
        return {k: _stacks(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and all(isinstance(x, dict)
                                               for x in tree):
        return _layer_stacks(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stacks(x) for x in tree)
    return _Stack((tree,), ())


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def adafactor_init(params) -> AdafactorState:
    """The moments in the reference's layout: a layer list's moments are
    one dict of tensors stacked on a leading layer axis, since the
    reference's factored rule and update clip see the stacked leaf (a
    (L, d) stack of biases is factored when L >= 8; the clip's RMS is
    taken over every layer of a leaf)."""
    def vr_init(st):
        shape = st.shape[:-1] if _factored(st.shape) else st.shape
        return torch.zeros(shape, dtype=torch.float32,
                           device=st.tensors[0].device)

    def vc_init(st):
        shape = (st.shape[:-2] + st.shape[-1:] if _factored(st.shape)
                 else (1,))                              # placeholder
        return torch.zeros(shape, dtype=torch.float32,
                           device=st.tensors[0].device)

    stacks = _stacks(params)
    return AdafactorState(
        torch.zeros((), dtype=torch.int32, device=_device_of(params)),
        tree_map(vr_init, stacks), tree_map(vc_init, stacks))


@torch.no_grad()
def adafactor_update(params, grads, state: AdafactorState, *,
                     lr, decay: float = 0.8, eps: float = 1e-30,
                     clip_threshold: float = 1.0,
                     weight_decay: float = 0.0):
    """One Adafactor step, written into ``params`` and ``state`` in place
    (a layer list's leaf is updated as the reference's stacked leaf, on a
    stacked copy of its layers); returns them."""
    state.step.add_(1)
    lr_t = lr(state.step) if callable(lr) else lr
    beta = 1.0 - torch.pow(state.step.float() + 1.0, -decay)
    for st, gst, vr, vc in zip(tree_leaves(_stacks(params)),
                               tree_leaves(_stacks(grads)),
                               tree_leaves(state.vr),
                               tree_leaves(state.vc)):
        # the reference's expressions, each temporary freed or reused as
        # soon as it is spent (the same values: a stacked leaf, such as
        # qwen2-moe's (L, 60, 2048, 1408) experts, is 5.5 GB a copy, and
        # at most three copies are alive at once)
        g = gst.value().float()
        g2 = torch.square(g).add_(eps)
        if _factored(st.shape):
            vr.copy_(beta * vr + (1 - beta) * torch.mean(g2, dim=-1))
            vc.copy_(beta * vc + (1 - beta) * torch.mean(g2, dim=-2))
            del g2
            r = vr / torch.mean(vr, dim=-1, keepdim=True)
            update = g / (torch.sqrt(r)[..., None]
                          * torch.sqrt(vc)[..., None, :])
        else:
            vr.copy_(beta * vr + (1 - beta) * g2)
            del g2
            update = g / torch.sqrt(vr)
        del g
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-12)
        update.div_(torch.clamp(rms / clip_threshold, min=1.0))
        # pf - lr_t * update - lr_t * weight_decay * pf, left to right
        pf = st.value().float()
        new = torch.sub(pf, update.mul_(lr_t), out=update)
        st.write(new.sub_(pf.mul_(lr_t * weight_decay)))
        del update, new, pf        # before the next leaf's copies are made
    return params, state


# ---------------------------------------------------------------------------
# uniform facade
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable


def make_optimizer(name: str, *, lr, weight_decay: float = 0.1,
                   keep_master: bool = False) -> Optimizer:
    if name == "adamw":
        return Optimizer(
            "adamw",
            lambda p: adamw_init(p, keep_master=keep_master),
            lambda p, g, s: adamw_update(p, g, s, lr=lr,
                                         weight_decay=weight_decay))
    if name == "adafactor":
        return Optimizer(
            "adafactor",
            adafactor_init,
            lambda p, g, s: adafactor_update(p, g, s, lr=lr,
                                             weight_decay=weight_decay))
    raise ValueError(name)
