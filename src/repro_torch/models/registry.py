"""Family -> model module dispatch (the dense, MoE, encdec, ssm, hybrid
and vlm families).

Uniform API per family, as in ``repro/models/registry.py``:
    init(gen, cfg, dtype, device) -> params
    init_quantized(gen, cfg, *, min_size, dtype, device) -> int8 params
    forward(params, tokens, cfg, *, mode, remat) -> logits
    forward(params, tokens, source_embeds, cfg, *, mode, remat) (encdec's
                                      frames, vlm's patches)
    init_cache(cfg, batch, s_max, device) -> cache
    init_paged_cache(cfg, num_slots, s_max, block_size, num_blocks,
                     device) -> cache (families that page)
    decode_step(params, tokens, cache, cache_index, cfg, *, mode)
        -> (logits, cache)
    draft_params(params, n_layers) -> the self-draft's view (families
                                      that speculate)
    prime_slot(params, source, n_valid, cfg, *, mode) -> primed leaves
                                      (families that prime: encdec, vlm)
    cache_batch_axes(cache) -> {leaf: slot axis} (where not axis 1)
    mask_inactive_slots(old, new, active) -> cache (families with
                                      non-positional state: ssm, hybrid)

Every family of the reference is ported: dense, MoE (a windowed
config's KV ring too), encdec, ssm, hybrid and vlm.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.qlinear import FP, QuantMode
from repro_torch.models import (encdec, moe, rglru, ssm, transformer,
                                vision)

_MODULES = {"dense": transformer, "moe": moe, "encdec": encdec,
            "ssm": ssm, "hybrid": rglru, "vlm": vision}


def module_for(cfg: ArchConfig):
    if cfg.family not in _MODULES:
        raise NotImplementedError(
            f"unknown family {cfg.family!r}; ported: {sorted(_MODULES)}")
    return _MODULES[cfg.family]


def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device=None):
    return module_for(cfg).init(gen, cfg, dtype, device)


def init_quantized(gen: torch.Generator, cfg: ArchConfig, *,
                   min_size: int = 2048, dtype=torch.float32, device=None):
    """``quantize_tree(init(gen, cfg, dtype, device), min_size=min_size)``
    bit for bit, quantizing each layer and table as it is drawn: peak
    memory is the int8 tree plus one f32 layer or table."""
    return module_for(cfg).init_quantized(gen, cfg, min_size=min_size,
                                          dtype=dtype, device=device)


def apply_forward(params, cfg: ArchConfig, batch: dict, *,
                  mode: QuantMode = FP, remat: bool = True):
    """batch: dict from ``cfg.input_specs`` (tokens, and encdec's
    ``encoder_embeds`` or vlm's ``vision_embeds``)."""
    m = module_for(cfg)
    if cfg.family == "encdec":
        return m.forward(params, batch["tokens"], batch["encoder_embeds"],
                         cfg, mode=mode, remat=remat)
    if cfg.family == "vlm":
        return m.forward(params, batch["tokens"], batch["vision_embeds"],
                         cfg, mode=mode, remat=remat)
    return m.forward(params, batch["tokens"], cfg, mode=mode, remat=remat)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, device=None):
    return module_for(cfg).init_cache(cfg, batch, s_max, device)


def apply_decode(params, cfg: ArchConfig, batch: dict, cache, *,
                 mode: QuantMode = FP, logits: bool = True,
                 causal: bool = False):
    return module_for(cfg).decode_step(params, batch["tokens"], cache,
                                       batch["cache_index"], cfg, mode=mode,
                                       logits=logits, causal=causal)


def supports_paging(cfg: ArchConfig) -> bool:
    """True when the family can serve from a paged (block-table) KV
    cache, int8 or bf16: it must have a growing positional KV frontier
    and full attention (a sliding window's ring overwrite has no stable
    position -> block mapping)."""
    return (cfg.window is None
            and hasattr(module_for(cfg), "init_paged_cache"))


def init_paged_cache(cfg: ArchConfig, num_slots: int, s_max: int,
                     block_size: int, num_blocks: int, device=None):
    """Paged KV cache: positional leaves become physical blocks
    (L, num_blocks, block_size, KV, hd) shared by all slots through the
    per-slot ``cache["block_tables"]`` (num_slots, s_max // block_size)
    int32 leaf; block 0 is the reserved trash block."""
    if not supports_paging(cfg):
        raise ValueError(f"family {cfg.family!r} (window={cfg.window}) "
                         f"does not support the paged KV cache")
    return module_for(cfg).init_paged_cache(cfg, num_slots, s_max,
                                            block_size, num_blocks, device)


def paged_block_axes(cfg: ArchConfig, cache: dict) -> dict:
    """Physical-block (NB) axis per paged cache leaf — the axis a block
    table entry indexes.  The table itself is absent from this dict."""
    return module_for(cfg).paged_block_axes(cache)


def cache_batch_axes(cfg: ArchConfig, cache: dict) -> dict:
    """Batch (slot) axis per cache leaf: the module's ``cache_batch_axes``
    where it has one (encdec, vlm: ``xlen`` and the block table lead with
    it), else right behind the layer axis."""
    m = module_for(cfg)
    if hasattr(m, "cache_batch_axes"):
        return m.cache_batch_axes(cache)
    return {k: 1 for k in cache}


def mask_inactive_slots(cfg: ArchConfig, old_cache: dict, new_cache: dict,
                        active):
    """Slot-engine isolation hook, out of place: ``new_cache`` with the
    inactive rows' *non-positional* state restored from ``old_cache``.

    KV caches need nothing: stale positional entries are invisible behind
    each row's ``valid_len`` frontier, so the dense, MoE, encdec and vlm
    families return ``new_cache`` unchanged.  A recurrent family (ssm,
    hybrid) defines ``mask_inactive_slots`` in its module: its state has no
    frontier to hide behind, so inactive rows are frozen bitwise.  The
    port's decode steps write their cache in place, so the slot tick does
    not call this hook: it hands the decode step its row mask as the cache
    view's ``active`` (``runtime/steps.py``), and the module's step keeps
    the same rule layer by layer."""
    m = module_for(cfg)
    if hasattr(m, "mask_inactive_slots"):
        return m.mask_inactive_slots(old_cache, new_cache, active)
    return new_cache


# families whose decode state is a recurrence: it advances one token per
# call of the decode step, through every token fed
RECURRENT = ("ssm", "hybrid")


def decodes_chunk_in_one_pass(cfg: ArchConfig) -> bool:
    """True when ``decode_step(..., causal=True)`` takes a row's s tokens
    in one pass, bitwise s one-token steps (the chunk step's W8A16 path):
    the positional-KV families with full attention.  A recurrent family's
    decode step takes one token a row per call, and a sliding window's
    ring would be written before it is read: once the ring has wrapped,
    the last token's write at ``(p + s - 1) % window`` overwrites position
    ``p + s - 1 - window``, which the first token still attends.  Both
    chunks run token by token, as the reference scans its one-token
    step."""
    return cfg.family not in RECURRENT and cfg.window is None


# ---------------------------------------------------------------------------
# slot-engine contract: per-request primed state (encdec, vlm)
# ---------------------------------------------------------------------------

def needs_prime(cfg: ArchConfig) -> bool:
    """True when the family decodes against per-request primed state
    (encdec's encoder frames, vlm's patch embeddings) that a prime
    dispatch writes into a slot row at admission."""
    return hasattr(module_for(cfg), "prime_slot")


def source_len(cfg: ArchConfig) -> int:
    """Static source length of a prime dispatch: how many frames (encdec)
    or patches (vlm) one slot row's primed cross k/v holds (0 for
    token-only families)."""
    if cfg.family == "encdec":
        return cfg.enc_seq
    return cfg.n_patches if cfg.family == "vlm" else 0


def source_shape(cfg: ArchConfig) -> Optional[tuple]:
    """(source_len, d_model) of one request's source embeddings, or None
    for token-only families: the contract request generators build
    sources against."""
    if not needs_prime(cfg):
        return None
    return (source_len(cfg), cfg.d_model)


def prime_slot(cfg: ArchConfig, params, source, n_valid, *,
               mode: QuantMode = FP) -> dict:
    """Prime one request (encdec: run its encoder; vlm: project its
    patches) and return the slot-resident primed leaves (the
    pre-projected cross k/v and the row's ``xlen``) that a prime dispatch
    writes into the slot's row.  ``source`` is (1,
    source_len(cfg), D) padded to the static length; ``n_valid`` is how
    many positions are real (decode masks reads past it)."""
    return module_for(cfg).prime_slot(params, source, n_valid, cfg,
                                      mode=mode)


def supports_speculation(cfg: ArchConfig) -> bool:
    """True when the family can serve as the target (or the draft) of
    draft-and-verify speculative decoding: its whole decode state must be
    positional KV behind a ``valid_len`` frontier, so a rejected
    speculative tail is rewound by resetting the slot's index — the
    stale writes are overwritten before any read can see them.  That
    excludes the recurrent and primed families and sliding-window
    attention (the ring overwrites the positions a rewind must
    restore)."""
    return (cfg.window is None and cfg.family not in RECURRENT
            and not needs_prime(cfg)
            and hasattr(module_for(cfg), "draft_params"))


def supports_self_draft(cfg: ArchConfig) -> bool:
    """True when the family can draft for itself with a truncated-layer
    view of its own params (no second checkpoint)."""
    return supports_speculation(cfg)


def draft_config(cfg: ArchConfig, n_layers: int) -> ArchConfig:
    """The self-draft model's config: the target's, cut to its first
    ``n_layers`` layers, named ``<name>-draft<n>`` (a config of its own,
    so its memoized steps are its own)."""
    if not 1 <= n_layers <= cfg.n_layers:
        raise ValueError(
            f"draft_layers must be in [1, n_layers={cfg.n_layers}], "
            f"got {n_layers}")
    return dataclasses.replace(cfg, name=f"{cfg.name}-draft{n_layers}",
                               n_layers=n_layers)


def draft_params(cfg: ArchConfig, params, n_layers: int):
    """The self-draft model's params: the target's first ``n_layers``
    layers, the rest shared by reference (zero extra weight memory)."""
    if not supports_self_draft(cfg):
        raise ValueError(f"family {cfg.family!r} (window={cfg.window}) "
                         f"does not support self-draft speculation")
    return module_for(cfg).draft_params(params, n_layers)
