"""Family -> model module dispatch (the dense and MoE families).

Uniform API per family, as in ``repro/models/registry.py``:
    init(gen, cfg, dtype, device) -> params
    init_quantized(gen, cfg, *, min_size, dtype, device) -> int8 params
    forward(params, tokens, cfg, *, mode, remat) -> logits
    init_cache(cfg, batch, s_max, device) -> cache
    init_paged_cache(cfg, num_slots, s_max, block_size, num_blocks,
                     device) -> cache (families that page)
    decode_step(params, tokens, cache, cache_index, cfg, *, mode)
        -> (logits, cache)

The dense and MoE families are ported; the others arrive with their
model modules (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.qlinear import FP, QuantMode
from repro_torch.models import moe, transformer

_MODULES = {"dense": transformer, "moe": moe}


def module_for(cfg: ArchConfig):
    if cfg.family not in _MODULES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            f"item 13); ported: {sorted(_MODULES)}")
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
    """batch: dict from ``cfg.input_specs`` (tokens only: the ported
    families take no modality embeds)."""
    return module_for(cfg).forward(params, batch["tokens"], cfg, mode=mode,
                                   remat=remat)


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
    """Batch (slot) axis per cache leaf: right behind the layer axis."""
    module_for(cfg)
    return {k: 1 for k in cache}


def mask_inactive_slots(cfg: ArchConfig, old_cache: dict, new_cache: dict,
                        active):
    """Slot-engine isolation hook.  KV caches need nothing: stale positional
    entries are invisible behind each row's ``valid_len`` frontier, so the
    dense and MoE families return ``new_cache`` unchanged."""
    module_for(cfg)
    return new_cache
