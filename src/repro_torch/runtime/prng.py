"""Threefry2x32 keys and the random draws that temperature sampling takes
from them, bit for bit as JAX 0.9.0 computes them with its defaults
(``jax_default_prng_impl="threefry2x32"``, ``jax_threefry_partitionable=
True``; ``jax/_src/prng.py``, ``jax/_src/random.py``).

A key is a (2,) int64 tensor holding the two uint32 words of a JAX key
(``np.asarray(jax_key)``), a batch of keys an (S, 2) one.  Every word is
kept in int64 and masked to 32 bits after each add and shift: torch's
``uint32`` lacks the ops on CUDA, and ``int32`` shifts right
arithmetically.  Every function is elementwise arithmetic on tensors of
the key's device: no host sync, no ``torch.Generator``, so it runs under
CUDA-graph capture.

- :func:`PRNGKey` is ``jax.random.PRNGKey(seed)``: (0, seed mod 2^32).
- :func:`fold_in` is ``jax.random.fold_in``: the hash of the counter
  pair (0, data) under the key; over an (S,) tensor of data it gives the
  (S, 2) keys ``jax.vmap(lambda d: fold_in(key, d))`` gives.
- :func:`random_bits` draws 32-bit words for a shape: word i of the
  flattened shape is ``x0 ^ x1`` of the hash of the 64-bit counter i
  split as (hi, lo) (``_threefry_random_bits_partitionable``).
- :func:`uniform` puts a word's top 23 bits under the exponent of 1.0,
  subtracts 1, scales to [minval, maxval) and clamps below at minval
  (``random._uniform``).
- :func:`gumbel` is ``-log(-log(uniform(tiny, 1)))`` (``random._gumbel``,
  mode "low").  ``log`` is the one op whose bits differ between
  libraries (XLA's CPU, torch's CPU, CUDA's ``logf``), by a few ulp.
- :func:`categorical` is ``argmax(gumbel + logits)`` along the last axis,
  the first index among ties (``random.categorical``).

:func:`random_bits`, :func:`uniform`, :func:`gumbel` and
:func:`categorical` take one key (a (2,) tensor: one draw over the whole
shape, as JAX's) or a batch of keys (S, 2) for a shape (S, ...): row r
then draws over the row's shape with ``keys[r]``, as ``jax.vmap`` of the
one-key function over the rows does.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                    # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000              # the bits of 1.0f
_F32_MANTISSA = 23
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0: Tensor, k1: Tensor, x0: Tensor, x1: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under the key
    (k0, k1), 20 rounds: every argument int64 holding uint32 values,
    broadcast together (``prng._threefry2x32_lowering``)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) int64 tensor: with 64-bit
    types off JAX takes the seed as an int32, so the high word is 0 and
    the low word the seed mod 2^32."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def as_key(key, device=None) -> Tensor:
    """A key in this module's form from a (2,) or (S, 2) array of uint32
    words (a JAX key through ``np.asarray``, a list, a tensor)."""
    if isinstance(key, Tensor):
        out = key.to(device=device if device is not None else key.device,
                     dtype=torch.int64)
    else:
        out = torch.from_numpy(np.asarray(key).astype(np.int64)).to(device)
    if out.shape[-1:] != (2,):
        raise ValueError(f"a key is (2,) or (S, 2) uint32 words, got "
                         f"shape {tuple(out.shape)}")
    return out & MASK


def fold_in(key: Tensor, data) -> Tensor:
    """``jax.random.fold_in(key, data)``: ``data`` an int (a (2,) key
    back) or an integer tensor of shape (S,) (an (S, 2) batch of keys,
    one per value), each taken mod 2^32 as JAX's uint32 cast."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def _split_keys(key: Tensor, shape: Sequence[int]):
    """(k0, k1, counters): the key words broadcast against the counters
    of ``shape`` (one key: the flat index of the whole shape; keys (S, 2):
    the flat index within each row's shape ``shape[1:]``)."""
    if key.dim() == 1:
        inner = tuple(shape)
        k0, k1 = key[0], key[1]
    else:
        if key.dim() != 2 or shape[0] != key.shape[0]:
            raise ValueError(f"keys {tuple(key.shape)} for shape "
                             f"{tuple(shape)}: want one key (2,) or one "
                             f"per row (shape[0], 2)")
        inner = tuple(shape[1:])
        view = (key.shape[0],) + (1,) * len(inner)
        k0, k1 = key[:, 0].reshape(view), key[:, 1].reshape(view)
    n = 1
    for d in inner:
        n *= int(d)
    if n >= 2 ** 32:
        raise ValueError(f"{n} draws per key: the high counter word is "
                         f"not ported (at most 2^32 - 1)")
    counters = torch.arange(n, dtype=torch.int64,
                            device=key.device).reshape(inner)
    return k0, k1, counters


def random_bits(key: Tensor, shape: Sequence[int]) -> Tensor:
    """32-bit random words of ``shape`` (int64 holding uint32 values):
    ``jax.random.bits(key, shape, jnp.uint32)`` (per row with a batch of
    keys)."""
    k0, k1, lo = _split_keys(key, shape)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return (b0 ^ b1).expand(tuple(shape))


def _uniform_from_bits(bits: Tensor, minval: float, maxval: float
                       ) -> Tensor:
    fbits = (bits >> (32 - _F32_MANTISSA)) | _F32_ONE_BITS
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference as f32 values, exact as Python
    # floats: every op below stays f32 (and no scalar goes to the card)
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(lo))
    return (floats * span + lo).clamp_min(lo)


def uniform(key: Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> Tensor:
    """f32 uniform draws in [minval, maxval): ``jax.random.uniform``."""
    return _uniform_from_bits(random_bits(key, shape), minval, maxval)


def gumbel(key: Tensor, shape: Sequence[int]) -> Tensor:
    """f32 standard Gumbel draws: ``jax.random.gumbel`` (mode "low")."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: Tensor, logits: Tensor) -> Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax of Gumbel noise plus ``logits`` (f32), int64 indices."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)
