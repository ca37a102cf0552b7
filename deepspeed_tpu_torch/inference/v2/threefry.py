"""The pieces of ``jax.random`` that keyed sampling uses, in torch.

Keyed sampling draws a sampled token from a key that is a pure function
of (base key, request uid, generation position); the JAX package derives
it with ``jax.random`` (Threefry-2x32, the default PRNG), and a bundle or
a handoff between the two packages only resumes a sampled request
tokenwise when both draw the same bits.  So this module computes what
``jax.random`` computes under its defaults (32-bit mode,
``jax_threefry_partitionable=True``), bit for bit:

* a key is a pair of uint32 words ``[..., 2]``;
* :func:`key_from_seed` is ``jax.random.key(seed)``: in 32-bit mode the
  seed's low 32 bits, behind a zero high word;
* :func:`fold_in` is ``jax.random.fold_in`` (the data converted to
  uint32 first, so an int32 uid that wrapped negative folds as its
  uint32 bit pattern);
* :func:`random_bits` is the partitionable ``random_bits`` of 32-bit
  width: Threefry over the 64-bit iota counters of the shape, the two
  output words xor'd;
* :func:`uniform` puts 23 random mantissa bits under the exponent of
  1.0, subtracts 1 and scales to ``[minval, maxval)``;
* :func:`gumbel` is mode ``"low"``: ``-log(-log(uniform(tiny, 1)))``;
* :func:`categorical` is ``argmax(gumbel + logits)``.

The words live in int64 tensors on the caller's device, every sum and
shift masked back to 32 bits (``torch.uint32`` has neither shifts nor
wraparound on these builds), so the whole draw is plain elementwise
torch ops that a CUDA graph captures.  ``torch.log`` and XLA's ``log``
may differ in the last place, so the gumbel noise is equal to within an
ulp or two; the bits and the uniforms are equal exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
#: Threefry-2x32's key-schedule parity constant
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the smallest normal float32: the uniform's floor in the gumbel draw
_TINY_F32 = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2); every argument an int64 tensor of uint32
    values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def key_from_seed(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` in JAX's default
    32-bit mode: ``[0, seed & 0xFFFFFFFF]`` as an int64 [2] tensor."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: ``key`` [..., 2] and
    ``data`` (any integer tensor, taken as its uint32 bit pattern)
    broadcast together; returns the folded keys [..., 2]."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (uint32, partitionable) for each
    key of ``keys`` [S, 2]: int64 [S, n]."""
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(counts),
                          counts)
    return b1 ^ b2


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for
    each key of ``keys`` [S, 2]: float32 [S, n]."""
    bits = random_bits(keys, n)
    one = 0x3F800000                       # the bits of 1.0f
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    # scalars, not tensors: nothing is copied to the device inside a
    # graph capture.  The span is float32 arithmetic, as in JAX
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * span + lo, min=lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32, mode="low")`` for each key
    of ``keys`` [S, 2]: float32 [S, n]."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY_F32, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key_s, logits[s])`` for each row ``s``
    (float32 logits [S, V], -inf outside the support): int64 [S]."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)
