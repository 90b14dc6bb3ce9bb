"""The port's copy of the ``jax.random`` functions the device-resident
epoch needs, bit for bit: the Threefry-2x32 hash, ``PRNGKey``,
``fold_in``, ``split``, 32-bit ``random_bits`` and ``permutation``.

A key is a pair of Python ints ``(k1, k2)``, each in [0, 2^32): the two
uint32 words of a raw JAX key.  ``fold_in`` and ``split`` work on keys
on the host (a few scalar hashes, no device round trip); ``random_bits``
and ``permutation`` hash a counter per element on ``device`` (the card
or the CPU).  torch has only partial ``uint32`` support, so every word
is carried in ``int64`` and masked to its low 32 bits after each add
and shift.

The counter layout is JAX's ``jax_threefry_partitionable=True`` mode
(the default of the JAX the reference package runs on): ``split`` and
``random_bits`` hash the 64-bit iota split into a (high, low) word pair,
and 32-bit bits are the xor of the two output words.  ``permutation``
is ``jax.random.permutation(key, n)``'s ``_shuffle``:
``ceil(3 ln(max(1, n)) / ln(2^32 - 1))`` rounds, each a split and a
**stable** sort of the running order by fresh 32-bit keys (at n =
55,000 keys collide in most rounds; an unstable sort would order the
tied rows differently).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

MASK = 0xFFFFFFFF
Key = Tuple[int, int]
Word = Union[int, torch.Tensor]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: Word, r: int) -> Word:
    return ((v << r) & MASK) | (v >> (32 - r))


def threefry2x32(k1: int, k2: int, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0,
    x1)`` under the key ``(k1, k2)``: Python ints or int64 tensors
    holding uint32 values; returns the two output words the same way."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: ``(0, seed
    mod 2^32)``."""
    return (0, int(seed) & MASK)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``, ``data`` in [0, 2^32)."""
    data = int(data)
    if not 0 <= data <= MASK:
        raise OverflowError(f"fold_in data {data} is out of uint32 range")
    return threefry2x32(key[0], key[1], 0, data)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)``: the key hashes the counters
    ``(0, i)``; key ``i`` is the output pair of counter ``i``."""
    return tuple(threefry2x32(key[0], key[1], i >> 32, i & MASK)
                 for i in range(num))


def random_bits(key: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as an int64 tensor of
    values in [0, 2^32) on ``device``: counter ``i`` is hashed as the
    word pair ``(i >> 32, i & 0xFFFFFFFF)``, and the bits are the xor of
    the two output words."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], i >> 32, i & MASK)
    return b0 ^ b1


def shuffle_rounds(n: int) -> int:
    """The rounds ``jax.random.permutation`` sorts an n-element range
    in (the float64 formula of ``_shuffle``)."""
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK)))


def permutation(key: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as an int64 tensor on
    ``device``."""
    order = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(shuffle_rounds(n)):
        key, sub = split(key)
        bits = random_bits(sub, n, device)
        idx = torch.sort(bits, stable=True).indices
        order = order.index_select(0, idx)
    return order


__all__ = ["PRNGKey", "fold_in", "split", "random_bits", "permutation",
           "shuffle_rounds", "threefry2x32"]
