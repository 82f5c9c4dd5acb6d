"""The JAX mapper's spawn priority stream, reproduced in numpy.

The JAX ``Mapper`` draws its spawn-sampling priorities from
``jax.random``: ``PRNGKey(2024)`` split once per spawn call
(mapper.py:117,153), that key split into (k1, k2) (map_ops.py:438), one
``uniform([H*W])`` from each (map_ops.py:65).  JAX's generator is
Threefry-2x32 (20 rounds) in its "partitionable" layout, the default of the
JAX version this repository pins.  Replaying the same bits here lets a run
of the port sample exactly the pixels the JAX package samples, with no JAX
import — ``tests/test_torch_map_ops.py`` checks the bits against
``jax.random``.
"""

from __future__ import annotations

import numpy as np
import torch

_U = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 of the counter pairs (x1, x2) under key (k1, k2)."""
    ks = (_U(k1), _U(k2), _U(_U(k1) ^ _U(k2) ^ _U(0x1BD11BDA)))
    x0, x1 = x1.astype(_U), x2.astype(_U)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = (x1 << _U(r)) | (x1 >> _U(32 - r))
                x1 = x0 ^ x1
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U(i + 1)
    return x0, x1


def _bits(key, n: int):
    return threefry2x32(key[0], key[1], np.zeros(n, _U), np.arange(n, dtype=_U))


def split(key):
    """``jax.random.split(key)`` -> two keys."""
    b1, b2 = _bits(key, 2)
    return (b1[0], b2[0]), (b1[1], b2[1])


def uniform(key, n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,))`` in [0, 1), float32."""
    b1, b2 = _bits(key, n)
    mant = ((b1 ^ b2) >> _U(9)) | _U(0x3F800000)
    return np.maximum(np.float32(0.0), mant.view(np.float32) - np.float32(1.0))


def jax_priorities(seed: int = 2024):
    """A ``Mapper`` priority source replaying the JAX mapper's stream.  Draw
    ``i`` is the same whatever was drawn before, so one source serves a
    fresh ``Mapper`` per run, as the JAX package seeds one per run."""
    keys = [(_U(0), _U(seed))]        # keys[i]: the mapper's key before draw i

    def draw(spawn_index: int, n: int):
        while len(keys) <= spawn_index:
            keys.append(split(keys[-1])[0])
        k1, k2 = split(split(keys[spawn_index])[1])
        return torch.from_numpy(uniform(k1, n)), torch.from_numpy(uniform(k2, n))

    return draw
