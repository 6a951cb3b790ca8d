"""Host-side RNG key derivation.

A numpy copy of ``nfisam_tpu/utils/keys.py``: keys are plain
``uint32[2]`` counters derived on the host, so the port hands out the same
sequence of clique keys as the JAX package.  Turning a key into draws
differs: the JAX package feeds it to threefry, the port seeds a
``torch.Generator`` with it (``torch_generator``), so draws agree in
distribution and never bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


class KeyStream:
    """Deterministic stream of raw key data, derived on host."""

    def __init__(self, seed: int) -> None:
        self._base = np.uint32(seed & 0xFFFFFFFF)
        self._hi = np.uint32((seed >> 32) & 0xFFFFFFFF)
        self._counter = 0

    def __call__(self) -> np.ndarray:
        self._counter += 1
        # mix the counter into both words so streams with different seeds
        # never collide on low counters
        lo = np.uint32((int(self._base) + 0x9E3779B9 * self._counter)
                       & 0xFFFFFFFF)
        hi = np.uint32((int(self._hi) ^ (self._counter * 0x85EBCA6B))
                       & 0xFFFFFFFF)
        return np.array([hi, lo], dtype=np.uint32)

    def next(self) -> np.ndarray:
        return self()


def split_host(key, n: int = 2) -> np.ndarray:
    """Derive ``n`` independent raw keys from ``key`` with numpy
    arithmetic (the JAX package's stand-in for ``jax.random.split``)."""
    k = np.asarray(key).astype(np.uint64)
    i = np.arange(1, n + 1, dtype=np.uint64)
    lo = (k[1] + np.uint64(0x9E3779B9) * i) & np.uint64(0xFFFFFFFF)
    hi = (k[0] ^ (i * np.uint64(0x85EBCA6B))) & np.uint64(0xFFFFFFFF)
    return np.stack([hi, lo], axis=-1).astype(np.uint32)


def torch_generator(key, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from a raw ``[hi, lo]``
    key (the 64-bit word ``hi << 32 | lo``)."""
    k = np.asarray(key).astype(np.uint64)
    seed = (int(k[0]) << 32) | int(k[1])
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return gen
