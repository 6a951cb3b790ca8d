"""Host-side RNG key derivation.

A numpy copy of ``nfisam_tpu/utils/keys.py``: keys are plain
``uint32[2]`` counters derived on the host, so the port hands out the same
sequence of clique keys as the JAX package.  Turning a key into draws
differs: the JAX package feeds it to threefry, the port seeds a
``torch.Generator`` with it (``torch_generator``, its seed from both
words of the key on every device: ``generator_seed``), so draws agree in
distribution and never bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK64 = 0xFFFFFFFFFFFFFFFF


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


def host_key(seed: int, counter: int = 0) -> np.ndarray:
    """One raw ``[counter, seed]`` key, made on the host."""
    return np.array([np.uint32(counter), np.uint32(seed & 0xFFFFFFFF)],
                    dtype=np.uint32)


def split_host(key, n: int = 2) -> np.ndarray:
    """Derive ``n`` independent raw keys from ``key`` with numpy
    arithmetic (the JAX package's stand-in for ``jax.random.split``)."""
    k = np.asarray(key).astype(np.uint64)
    i = np.arange(1, n + 1, dtype=np.uint64)
    lo = (k[1] + np.uint64(0x9E3779B9) * i) & np.uint64(0xFFFFFFFF)
    hi = (k[0] ^ (i * np.uint64(0x85EBCA6B))) & np.uint64(0xFFFFFFFF)
    return np.stack([hi, lo], axis=-1).astype(np.uint32)


def _mix64(x: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit words in which every
    output bit depends on every input bit."""
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def generator_seed(key, device_type: str) -> int:
    """The seed that ``torch_generator`` gives a generator of
    ``device_type`` for the raw ``[hi, lo]`` key.

    A card's Philox generator takes the 64-bit word ``hi << 32 | lo``
    whole.  The CPU's mt19937 keeps only the low 32 bits of its seed, so
    there the word is first mixed (``_mix64``) and its halves XORed:
    keys that differ in either word seed differently."""
    k = np.asarray(key).astype(np.uint64)
    word = (int(k[0]) << 32) | int(k[1])
    if device_type != "cpu":
        return word
    m = _mix64(word)
    return (m >> 32) ^ (m & 0xFFFFFFFF)


def torch_generator(key, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from a raw ``[hi, lo]``
    key (``generator_seed``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(generator_seed(key, device.type))
    return gen
