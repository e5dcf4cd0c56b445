"""Inverted dropout from a counter hash (port of raindrop_tpu/utils/dropout.py).

The mask bits are a hash of (seed, flat element index), not a draw from a
random stream, so the same seed gives the same mask on every device and in
both frameworks: the tests compare train-mode outputs with the JAX package
bit for bit. The JAX `dropout` derives its 32-bit seed from a threefry key;
the port takes that seed as an explicit integer and does not re-implement
`jax.random`.

The arithmetic runs in int64 masked to 32 bits (torch's uint32 lacks
arange, shifts and comparisons on some builds); a product of two values
below 2**32 wraps modulo 2**64, which leaves its low 32 bits right.

`DropoutSeeds` holds every seed one training forward consumes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for an int64 tensor x in [0, 2**32)."""
    return (x * c) & M32


def finalize32(x: torch.Tensor) -> torch.Tensor:
    """The xorshift-multiply finalizer both hashes end in (uint32 in int64)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _hash_bits(seed32: int, shape, device=None) -> torch.Tensor:
    """uint32 hash (held in int64) of (seed, flat row-major element index)."""
    size = 1
    for n in shape:
        size *= int(n)
    idx = torch.arange(size, dtype=torch.int64, device=device).reshape(tuple(shape))
    return finalize32(_mul32(idx, 0x9E3779B9) ^ (int(seed32) & M32))


def threshold32(rate: float) -> int:
    return int(rate * float(2 ** 32))


def dropout(seed32, x: torch.Tensor, rate: float, train: bool = True) -> torch.Tensor:
    """Zero elements with probability `rate` and scale the survivors by
    1/(1-rate), in training only. The flat index follows x's logical
    row-major order, so call it on the layout the JAX call site uses."""
    if not train or rate <= 0.0 or seed32 is None:
        return x
    keep = _hash_bits(seed32, x.shape, x.device) >= threshold32(rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout_rows(seeds, x: torch.Tensor, rate: float, train: bool = True) -> torch.Tensor:
    """`dropout` on each row of x [B, ...] with that row's own seed: row b
    hashes the flat index within x[b] with seeds[b]. This is what mapping
    `dropout` over a batch with one key per sample gives."""
    if not train or rate <= 0.0 or seeds is None:
        return x
    if len(seeds) != x.shape[0]:
        raise ValueError(f"{len(seeds)} seeds for {x.shape[0]} rows")
    size = x[0].numel()
    idx = torch.arange(size, dtype=torch.int64, device=x.device)
    s = torch.tensor([int(v) & M32 for v in seeds], dtype=torch.int64,
                     device=x.device)
    bits = finalize32(_mul32(idx, 0x9E3779B9)[None, :] ^ s[:, None])
    keep = (bits >= threshold32(rate)).reshape(x.shape)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


@dataclass(frozen=True)
class LayerSeeds:
    """Seeds of one encoder layer: `kernel` (int32, >= 0) feeds the flash
    and fused-layer kernels' masks; `attn` the dense attention dropout;
    `post_attn`, `ffn`, `post_ffn` the unfused layer's three sites."""
    kernel: int
    attn: int
    post_attn: int
    ffn: int
    post_ffn: int


@dataclass(frozen=True)
class DropoutSeeds:
    """Every seed one training forward consumes, mirroring the JAX key
    tree: the embedding dropout, the two propagation layers and, per
    encoder layer, a LayerSeeds. The COO propagation branch maps over the
    samples with one key each: `prop1_rows` and `prop2_rows` hold those
    per-sample seeds (empty unless asked for)."""
    embed: int
    prop1: int
    prop2: int
    layers: Tuple[LayerSeeds, ...]
    prop1_rows: Tuple[int, ...] = ()
    prop2_rows: Tuple[int, ...] = ()

    @staticmethod
    def draw(generator: torch.Generator, nlayers: int,
             rows: int = 0) -> "DropoutSeeds":
        """Fill every field from `generator` (a CPU generator draws
        without touching the card); `rows` > 0 also draws that many
        per-sample seeds for each propagation layer."""
        n = 3 + 5 * nlayers
        raw = torch.randint(0, 2 ** 32, (n + 2 * rows,), generator=generator,
                            dtype=torch.int64, device=generator.device).tolist()
        layers = tuple(
            LayerSeeds(raw[3 + 5 * i] % (2 ** 31 - 1), *raw[4 + 5 * i: 8 + 5 * i])
            for i in range(nlayers))
        return DropoutSeeds(raw[0], raw[1], raw[2], layers,
                            tuple(raw[n: n + rows]), tuple(raw[n + rows:]))
