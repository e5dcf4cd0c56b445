"""Inverted dropout from a counter hash (port of raindrop_tpu/utils/dropout.py).

The mask bits are a hash of (seed, flat element index), not a draw from a
random stream, so the same seed gives the same mask on every device and in
both frameworks: the tests compare train-mode outputs with the JAX package
bit for bit. The JAX `dropout` derives its 32-bit seed from a threefry key;
the port takes that seed as an explicit integer and does not re-implement
`jax.random`.

A rank that holds one block of a larger tensor (a shard of the batch or
of the heads, parallel/mesh.py) passes the block's `origin` and the full
tensor's `full_shape`: each element then hashes its index in the full
tensor, so the shards together draw the full tensor's mask. The index is
not one offset away from the local one (the model's tensors are T-major,
so a batch shard is strided in the flat index); each axis adds its own
term.

The arithmetic runs in int64 masked to 32 bits (torch's uint32 lacks
arange, shifts and comparisons on some builds); a product of two values
below 2**32 wraps modulo 2**64, which leaves its low 32 bits right.

`DropoutSeeds` holds every seed one training forward of the flagship
consumes, `ModelSeeds` those of a baseline family's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

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


def flat_index(shape, device=None, origin=None, full_shape=None) -> torch.Tensor:
    """int64 [shape]: each element's row-major index in a tensor of
    `full_shape` when the block `shape` sits at `origin` in it (by
    default the block is the whole tensor), mod 2**32."""
    shape = tuple(int(n) for n in shape)
    size = 1
    for n in shape:
        size *= n
    if origin is None:
        return torch.arange(size, dtype=torch.int64, device=device).reshape(shape) & M32
    if full_shape is None or not len(origin) == len(full_shape) == len(shape):
        raise ValueError(f"origin {origin} and full_shape {full_shape} must "
                         f"each have one entry per axis of {shape}")
    for n, o, N in zip(shape, origin, full_shape):
        if int(o) < 0 or int(o) + n > int(N):
            raise ValueError(f"block {shape} at {tuple(origin)} leaves {tuple(full_shape)}")
    if tuple(int(N) for N in full_shape[1:]) == shape[1:] and not any(origin[1:]):
        # whole rows of axis 0 (a batch-major shard): one offset
        start = int(origin[0]) * (size // shape[0]) if shape[0] else 0
        return (torch.arange(start, start + size, dtype=torch.int64, device=device)
                .reshape(shape) & M32)
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for axis in reversed(range(len(shape))):
        n, o, N = shape[axis], int(origin[axis]), int(full_shape[axis])
        view = [1] * len(shape)
        view[axis] = n
        pos = torch.arange(o, o + n, dtype=torch.int64, device=device)
        idx = idx + (pos * stride).reshape(view)
        stride *= N
    return idx.expand(shape) & M32


def _hash_bits(seed32: int, shape, device=None, origin=None,
               full_shape=None) -> torch.Tensor:
    """uint32 hash (held in int64) of (seed, flat row-major element index),
    the index in `full_shape` of a block at `origin` when given."""
    idx = flat_index(shape, device, origin, full_shape)
    return finalize32(_mul32(idx, 0x9E3779B9) ^ (int(seed32) & M32))


def threshold32(rate: float) -> int:
    return int(rate * float(2 ** 32))


def dropout(seed32, x: torch.Tensor, rate: float, train: bool = True,
            origin=None, full_shape=None) -> torch.Tensor:
    """Zero elements with probability `rate` and scale the survivors by
    1/(1-rate), in training only. The flat index follows x's logical
    row-major order, so call it on the layout the JAX call site uses. x a
    block of a larger tensor: `origin` its place in it, `full_shape` the
    larger tensor's shape (the mask is then that tensor's, cut to x)."""
    if not train or rate <= 0.0 or seed32 is None:
        return x
    keep = (_hash_bits(seed32, x.shape, x.device, origin, full_shape)
            >= threshold32(rate))
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def batch_block(rows, shape):
    """(origin, full_shape) of a batch-major block of `shape` that holds
    rows b0 .. of a global batch of `batch` rows, rows = (b0, batch);
    (None, None) for rows None (the block is the whole batch)."""
    if rows is None:
        return None, None
    b0, batch = rows
    return (b0,) + (0,) * (len(shape) - 1), (batch,) + tuple(shape[1:])


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
    per-sample seeds (empty unless asked for). `beta` holds the two seeds
    of the dense use_beta block (its layer-1 and layer-2 softmax weights,
    which the JAX package draws from a key split off the first propagation
    layer's), empty unless asked for. `pipeline` holds, under the GPipe
    route (parallel/pipeline.py), one LayerSeeds per microbatch and stage,
    `pipeline[m][s]` (the JAX package's fold_in(fold_in(key, m), s) split
    in 4), empty unless asked for."""
    embed: int
    prop1: int
    prop2: int
    layers: Tuple[LayerSeeds, ...]
    prop1_rows: Tuple[int, ...] = ()
    prop2_rows: Tuple[int, ...] = ()
    beta: Tuple[int, ...] = ()
    pipeline: Tuple[Tuple[LayerSeeds, ...], ...] = ()

    @staticmethod
    def draw(generator: torch.Generator, nlayers: int,
             rows: int = 0, beta: bool = False, pipeline: int = 0) -> "DropoutSeeds":
        """Fill every field from `generator` (a CPU generator draws
        without touching the card); `rows` > 0 also draws that many
        per-sample seeds for each propagation layer, `beta` the two seeds
        of the dense use_beta block, `pipeline` > 0 that many microbatches'
        LayerSeeds a stage (each drawn after the ones before it, so a draw
        without them is what it was)."""
        n = 3 + 5 * nlayers
        raw = torch.randint(0, 2 ** 32, (n + 2 * rows,), generator=generator,
                            dtype=torch.int64, device=generator.device).tolist()
        layers = tuple(
            LayerSeeds(raw[3 + 5 * i] % (2 ** 31 - 1), *raw[4 + 5 * i: 8 + 5 * i])
            for i in range(nlayers))
        pair = (tuple(torch.randint(0, 2 ** 32, (2,), generator=generator,
                                    dtype=torch.int64,
                                    device=generator.device).tolist())
                if beta else ())
        stages = ()
        if pipeline:
            more = torch.randint(0, 2 ** 32, (5 * pipeline * nlayers,),
                                 generator=generator, dtype=torch.int64,
                                 device=generator.device).tolist()
            stages = tuple(
                tuple(LayerSeeds(more[j] % (2 ** 31 - 1), *more[j + 1:j + 5])
                      for j in range(5 * nlayers * m, 5 * nlayers * (m + 1), 5))
                for m in range(pipeline))
        return DropoutSeeds(raw[0], raw[1], raw[2], layers,
                            tuple(raw[n: n + rows]), tuple(raw[n + rows:]), pair,
                            stages)


@dataclass(frozen=True)
class ModelSeeds:
    """Every seed one training forward of a baseline family consumes
    (baselines/adapters.py), mirroring that family's JAX key tree: `embed`
    the input dropout, `layers` one LayerSeeds per encoder layer, `steps`
    one seed per recurrence step (GRU-D) or per layer (MTGNN's
    fold_in(r_drop, i)), `graph_noise` MTGNN's train-mode U[0, 1) draw
    [N, N] (the JAX package draws it with `jax.random.uniform`, which no
    hash reproduces, so it travels as a tensor). A family reads the fields
    it has."""
    embed: int = 0
    layers: Tuple[LayerSeeds, ...] = ()
    steps: Tuple[int, ...] = ()
    graph_noise: Optional[torch.Tensor] = None

    @staticmethod
    def draw(generator: torch.Generator, nlayers: int = 0, steps: int = 0,
             noise_shape: Optional[Tuple[int, ...]] = None) -> "ModelSeeds":
        """Fill `embed`, `nlayers` LayerSeeds and `steps` step seeds from
        `generator`, and with `noise_shape` a U[0, 1) draw of that shape on
        the generator's device."""
        n = 1 + 5 * nlayers
        raw = torch.randint(0, 2 ** 32, (n + steps,), generator=generator,
                            dtype=torch.int64, device=generator.device).tolist()
        layers = tuple(
            LayerSeeds(raw[1 + 5 * i] % (2 ** 31 - 1), *raw[2 + 5 * i: 6 + 5 * i])
            for i in range(nlayers))
        noise = (None if noise_shape is None else
                 torch.rand(tuple(noise_shape), generator=generator,
                            device=generator.device))
        return ModelSeeds(raw[0], layers, tuple(raw[n:]), noise)
