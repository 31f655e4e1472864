"""Counter-based RNG stream derivation: threefry2x32 keys as torch tensors.

Counterpart of ``pigeons_tpu/rng.py``. Every random draw's key is a pure
function of ``(seed, round, scan, replica, purpose)`` through ``fold_in``, so
the streams do not depend on the device or the batch layout. The functions
reproduce ``jax.random`` (JAX 0.9, ``jax_threefry_partitionable=True``) bit
for bit: the same seed gives the same keys, bits and uniforms as the JAX
package, and the same normals.

A key is a ``[..., 2]`` tensor of uint32 words held as int64 (torch has no
full uint32 arithmetic); every operation masks back to 32 bits. Leading
dimensions batch keys, the way ``jax.vmap`` batches them in the reference.
Nothing here touches torch's global RNG.
"""

from __future__ import annotations

import math

import torch

from . import f32math

EXPLORE = 0
SWAP_UNIFORM = 1
IID = 2
INIT = 3

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds, on broadcastable int64
    tensors of uint32 words. Returns the two output words."""
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``: the words ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of every key in ``keys [..., 2]`` with ``data``
    (an int, or an integer tensor that broadcasts against ``keys[..., 0]``)."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), dtype=torch.int64, device=keys.device)
    data = data.to(torch.int64) & _M32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def bits(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` for every key: ``[..., *shape]``
    uint32 words as int64."""
    shape = tuple(shape)
    n = math.prod(shape)
    lead = keys.shape[:-1]
    k1 = keys[..., 0].reshape(lead + (1,) * len(shape))
    k2 = keys[..., 1].reshape(lead + (1,) * len(shape))
    lo = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(shape)
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return y0 ^ y1


def uniform(keys: torch.Tensor, shape=(), minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled into ``[minval, maxval)``."""
    b = bits(keys, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


_NORMAL_LO = f32math._f(0xBF7FFFFF)  # nextafter(-1, 0) in float32
_SQRT2 = math.sqrt(2.0)


def normal(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` with ``u``
    uniform on ``[nextafter(-1, 0), 1)``."""
    u = uniform(keys, shape, _NORMAL_LO, 1.0)
    return f32math.erfinv(u) * _SQRT2


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` for every key in ``keys [..., 2]``:
    ``[..., n, 2]``. With partitionable threefry, child ``i`` is
    ``fold_in(key, i)``."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    return fold_in(keys.unsqueeze(-2), idx)


def master_key(seed: int, device=None) -> torch.Tensor:
    return key(seed, device)


def scan_key(keys: torch.Tensor, round_idx, scan_idx, purpose: int) -> torch.Tensor:
    """Key for a (round, scan, purpose) triple; fold in the replica downstream."""
    k = fold_in(keys, round_idx)
    k = fold_in(k, scan_idx)
    return fold_in(k, purpose)


def replica_keys(keys: torch.Tensor, n_replicas: int) -> torch.Tensor:
    """One key per replica, ``[..., n_replicas, 2]``, derived by replica index."""
    idx = torch.arange(n_replicas, dtype=torch.int64, device=keys.device)
    return keys_for(keys, idx)


def keys_for(keys: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Keys ``[..., len(indices), 2]`` for explicit global replica indices."""
    return fold_in(keys.unsqueeze(-2), indices)
