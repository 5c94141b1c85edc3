"""Threefry-2x32 counter-based RNG in the ORIGINAL JAX layout, on torch.

This stands in for `jax.random` in the port. The reference's Monte Carlo
streams are defined by `jax.random` under the original (non-partitionable)
threefry layout, so reproducing them needs the same hash, the same
counter layout and the same bits->float transforms:

* a key is a pair of uint32 words; `key(seed)` is `[0, seed]`;
* `random_bits(key, (n,))` hashes the counter pairs `(i, i + m)` for
  `i < m = ceil(n / 2)`, with the odd pad slot hashed on 0, and returns
  `concat(o0, o1)[:n]` (`repro.core.mc.sampling._dynamic_bits` spells
  out the same layout);
* `split(key, num)` is `random_bits` over `2 * num` counters, reshaped
  `(num, 2)`; `fold_in(key, x)` hashes the single pair `(0, x)`;
* uniforms take the top 23 bits as a mantissa in [1, 2) and subtract 1;
  normals map the uniform into (-1, 1) and apply `sqrt(2) * erfinv`
  (`repro.core.mc.sampling._bits_to_u01` / `_u01_to_normal`).

uint32 values live in `int64` tensors and are masked back to 32 bits
after every add and shift, so the arithmetic is exact on every device.
Every function is batched over leading key axes: `key` is `(..., 2)` and
the draw comes out `(..., *shape)`, so one call draws for all
trajectories of a Monte Carlo step.

Bits and uniforms are bit-exact with `jax.random`. Normals go through
`erfinv_f32`, a copy of XLA's single-precision `erf_inv` (Giles'
polynomial) rather than `torch.special.erfinv`: the two approximations
differ by up to ~80 ulps (5e-6 relative) in the tails, while the copy
matches XLA to within 3 ulps (the remainder is `log1p` rounding).
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_ONE_BITS = int(np.float32(1.0).view(np.uint32))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
# Giles' erfinv coefficients as XLA's f32 erf_inv uses them, Horner order;
# row 0 serves w = -log1p(-x^2) >= 5 (the tails), row 1 w < 5
_ERFINV_COEFFS = (
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
)

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(s) for s in shape)


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple:
    """The Threefry-2x32 hash (20 rounds) on uint32 values held in int64
    tensors; all four operands broadcast. Returns the two hashed words."""
    k2 = k0 ^ k1 ^ _KS_PARITY
    ks = (k0, k1, k2)
    shape = torch.broadcast_shapes(k0.shape, k1.shape, x0.shape, x1.shape)
    # full-shape working copies, so every later update can run in place
    x0 = (x0 + k0).expand(shape).clone().bitwise_and_(MASK32)
    x1 = (x1 + k1).expand(shape).clone().bitwise_and_(MASK32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK32)
            x1 = (x1 << r).bitwise_and_(MASK32).bitwise_or_(x1 >> (32 - r))
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK32)
    return x0, x1


def key(seed, device=None) -> torch.Tensor:
    """`jax.random.key(seed)` key data: `[0, seed]` (uint32 words in
    int64). `seed` may be an int or an integer tensor of any shape; the
    result is `(*seed.shape, 2)`."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & MASK32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def _counter_bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """`(..., n)` uint32 bits of `random_bits(k, 32, (n,))` in the
    original layout: counter pairs (i, i + m), odd pad hashed on 0."""
    m = (n + 1) // 2
    i = torch.arange(m, dtype=torch.int64, device=k.device)
    x1 = i + m
    if n % 2:
        # a fill on a one-element slice: `x1[-1] = 0` copies a host scalar
        # into a 0-d view, which synchronizes with a CUDA device
        x1[-1:].fill_(0)
    o0, o1 = threefry2x32(k[..., 0:1], k[..., 1:2], i, x1)
    return torch.cat([o0, o1], dim=-1)[..., :n]


def dynamic_bits(k: torch.Tensor, size: torch.Tensor,
                 out_max: int) -> torch.Tensor:
    """Twin of `repro.core.mc.sampling._dynamic_bits`: `(B, out_max)`
    uint32 bits whose lanes [0, size[b]) equal `random_bits(k[b],
    (size[b],))`, the size being each trajectory's own as tensor DATA.

    k is `(B, 2)` and size a `(B,)` integer tensor (<= out_max). The
    counter pairs (j, j + m) with m = ceil(size / 2) and the odd pad slot
    hashed on 0 are built from the sizes on the device, so one program
    serves every size and nothing synchronizes with the host. Lanes past
    a trajectory's size hold other hashes; the caller masks them."""
    m_max = (out_max + 1) // 2
    size = size.to(torch.int64)[:, None]
    m = (size + 1) // 2
    i = torch.arange(m_max, dtype=torch.int64, device=k.device)
    x1 = torch.where(i + m < size, i + m, 0)
    o0, o1 = threefry2x32(k[:, 0:1], k[:, 1:2], i, x1)
    j = torch.arange(out_max, dtype=torch.int64, device=k.device)
    bits0 = o0[:, j.clamp(max=m_max - 1)]
    bits1 = torch.gather(o1, 1, (j - m).clamp(0, m_max - 1))
    return torch.where(j < m, bits0, bits1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(k, num)`: `(..., 2)` -> `(..., num, 2)`."""
    bits = _counter_bits(k, 2 * num)
    return bits.reshape(k.shape[:-1] + (num, 2))


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(k, data)`: the pair (0, data) hashed under k.

    `data` is a non-negative int, giving `(..., 2)`, or an integer tensor
    that broadcasts against `k[..., 0]`: one fold per entry, so
    `fold_in(k[:, None], torch.arange(n))` is `(B, n, 2)`."""
    if isinstance(data, torch.Tensor):
        x1 = data.to(device=k.device, dtype=torch.int64) & MASK32
        o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(x1),
                              x1)
        return torch.stack([o0, o1], dim=-1)
    x0 = torch.zeros((1,), dtype=torch.int64, device=k.device)
    x1 = torch.full((1,), int(data) & MASK32, dtype=torch.int64,
                    device=k.device)
    o0, o1 = threefry2x32(k[..., 0:1], k[..., 1:2], x0, x1)
    return torch.cat([o0, o1], dim=-1)


def random_bits(k: torch.Tensor, shape: Shape) -> torch.Tensor:
    """`jax.random.bits(k, shape)` (uint32 in int64): `(..., *shape)`."""
    shape = _shape(shape)
    n = math.prod(shape)
    return _counter_bits(k, n).reshape(k.shape[:-1] + shape)


def randint(k: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """`jax.random.randint(k, shape, minval, maxval)` for int32, bit for
    bit: `(..., *shape)` int64 values in [minval, maxval).

    As `jax._src.random._randint`: split k into (k1, k2), draw 32-bit
    `higher_bits` from k1 and `lower_bits` from k2, reduce both modulo the
    span and combine them with the multiplier (2^16 mod span)^2 mod span,
    all in uint32 arithmetic (here int64 masked to 32 bits)."""
    minval, maxval = int(minval), int(maxval)
    span = max(maxval - minval, 1)
    multiplier = ((2**16 % span) ** 2 & MASK32) % span
    ks = split(k)
    hi = random_bits(ks[..., 0, :], shape) % span
    lo = random_bits(ks[..., 1, :], shape) % span
    offset = ((hi * multiplier) & MASK32) + lo
    return minval + (offset & MASK32) % span


def bits_to_u01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 uniforms in [0, 1), as `jax.random` builds
    them: the top 23 bits become the mantissa of a float in [1, 2)."""
    fb = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def _as_f32(v):
    """A float32 tensor, or a Python float rounded to float32: scalars stay
    on the host, so a draw copies nothing to the device."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return float(np.float32(v))


def _f64(v):
    return v.double() if isinstance(v, torch.Tensor) else v


def _fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 `a * b + c` with one rounding, as XLA's contracted multiply-add:
    the f32 product is exact in f64. `b` and `c` are f32 tensors or
    f32-representable Python floats."""
    return (a.double() * _f64(b) + _f64(c)).float()


def u01_to_uniform(u01: torch.Tensor, minval, maxval) -> torch.Tensor:
    """[0, 1) -> [minval, maxval) with JAX's f32 arithmetic and clamp.
    `minval`/`maxval` are floats or tensors broadcasting against `u01`.

    XLA contracts `u01 * (hi - lo) + lo` into one fused multiply-add
    (one rounding). The f32 product is exact in f64, and for the ranges
    the engine draws from the f64 sum is exact too, so evaluating in f64
    and rounding once to f32 reproduces the fused result bit for bit."""
    lo, hi = _as_f32(minval), _as_f32(maxval)
    if isinstance(lo, float) and isinstance(hi, float):
        span = float(np.float32(hi) - np.float32(lo))  # the f32 difference
    else:
        span = hi - lo
    return torch.clamp(_fma_f32(u01, span, lo), min=lo)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 `erf_inv` for x in (-1, 1): w = -log1p(-x^2), a degree-8
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3 (tails), times x."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    arg = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    tail, body = _ERFINV_COEFFS
    p = torch.where(lt, body[0], tail[0])  # f32 coefficients, no copies
    for c_tail, c_body in zip(tail[1:], body[1:]):
        p = _fma_f32(p, arg, torch.where(lt, c_body, c_tail))
    return p * x


def u01_to_normal(u01: torch.Tensor) -> torch.Tensor:
    """[0, 1) -> standard normal via `sqrt(2) * erfinv(u)`, u in (-1, 1)."""
    u = u01_to_uniform(u01, _NORMAL_LO, 1.0)
    return _SQRT2_F32 * erfinv_f32(u)


def uniform(k: torch.Tensor, shape: Shape, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """`jax.random.uniform(k, shape, minval=, maxval=)` in float32."""
    return u01_to_uniform(bits_to_u01(random_bits(k, shape)), minval, maxval)


def normal(k: torch.Tensor, shape: Shape) -> torch.Tensor:
    """`jax.random.normal(k, shape)` in float32."""
    return u01_to_normal(bits_to_u01(random_bits(k, shape)))
