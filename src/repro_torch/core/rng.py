"""Threefry-2x32 counter-based RNG in the ORIGINAL JAX layout, and JAX's
rbg keys, on torch.

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

The rbg key (`key(seed, impl="rbg")`, JAX's `impl='rbg'`) is four
uint32 words; every function tells the kinds apart by the key's last
dimension (2 or 4), as JAX's typed keys carry their implementation:

* `key(seed)` is the threefry key twice, `[0, seed, 0, seed]`;
* `split` and `fold_in` are threefry's on each half `(w0, w1)`,
  `(w2, w3)` (JAX's `_rbg_split`, `_rbg_fold_in`), in the original
  layout;
* `random_bits` is XLA's `RngBitGenerator` as the CPU backend computes
  it: Philox-4x32-10 keyed by `(w0, w1)` over the 128-bit counter whose
  words, lowest first, are `(w2, w3, w0, w1)`, plus j for the j-th block
  of four outputs (with carries). 8- and 16-bit draws are the low bits
  of the same 32-bit outputs, one output an element. A batch of rbg
  keys draws as JAX's vmap of the draw does: one stream of
  `batch x shape` outputs from the FIRST key of the batch
  (`lax.rng_bit_generator`'s batching rule). XLA picks the generator per
  platform, so the reference draws other bits on a TPU; these are its
  CPU bits.

The unsafe_rbg key (`key(seed, impl="unsafe_rbg")`, JAX's
`impl='unsafe_rbg'`) has rbg's four words and rbg's bits, but splits
and folds through the generator itself (JAX's `_unsafe_rbg_split`,
`_unsafe_rbg_fold_in`):

* `key(seed)` is rbg's, `[0, seed, 0, seed]`;
* `split(k, num)` takes every 10th row of the (10·num, 4) draw of k:
  key j is outputs [40j, 40j + 4) of k's stream;
* `fold_in(k, d)` is k XOR outputs [36, 40) (the last row of a (10, 4)
  draw) of the stream of `key(d)`;
* a batch of keys splits, and a batch of data folds, from one stream of
  the batch's first key or datum, as JAX's vmap does.

Its width cannot tell it from rbg, so its key data is an `UnsafeRbgKey`:
a tensor subclass, which indexing, reshapes, `.to`, `clone` and stacking
keep, as JAX's typed keys carry their implementation.

Everything downstream of the bits (uniforms, normals in f32 and bf16)
is the same for every kind.

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
# bf16 constants of JAX's bf16 normal: 1.0's bits, nextafter(-1, 0) and
# sqrt(2), each exactly representable in bf16
_BF16_ONE_BITS = 0x3F80
_BF16_NORMAL_LO = -(1.0 - 2.0**-8)
_BF16_NORMAL_SPAN = 2.0  # 1 - lo = 1.99609375, rounded to bf16
_SQRT2_BF16 = 1.4140625
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

# counter pairs per key an f32 normal draw hashes in one pass
# (`_normal_f32`): 2^25 normals a key, far above any of the Monte Carlo
# engine's draws, at the width of a model's parameters
NORMAL_PASS = 1 << 24

# the key kinds by their width in uint32 words
KEY_WIDTHS = {"threefry2x32": 2, "rbg": 4, "unsafe_rbg": 4}
# unsafe_rbg's split and fold_in: each key a row of every 10 of a draw
_UNSAFE_ROWS = 10
# Philox-4x32's multipliers and Weyl key increments (Salmon et al. 2011)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_PHILOX_ROUNDS = 10


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


class UnsafeRbgKey(torch.Tensor):
    """Key data of JAX's unsafe_rbg keys: rbg's four words, of another
    kind. Every function of this module reads the kind from the class
    and computes on plain tensors (`_plain`)."""


def _plain(k: torch.Tensor) -> torch.Tensor:
    return k.as_subclass(torch.Tensor)


def is_unsafe_rbg(k: torch.Tensor) -> bool:
    return isinstance(k, UnsafeRbgKey)


def key(seed, device=None, impl: str = "threefry2x32") -> torch.Tensor:
    """`jax.random.key(seed, impl=impl)` key data (uint32 words in
    int64): threefry's `[0, seed]`, or rbg's and unsafe_rbg's `[0, seed,
    0, seed]` (JAX's `_rbg_seed`: the threefry key twice; unsafe_rbg's
    an `UnsafeRbgKey`). `seed` may be an int or an integer tensor of any
    shape; the result is `(*seed.shape, width)`."""
    if impl not in KEY_WIDTHS:
        raise ValueError(f"impl must be one of {tuple(KEY_WIDTHS)}, got "
                         f"{impl!r}")
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & MASK32
    half = torch.stack([torch.zeros_like(s), s], dim=-1)
    if impl == "threefry2x32":
        return half
    k = torch.cat([half, half], -1)
    return k.as_subclass(UnsafeRbgKey) if impl == "unsafe_rbg" else k


def is_rbg(k: torch.Tensor) -> bool:
    """Whether `k` holds rbg keys (4 words) rather than threefry's (2)."""
    if k.shape[-1] not in (2, 4):
        raise ValueError(f"key data ends in 2 (threefry) or 4 (rbg) words, "
                         f"got shape {tuple(k.shape)}")
    return k.shape[-1] == 4


def _halves(k: torch.Tensor) -> torch.Tensor:
    """rbg keys `(..., 4)` as their two threefry halves `(..., 2, 2)`."""
    return k.reshape(k.shape[:-1] + (2, 2))


def _add32(a: torch.Tensor, b) -> tuple:
    """(a + b) mod 2^32 and its carry, for uint32 values in int64."""
    t = a + b
    return t & MASK32, t >> 32


def _philox_stream(k: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Outputs [start, start + n) of XLA's CPU `RngBitGenerator` stream
    of the ONE rbg key `k (4,)`: Philox-4x32-10 keyed by (w0, w1), block
    j from the 128-bit counter (w2, w3, w0, w1) + j (lowest word first),
    its four words the outputs 4j .. 4j + 3. `start` is a multiple of 4.
    The 32 x 32 products wrap in int64; their low 64 bits are exact."""
    k = _plain(k)
    j = torch.arange(start // 4, start // 4 + (n + 3) // 4,
                     dtype=torch.int64, device=k.device)
    w = [k[i:i + 1] for i in range(4)]
    x0, c = _add32(w[2], j)
    x1, c = _add32(w[3], c)
    x2, c = _add32(w[0], c)
    x3, _ = _add32(w[1], c)
    k0, k1 = w[0], w[1]
    for r in range(_PHILOX_ROUNDS):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & MASK32
            k1 = (k1 + _PHILOX_W[1]) & MASK32
        p0, p1 = x0 * _PHILOX_M[0], x2 * _PHILOX_M[1]
        x0, x1, x2, x3 = (((p1 >> 32) & MASK32) ^ x1 ^ k0, p1 & MASK32,
                          ((p0 >> 32) & MASK32) ^ x3 ^ k1, p0 & MASK32)
    return torch.stack([x0, x1, x2, x3], dim=-1).reshape(-1)[:n]


def _rbg_bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """`(..., n)` uint32 outputs of rbg keys `k (..., 4)`: one stream of
    batch x n outputs from the first key (JAX's vmap of the draw)."""
    batch = k.shape[:-1]
    first = k.reshape(-1, 4)[0]
    return _philox_stream(first, 0, math.prod(batch) * n).reshape(
        batch + (n,))


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
    a trajectory's size hold other hashes; the caller masks them.
    Threefry keys only (the engine's)."""
    if is_rbg(k):
        raise ValueError("dynamic_bits replays threefry's layout; rbg keys "
                         "draw through random_bits")
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


def _unsafe_rows(first: torch.Tensor, batch: tuple, num: int,
                 row: int) -> torch.Tensor:
    """`(*batch, num, 4)`: row `row` of every _UNSAFE_ROWS of the
    `(prod(batch) · num · _UNSAFE_ROWS, 4)` draw of the one key
    `first (4,)` (JAX's vmap of `rng_bit_generator` draws a batch from
    its first key)."""
    n = math.prod(batch) * num * _UNSAFE_ROWS
    rows = _philox_stream(first, 0, 4 * n).reshape(-1, _UNSAFE_ROWS, 4)
    return rows[:, row].reshape(batch + (num, 4))


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(k, num)`: `(..., w)` -> `(..., num, w)`; an rbg
    key's halves are split apart and key j joins their j-th keys; an
    unsafe_rbg key's j-th key is row 10j of its own draw."""
    if is_unsafe_rbg(k):
        kp = _plain(k)
        keys = _unsafe_rows(kp.reshape(-1, 4)[0], kp.shape[:-1], num, 0)
        return keys.as_subclass(UnsafeRbgKey)
    if is_rbg(k):
        halves = split(_halves(k), num)  # (..., 2, num, 2)
        return halves.transpose(-3, -2).reshape(k.shape[:-1] + (num, 4))
    bits = _counter_bits(k, 2 * num)
    return bits.reshape(k.shape[:-1] + (num, 2))


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(k, data)`: the pair (0, data) hashed under k.

    `data` is a non-negative int, giving `(..., 2)`, or an integer tensor
    that broadcasts against `k[..., 0]`: one fold per entry, so
    `fold_in(k[:, None], torch.arange(n))` is `(B, n, 2)`. An rbg key
    folds each half: `(..., 4)`; an unsafe_rbg key is XORed with row 9
    of the (10, 4) draw of `key(data)`, a tensor of data drawing all its
    rows from its first datum's key."""
    if is_unsafe_rbg(k):
        kp = _plain(k)
        if isinstance(data, torch.Tensor):
            d = data.to(device=kp.device, dtype=torch.int64) & MASK32
            batch = tuple(d.shape)
            first = d.reshape(-1)[:1]
        else:
            batch = ()
            first = torch.full((1,), int(data) & MASK32, dtype=torch.int64,
                               device=kp.device)
        zero = torch.zeros_like(first)
        seed_key = torch.cat([zero, first, zero, first])
        bits = _unsafe_rows(seed_key, batch, 1, _UNSAFE_ROWS - 1)
        return (kp ^ bits[..., 0, :]).as_subclass(UnsafeRbgKey)
    if is_rbg(k):
        if isinstance(data, torch.Tensor):
            data = data[..., None]  # against the halves' axis
        folded = fold_in(_halves(k), data)
        return folded.reshape(folded.shape[:-2] + (4,))
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


def random_bits(k: torch.Tensor, shape: Shape,
                width: int = 32) -> torch.Tensor:
    """`jax.random.bits(k, shape, uint<width>)` in int64: `(..., *shape)`.
    Threefry keys draw 32 bits; rbg keys 8, 16 or 32 (the low bits of
    their 32-bit outputs)."""
    shape = _shape(shape)
    n = math.prod(shape)
    if is_rbg(k):
        if width not in (8, 16, 32):
            raise ValueError(f"rbg bits are 8, 16 or 32 wide, got {width}")
        bits = _rbg_bits(k, n)
        if width < 32:
            bits = bits & ((1 << width) - 1)
        return bits.reshape(k.shape[:-1] + shape)
    if width != 32:
        raise ValueError(f"threefry bits are 32 wide here, got {width}")
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


def _bf16_normal(k: torch.Tensor, shape: tuple) -> torch.Tensor:
    """`jax.random.normal(k, shape, dtype=bfloat16)`, bit for bit.

    JAX draws a bf16 uniform from 8 random bits an element (bf16 has 7
    mantissa bits, fewer than 8): the `ceil(n / 4)` words of
    `random_bits` split into their bytes, low byte first. The byte
    shifted right by 1 is the mantissa of a bf16 in [1, 2); minus 1,
    times (1 - lo) and plus lo, all in bf16, gives u in [lo, 1) with lo =
    nextafter(-1, 0) in bf16 (-0.99609375; the span rounds to 2). XLA's
    erf_inv takes bf16 through f32 and rounds back, and the product with
    sqrt(2) rounds again in bf16: 128 values in all. An rbg key's 8-bit
    draw is the low byte of one 32-bit output an element."""
    n = math.prod(shape)
    if is_rbg(k):
        byte = random_bits(k, (n,), width=8)
    else:
        words = _counter_bits(k, (n + 3) // 4)
        shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=k.device)
        byte = ((words[..., None] >> shifts) & 0xFF).flatten(-2)[..., :n]
    fb = ((byte >> 1) | _BF16_ONE_BITS).to(torch.int16).view(torch.bfloat16)
    # each step exact in bf16, as JAX's bf16 ops round it
    u = ((fb - 1.0) * _BF16_NORMAL_SPAN + _BF16_NORMAL_LO).clamp_min(
        _BF16_NORMAL_LO)
    e = erfinv_f32(u.to(torch.float32)).to(torch.bfloat16)
    return (e * _SQRT2_BF16).reshape(k.shape[:-1] + shape)


def _normal_f32(k: torch.Tensor, shape: tuple) -> torch.Tensor:
    """`jax.random.normal(k, shape)` in float32, `NORMAL_PASS` counter
    pairs at a time: each pass hashes its counters (i, i + m), as
    `_counter_bits` does, and turns the two words of each pair into the
    normals at positions i and i + m. The chain from hash to normal holds
    ~47 bytes an element while it runs, so a whole-model draw (the
    transport's edge noise of N·D elements) would need tens of GB at
    once; in passes it needs the output and one pass's scratch. A draw of
    one pass (every draw of the Monte Carlo engine) is the one chain of
    `random_bits`, returned as it is. rbg keys: `_normal_rbg`."""
    if is_rbg(k):
        return _normal_rbg(k, shape)
    n = math.prod(shape)
    m = (n + 1) // 2
    batch = k.shape[:-1]
    out = None
    for c0 in range(0, max(m, 1), NORMAL_PASS):  # n = 0: one empty pass
        c1 = min(c0 + NORMAL_PASS, m)
        i = torch.arange(c0, c1, dtype=torch.int64, device=k.device)
        x1 = i + m
        if n % 2 and c1 == m:
            # the odd pad slot, as in `_counter_bits`
            x1[-1:].fill_(0)
        o0, o1 = threefry2x32(k[..., 0:1], k[..., 1:2], i, x1)
        hi = min(m + c1, n)  # the second words' last position + 1
        z = u01_to_normal(bits_to_u01(torch.cat(
            [o0, o1[..., :hi - m - c0]], dim=-1)))
        if c1 - c0 == m:  # one pass: z is the whole draw
            return z.reshape(batch + shape)
        if out is None:
            out = torch.empty(batch + (n,), dtype=torch.float32,
                              device=k.device)
        out[..., c0:c1] = z[..., :c1 - c0]
        out[..., m + c0:hi] = z[..., c1 - c0:]
    return out.reshape(batch + shape)


def _normal_rbg(k: torch.Tensor, shape: tuple) -> torch.Tensor:
    """`jax.random.normal(k, shape)` in float32 for rbg keys `(..., 4)`:
    the first key's stream of batch x n outputs (`_rbg_bits`), turned
    into normals 2 * NORMAL_PASS outputs at a time, as `_normal_f32`
    bounds its scratch."""
    batch = k.shape[:-1]
    total = math.prod(batch) * math.prod(shape)
    first = k.reshape(-1, 4)[0]
    step = 2 * NORMAL_PASS
    if total <= step:
        z = u01_to_normal(bits_to_u01(_philox_stream(first, 0, total)))
        return z.reshape(batch + shape)
    out = torch.empty((total,), dtype=torch.float32, device=k.device)
    for c0 in range(0, total, step):
        c1 = min(c0 + step, total)
        out[c0:c1] = u01_to_normal(bits_to_u01(
            _philox_stream(first, c0, c1 - c0)))
    return out.reshape(batch + shape)


def normal(k: torch.Tensor, shape: Shape,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`jax.random.normal(k, shape, dtype)`: float32 (`_normal_f32`), or
    bfloat16 bit for bit through JAX's 8-bit path (`_bf16_normal`), not
    the f32 normal rounded down."""
    shape = _shape(shape)
    if dtype == torch.bfloat16:
        return _bf16_normal(k, shape)
    if dtype != torch.float32:
        raise ValueError(f"normal draws float32 or bfloat16, got {dtype}")
    return _normal_f32(k, shape)
