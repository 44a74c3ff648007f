"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1, as vectorized u32-pair arithmetic.

Design note
-----------
Every field element is carried as a pair of ``uint32`` arrays ``(lo, hi)``
with value ``lo + 2^32 * hi``.  All ops are branch-free elementwise tensor
programs that run identically under ``numpy`` (host witness generation /
verifier) and ``jax.numpy`` (the jitted device prover).  Inside an op the
arithmetic runs either on native u64 lanes (the "u64 interior", the default
on the CPU and the GPU, see jaxcfg.FIELD_INTERIOR) or on the u32 pair itself,
for a backend without 64-bit integer lanes.  Reduction exploits the
Goldilocks identities

    2^64 ≡ 2^32 - 1 (mod p)        2^96 ≡ -1 (mod p)

so a 128-bit product folds to 64 bits with a handful of u32 adds.

This module is the equivalent of the external ``GoldilocksField`` consumed by
the reference crate (see SURVEY.md §2.9; the reference's prover substrate is the
plonky2 crate, not vendored).  Canonical representation is maintained: every
returned element is in [0, p).
"""

from __future__ import annotations

import numpy as np

# Wrap-around u32/u64 arithmetic is intentional throughout this module; numpy
# only warns for 0-d (scalar) operands, which appear in the host verifier.
np.seterr(over="ignore")

P = (1 << 64) - (1 << 32) + 1  # Goldilocks prime
P_LO = np.uint32(1)
P_HI = np.uint32(0xFFFFFFFF)
EPS = np.uint32(0xFFFFFFFF)  # 2^32 - 1 == 2^64 mod p

# Multiplicative group generator and 2-adic subgroup generator (two-adicity 32).
MULTIPLICATIVE_GROUP_GENERATOR = 7
TWO_ADICITY = 32
# pow(7, (P - 1) >> 32, P), computed once on host.
POWER_OF_TWO_GENERATOR = pow(7, (P - 1) >> 32, P)


def _xp(*arrays):
    """Pick numpy or jax.numpy based on array types (tracers -> jnp)."""
    for a in arrays:
        if not isinstance(a, (np.ndarray, np.generic, int)):
            import jax.numpy as jnp

            return jnp
    return np


# ---------------------------------------------------------------------------
# u64 interior
#
# The public representation is the u32 pair.  Where native uint64 lanes exist
# (numpy on the host; XLA:CPU and XLA:GPU under jax_enable_x64) the interior
# arithmetic runs on them, which cuts the primitive count of every field op
# 3-6x — and with it XLA compile time (the prover module is O(100k)
# primitives) and runtime.  The public API is unchanged: (lo, hi) u32 pairs
# in, (lo, hi) u32 pairs out.  Enable for JAX via enable_jax_u64() (requires
# jax_enable_x64; called by jaxcfg per platform, jaxcfg.FIELD_INTERIOR).
# ---------------------------------------------------------------------------

_JAX_U64 = False
_FORCE_U32 = None  # lazily read PLONKY2_FORCE_U32 (test/debug escape hatch)


def enable_jax_u64(on: bool = True):
    """Opt the jax.numpy path into u64 interior arithmetic.

    Caller must ensure jax.config.jax_enable_x64 is True first."""
    global _JAX_U64
    _JAX_U64 = on


def _use_u64(xp) -> bool:
    global _FORCE_U32
    if _FORCE_U32 is None:
        import os

        _FORCE_U32 = os.environ.get("PLONKY2_FORCE_U32") == "1"
    if _FORCE_U32:
        return False
    return xp is np or _JAX_U64


_M32 = np.uint64(0xFFFFFFFF)
_P64 = np.uint64(P)
_EPS64 = np.uint64(0xFFFFFFFF)


def _join64(xp, lo, hi):
    return lo.astype(xp.uint64) | (hi.astype(xp.uint64) << np.uint64(32))


def _split64(xp, v):
    return (v & _M32).astype(xp.uint32), (v >> np.uint64(32)).astype(xp.uint32)


def _add_u64(xp, a, b):
    """(a + b) mod p on u64 values in [0, p)."""
    s = a + b
    c = (s < a).astype(xp.uint64)
    s = s + c * _EPS64  # cannot re-wrap: s <= 2p-2-2^64+eps < 2^64-eps
    ge = (s >= _P64).astype(xp.uint64)
    return s - ge * _P64


def _sub_u64(xp, a, b):
    d = a - b
    brw = (a < b).astype(xp.uint64)
    return d - brw * _EPS64


def _mulhilo_u64(xp, a, b):
    """Full 64x64 -> (hi, lo) u64 product."""
    al = a & _M32
    ah = a >> np.uint64(32)
    bl = b & _M32
    bh = b >> np.uint64(32)
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = lh + (ll >> np.uint64(32))  # <= 2^64 - 2^33 + ... no wrap
    mid2 = hl + (mid & _M32)          # no wrap
    lo = (ll & _M32) | (mid2 << np.uint64(32))
    hi = hh + (mid >> np.uint64(32)) + (mid2 >> np.uint64(32))
    return hi, lo


def _reduce128_u64(xp, hi, lo):
    """(hi * 2^64 + lo) mod p via 2^64 ≡ 2^32 - 1, 2^96 ≡ -1."""
    r2 = hi & _M32
    r3 = hi >> np.uint64(32)
    t = lo - r3
    brw = (lo < r3).astype(xp.uint64)
    t = t - brw * _EPS64
    u = (r2 << np.uint64(32)) - r2
    s = t + u
    c = (s < t).astype(xp.uint64)
    s = s + c * _EPS64
    ge = (s >= _P64).astype(xp.uint64)
    return s - ge * _P64


def _mul_u64(xp, a, b):
    hi, lo = _mulhilo_u64(xp, a, b)
    return _reduce128_u64(xp, hi, lo)


def _u32(xp, x):
    return xp.asarray(x, dtype=xp.uint32)


# ---------------------------------------------------------------------------
# u32 / u64-pair primitive helpers
# ---------------------------------------------------------------------------

def addc32(a, b):
    """u32 a + b -> (sum, carry)."""
    s = a + b
    return s, (s < a).astype(np.uint32)


def subb32(a, b):
    """u32 a - b -> (diff, borrow)."""
    return a - b, (a < b).astype(np.uint32)


def mul32(a, b):
    """Full 32x32 -> 64 product as (lo, hi) u32 via 16-bit partials."""
    mask = np.uint32(0xFFFF)
    al, ah = a & mask, a >> 16
    bl, bh = b & mask, b >> 16
    ll = al * bl
    mid, midc = addc32(al * bh, ah * bl)
    hh = ah * bh
    lo, c = addc32(ll, (mid & mask) << 16)
    # hh + (mid >> 16) + (midc << 16) + c  -- proven to never wrap u32.
    hi = hh + (mid >> 16) + (midc << 16) + c
    return lo, hi


def add64(alo, ahi, blo, bhi):
    """u64 + u64 -> (lo, hi, carry_out)."""
    lo, c1 = addc32(alo, blo)
    hi1, c2 = addc32(ahi, bhi)
    hi, c3 = addc32(hi1, c1)
    return lo, hi, c2 + c3  # at most one of c2, c3 is set


def sub64(alo, ahi, blo, bhi):
    """u64 - u64 -> (lo, hi, borrow_out)."""
    lo, b1 = subb32(alo, blo)
    hi1, b2 = subb32(ahi, bhi)
    hi, b3 = subb32(hi1, b1)
    return lo, hi, b2 + b3


def geq64(alo, ahi, blo, bhi):
    """u64 a >= b as uint32 0/1."""
    gt = (ahi > bhi) | ((ahi == bhi) & (alo >= blo))
    return gt.astype(np.uint32)


def mul64(alo, ahi, blo, bhi):
    """Full 64x64 -> 128 product as four u32 (r0..r3, little-endian)."""
    p0l, p0h = mul32(alo, blo)
    p1l, p1h = mul32(alo, bhi)
    p2l, p2h = mul32(ahi, blo)
    p3l, p3h = mul32(ahi, bhi)
    r0 = p0l
    # r1 = p0h + p1l + p2l, carries into r2
    r1, c1 = addc32(p0h, p1l)
    r1, c2 = addc32(r1, p2l)
    # r2 = p1h + p2h + p3l + (c1 + c2), carries into r3
    r2, c3 = addc32(p1h, p2h)
    r2, c4 = addc32(r2, p3l)
    r2, c5 = addc32(r2, c1 + c2)
    r3 = p3h + c3 + c4 + c5  # cannot wrap: p3h <= 2^32 - 2^17 + 1
    return r0, r1, r2, r3


# ---------------------------------------------------------------------------
# Field ops (canonical in/out)
# ---------------------------------------------------------------------------

def canonicalize(lo, hi):
    """Subtract p once if value >= p (input < 2^64)."""
    xp = _xp(lo, hi)
    if _use_u64(xp):
        v = _join64(xp, lo, hi)
        ge = (v >= _P64).astype(xp.uint64)
        return _split64(xp, v - ge * _P64)
    ge = geq64(lo, hi, P_LO, P_HI)
    slo, shi, _ = sub64(lo, hi, ge * P_LO, ge * P_HI)
    return slo, shi


def add(alo, ahi, blo, bhi):
    """(a + b) mod p for canonical a, b."""
    xp = _xp(alo, ahi, blo, bhi)
    if _use_u64(xp):
        return _split64(xp, _add_u64(xp, _join64(xp, alo, ahi),
                                     _join64(xp, blo, bhi)))
    lo, hi, c = add64(alo, ahi, blo, bhi)
    # On carry the wrapped u64 is off by -2^64 ≡ -(2^32-1); add it back.
    lo, hi, _ = add64(lo, hi, c * EPS, c * np.uint32(0))
    return canonicalize(lo, hi)


def sub(alo, ahi, blo, bhi):
    """(a - b) mod p for canonical a, b."""
    xp = _xp(alo, ahi, blo, bhi)
    if _use_u64(xp):
        return _split64(xp, _sub_u64(xp, _join64(xp, alo, ahi),
                                     _join64(xp, blo, bhi)))
    lo, hi, brw = sub64(alo, ahi, blo, bhi)
    # On borrow the wrapped u64 is off by +2^64 ≡ +(2^32-1); take it off.
    lo, hi, _ = sub64(lo, hi, brw * EPS, brw * np.uint32(0))
    return lo, hi


def neg(alo, ahi):
    xp = _xp(alo, ahi)
    if _use_u64(xp):
        v = _join64(xp, alo, ahi)
        nz = (v != 0).astype(xp.uint64)
        return _split64(xp, nz * _P64 - v)
    nz = ((alo != 0) | (ahi != 0)).astype(np.uint32)
    lo, hi, _ = sub64(nz * P_LO, nz * P_HI, alo, ahi)
    return lo, hi


def reduce128(r0, r1, r2, r3):
    """Fold 128-bit (r0..r3) to canonical element via Goldilocks identities."""
    # t = (r0, r1) - r3  (borrow -> subtract EPS, can't re-borrow)
    tlo, thi, brw = sub64(r0, r1, r3, r3 * np.uint32(0))
    tlo, thi, _ = sub64(tlo, thi, brw * EPS, brw * np.uint32(0))
    # u = r2 * (2^32 - 1) = (r2 << 32) - r2
    z = np.uint32(0)
    ulo = z - r2
    uhi = r2 - (r2 != 0).astype(np.uint32)
    lo, hi, c = add64(tlo, thi, ulo, uhi)
    lo, hi, _ = add64(lo, hi, c * EPS, c * z)
    return canonicalize(lo, hi)


def mul(alo, ahi, blo, bhi):
    """(a * b) mod p, canonical."""
    xp = _xp(alo, ahi, blo, bhi)
    if _use_u64(xp):
        return _split64(xp, _mul_u64(xp, _join64(xp, alo, ahi),
                                     _join64(xp, blo, bhi)))
    return reduce128(*mul64(alo, ahi, blo, bhi))


def mul_small(alo, ahi, c):
    """a * c mod p with c a u32 scalar constant (cheap 96-bit fold)."""
    xp = _xp(alo, ahi)
    if _use_u64(xp):
        v = _join64(xp, alo, ahi)
        c64 = np.uint64(int(c))
        lo = v * c64
        # hi word of the product: (v >> 32) * c spills at most 32 bits
        hi = ((v >> np.uint64(32)) * c64 + ((v & _M32) * c64 >> np.uint64(32))) >> np.uint64(32)
        return _split64(xp, _reduce128_u64(xp, hi, lo))
    c = np.uint32(c)
    p0l, p0h = mul32(alo, c)
    p1l, p1h = mul32(ahi, c)
    r0 = p0l
    r1, cy = addc32(p0h, p1l)
    r2 = p1h + cy  # < 2^32, no wrap
    z = np.uint32(0)
    ulo = z - r2
    uhi = r2 - (r2 != 0).astype(np.uint32)
    lo, hi, cc = add64(r0, r1, ulo, uhi)
    lo, hi, _ = add64(lo, hi, cc * EPS, cc * z)
    return canonicalize(lo, hi)


def square(alo, ahi):
    return mul(alo, ahi, alo, ahi)


def pow_const(alo, ahi, e: int):
    """a^e for a Python-int exponent.

    numpy: unrolled square-and-multiply.  JAX (long exponents): a single
    lax.fori_loop over the exponent bits — an unrolled 64-bit Fermat ladder
    traces ~6k primitives per call site and bloats jit compile time."""
    xp = _xp(alo, ahi)
    nbits = e.bit_length()
    if xp is not np and nbits > 8:
        import jax
        import jax.numpy as jnp

        bits = jnp.asarray([(e >> i) & 1 for i in range(nbits)], dtype=jnp.uint32)

        def body(i, state):
            rlo, rhi, blo, bhi = state
            mlo, mhi = mul(rlo, rhi, blo, bhi)
            take = bits[i] != 0
            rlo = jnp.where(take, mlo, rlo)
            rhi = jnp.where(take, mhi, rhi)
            blo, bhi = square(blo, bhi)
            return (rlo, rhi, blo, bhi)

        rlo = xp.ones_like(alo)
        rhi = xp.zeros_like(ahi)
        rlo, rhi, _, _ = jax.lax.fori_loop(0, nbits, body, (rlo, rhi, alo, ahi))
        return rlo, rhi
    rlo, rhi = xp.ones_like(alo), xp.zeros_like(ahi)
    base = (alo, ahi)
    while e:
        if e & 1:
            rlo, rhi = mul(rlo, rhi, *base)
        e >>= 1
        if e:
            base = square(*base)
    return rlo, rhi


def inverse(alo, ahi):
    """a^(p-2); inverse of 0 is 0 (callers must guard)."""
    return pow_const(alo, ahi, P - 2)


def powers(alo, ahi, n: int):
    """[1, a, ..., a^(n-1)] along a NEW last axis (log-depth doubling)."""
    xp = _xp(alo, ahi)
    out = (xp.ones_like(alo)[..., None], xp.zeros_like(ahi)[..., None])
    p = (alo[..., None], ahi[..., None])  # a^(current length)
    while out[0].shape[-1] < n:
        nxt = mul(out[0], out[1], *p)
        out = (xp.concatenate([out[0], nxt[0]], -1),
               xp.concatenate([out[1], nxt[1]], -1))
        p = square(*p)
    return out[0][..., :n], out[1][..., :n]


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------

def from_int(x, shape=(), xp=np):
    """Scalar Python int (mod p) -> broadcast (lo, hi) pair."""
    x %= P
    lo = xp.full(shape, np.uint32(x & 0xFFFFFFFF), dtype=xp.uint32)
    hi = xp.full(shape, np.uint32(x >> 32), dtype=xp.uint32)
    return lo, hi


def from_u64(arr):
    """numpy uint64 array -> (lo, hi). Values must already be < p."""
    arr = np.asarray(arr, dtype=np.uint64)
    return (arr & np.uint64(0xFFFFFFFF)).astype(np.uint32), (arr >> np.uint64(32)).astype(np.uint32)


def to_u64(lo, hi):
    """(lo, hi) -> numpy uint64 array (host only)."""
    return np.asarray(lo, dtype=np.uint64) | (np.asarray(hi, dtype=np.uint64) << np.uint64(32))


def from_ints(values, xp=np):
    """List/array of Python ints -> (lo, hi)."""
    vals = [int(v) % P for v in np.ravel(np.asarray(values, dtype=object))]
    lo = np.array([v & 0xFFFFFFFF for v in vals], dtype=np.uint32).reshape(np.shape(values))
    hi = np.array([v >> 32 for v in vals], dtype=np.uint32).reshape(np.shape(values))
    if xp is not np:
        lo, hi = xp.asarray(lo), xp.asarray(hi)
    return lo, hi


def to_ints(lo, hi):
    """(lo, hi) -> nested list of Python ints (host only)."""
    return (np.asarray(lo, dtype=np.uint64) | (np.asarray(hi, dtype=np.uint64) << np.uint64(32))).tolist()


# ---------------------------------------------------------------------------
# Quadratic extension GF(p^2) = GF(p)[x] / (x^2 - 7)
# ---------------------------------------------------------------------------

W_EXT = 7  # non-residue defining the extension
# Generator of the extension field's multiplicative group is not needed for FRI;
# DTH_ROOT = g^((p-1)/2) used for Frobenius if recursion lands later.


def ext_add(a, b):
    """a, b: tuples ((lo0,hi0),(lo1,hi1))."""
    return (add(*a[0], *b[0]), add(*a[1], *b[1]))


def ext_sub(a, b):
    return (sub(*a[0], *b[0]), sub(*a[1], *b[1]))


def ext_neg(a):
    return (neg(*a[0]), neg(*a[1]))


def ext_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t00 = mul(*a0, *b0)
    t11 = mul(*a1, *b1)
    t01 = mul(*a0, *b1)
    t10 = mul(*a1, *b0)
    c0 = add(*t00, *mul_small(*t11, W_EXT))
    c1 = add(*t01, *t10)
    return (c0, c1)


def ext_scalar_mul(a, s):
    """Extension element times base-field element s=(lo,hi)."""
    return (mul(*a[0], *s), mul(*a[1], *s))


def ext_square(a):
    return ext_mul(a, a)


def ext_inverse(a):
    """(a0 + a1 x)^-1 = (a0 - a1 x) / (a0^2 - 7 a1^2)."""
    a0, a1 = a
    n = sub(*square(*a0), *mul_small(*square(*a1), W_EXT))
    ninv = inverse(*n)
    return (mul(*a0, *ninv), mul(*neg(*a1), *ninv))


def ext_pow_const(a, e: int):
    xp = _xp(a[0][0])
    one = (xp.ones_like(a[0][0]), xp.zeros_like(a[0][1]))
    zero = (xp.zeros_like(a[0][0]), xp.zeros_like(a[0][1]))
    r = (one, zero)
    base = a
    while e:
        if e & 1:
            r = ext_mul(r, base)
        e >>= 1
        if e:
            base = ext_square(base)
    return r


def ext_from_base(lo, hi):
    xp = _xp(lo, hi)
    return ((lo, hi), (xp.zeros_like(lo), xp.zeros_like(hi)))
