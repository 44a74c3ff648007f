"""Vectorized multi-precision integer arithmetic on limb tensors.

The witness/"UX" substrate of this build (SURVEY.md §2.10): the reference's
`plonky2_ux` bounded-int gadgets and `num::BigUint` host math become elementwise
tensor programs over little-endian limb arrays.

Two limb widths coexist:
  * 16-bit limbs in uint32 containers — internal witness math.  Products of two
    limbs fit in u32, and convolution accumulation splits partial products into
    lo/hi 16-bit halves so sums of hundreds of terms stay below 2^32 (32-bit
    lanes suffice; nothing here needs u64).
  * 29-bit limbs — the circuit wire format (reference `BITS = 29`,
    src/gadgets/nonnative.rs:32); produced via `convert` just before values are
    scattered into the witness matrix.

`convert` mirrors the semantics of the reference's `convert_base`
(src/gadgets/biguint.rs:27-51) but is shape-static and vectorized.

All functions work under numpy (host witness engine) and jax.numpy.
"""

from __future__ import annotations

import numpy as np

BITS = 16
MASK = np.uint32(0xFFFF)


def _xp(*arrays):
    for a in arrays:
        if not isinstance(a, (np.ndarray, np.generic, int)):
            import jax.numpy as jnp

            return jnp
    return np


# ---------------------------------------------------------------------------
# Conversions (host helpers use Python ints; exact at any size)
# ---------------------------------------------------------------------------

def num_limbs(bit_len: int, bits: int = BITS) -> int:
    return -(-bit_len // bits)


def from_int(v: int, L: int, bits: int = BITS, shape=(), xp=np):
    """Python int -> broadcast limb tensor of shape (*shape, L)."""
    assert v >= 0 and v < 1 << (bits * L), (v, L, bits)
    limbs = [(v >> (bits * i)) & ((1 << bits) - 1) for i in range(L)]
    arr = xp.asarray(np.array(limbs, dtype=np.uint32))
    return xp.broadcast_to(arr, tuple(shape) + (L,))


def from_ints(vals, L: int, bits: int = BITS):
    """Iterable of Python ints -> [N, L] uint32 numpy array."""
    out = np.zeros((len(vals), L), dtype=np.uint32)
    m = (1 << bits) - 1
    for i, v in enumerate(vals):
        assert 0 <= v < 1 << (bits * L)
        for j in range(L):
            out[i, j] = (v >> (bits * j)) & m
    return out


def to_ints(x, bits: int = BITS):
    """[..., L] limb tensor -> nested list of Python ints (host only)."""
    x = np.asarray(x)
    flat = x.reshape(-1, x.shape[-1])
    res = [sum(int(l) << (bits * j) for j, l in enumerate(row)) for row in flat]
    out = np.empty(len(res), dtype=object)
    out[:] = res
    return out.reshape(x.shape[:-1])


# ---------------------------------------------------------------------------
# Core ops (16-bit limbs unless noted)
# ---------------------------------------------------------------------------

def normalize(x, bits: int = BITS, iters: int | None = None):
    """Propagate multi-bit carries; x limbs may hold values up to 2^32-1.

    Under numpy loops until fixpoint; under jit runs a static number of
    iterations (limb count) which is always sufficient for carries < 2^bits.
    """
    xp = _xp(x)
    L = x.shape[-1]
    if xp is np:
        while True:
            carry = x >> bits
            if not carry.any():
                return x
            assert not carry[..., -1].any(), "normalize overflow in top limb"
            x = (x & np.uint32((1 << bits) - 1)) + np.concatenate(
                [np.zeros_like(carry[..., :1]), carry[..., :-1]], axis=-1
            )
    n = iters if iters is not None else L
    m = xp.asarray(np.uint32((1 << bits) - 1))
    for _ in range(n):
        carry = x >> bits
        x = (x & m) + xp.concatenate([xp.zeros_like(carry[..., :1]), carry[..., :-1]], axis=-1)
    return x


def add(a, b, bits: int = BITS):
    """a + b -> limb tensor of length max(La, Lb) + 1 (no truncation)."""
    xp = _xp(a, b)
    La, Lb = a.shape[-1], b.shape[-1]
    L = max(La, Lb) + 1
    pa = xp.concatenate([a, xp.zeros(a.shape[:-1] + (L - La,), dtype=xp.uint32)], axis=-1)
    pb = xp.concatenate([b, xp.zeros(b.shape[:-1] + (L - Lb,), dtype=xp.uint32)], axis=-1)
    return normalize(pa + pb, bits)


def sub(a, b, bits: int = BITS):
    """a - b limbwise with borrow chain; returns (diff, borrow_out 0/1).

    a and b must have equal limb count; diff is the wrapped (mod 2^(bits*L))
    result when b > a.
    """
    xp = _xp(a, b)
    assert a.shape[-1] == b.shape[-1], (a.shape, b.shape)
    L = a.shape[-1]
    base = np.uint32(1 << bits)
    outs = []
    borrow = xp.zeros(np.broadcast_shapes(a.shape[:-1], b.shape[:-1]), dtype=xp.uint32)
    for i in range(L):
        d = base + a[..., i] - b[..., i] - borrow
        outs.append(d & np.uint32((1 << bits) - 1))
        borrow = (d < base).astype(xp.uint32)
    return xp.stack(outs, axis=-1), borrow


def lt(a, b, bits: int = BITS):
    """a < b as uint32 0/1 (lexicographic, equal lengths padded)."""
    xp = _xp(a, b)
    La, Lb = a.shape[-1], b.shape[-1]
    L = max(La, Lb)
    if La < L:
        a = xp.concatenate([a, xp.zeros(a.shape[:-1] + (L - La,), dtype=xp.uint32)], axis=-1)
    if Lb < L:
        b = xp.concatenate([b, xp.zeros(b.shape[:-1] + (L - Lb,), dtype=xp.uint32)], axis=-1)
    _, borrow = sub(a, b, bits)
    return borrow


def le(a, b, bits: int = BITS):
    return np.uint32(1) - lt(b, a, bits)


def eq(a, b):
    xp = _xp(a, b)
    La, Lb = a.shape[-1], b.shape[-1]
    L = max(La, Lb)
    if La < L:
        a = xp.concatenate([a, xp.zeros(a.shape[:-1] + (L - La,), dtype=xp.uint32)], axis=-1)
    if Lb < L:
        b = xp.concatenate([b, xp.zeros(b.shape[:-1] + (L - Lb,), dtype=xp.uint32)], axis=-1)
    return xp.all(a == b, axis=-1).astype(xp.uint32)


def is_zero(a):
    xp = _xp(a)
    return xp.all(a == 0, axis=-1).astype(xp.uint32)


def select(cond, a, b):
    """cond ? a : b, cond shape broadcastable to limb tensors' batch shape."""
    xp = _xp(cond, a, b)
    return xp.where(cond[..., None].astype(bool), a, b)


def mul_bool(a, cond):
    xp = _xp(a, cond)
    return a * cond[..., None].astype(xp.uint32)


def mul(a, b, bits: int = BITS):
    """Schoolbook product -> [., La+Lb] limbs, u32-safe accumulation.

    Requires bits <= 16 so limb products fit u32; partial products are split
    into lo/hi halves accumulated separately (each term < 2^bits, so up to
    2^(32-bits) terms are safe — far above any size used here).
    """
    assert bits <= 16
    xp = _xp(a, b)
    La, Lb = a.shape[-1], b.shape[-1]
    L = La + Lb
    shape = np.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    acc_lo = xp.zeros(shape + (L,), dtype=xp.uint32)
    acc_hi = xp.zeros(shape + (L,), dtype=xp.uint32)
    m = np.uint32((1 << bits) - 1)
    for i in range(La):
        p = a[..., i : i + 1] * b  # [..., Lb], each < 2^(2*bits)
        lo, hi = p & m, p >> bits
        if xp is np:
            acc_lo[..., i : i + Lb] += lo
            acc_hi[..., i : i + Lb] += hi
        else:
            acc_lo = acc_lo.at[..., i : i + Lb].add(lo)
            acc_hi = acc_hi.at[..., i : i + Lb].add(hi)
    # limb k total = acc_lo[k] + acc_hi[k-1]
    shifted = xp.concatenate([xp.zeros_like(acc_hi[..., :1]), acc_hi[..., :-1]], axis=-1)
    return normalize(acc_lo + shifted, bits)


def resize(a, L: int):
    """Pad with zero limbs or truncate (caller asserts truncation is safe)."""
    xp = _xp(a)
    La = a.shape[-1]
    if La == L:
        return a
    if La < L:
        return xp.concatenate([a, xp.zeros(a.shape[:-1] + (L - La,), dtype=xp.uint32)], axis=-1)
    return a[..., :L]


# ---------------------------------------------------------------------------
# Base conversion (static codegen per (from_bits, to_bits, shapes))
# ---------------------------------------------------------------------------

def convert(x, from_bits: int, to_bits: int, Lout: int):
    """Repack limb widths, e.g. 16 <-> 29 bits. Exact; masks before shifting
    so no intermediate exceeds u32. Mirrors reference convert_base semantics
    (src/gadgets/biguint.rs:27-51) with a fixed output length."""
    xp = _xp(x)
    Lin = x.shape[-1]
    mask_to = (1 << to_bits) - 1
    outs = []
    for j in range(Lout):
        start = to_bits * j
        a = start // from_bits
        s = start - from_bits * a
        acc = None
        t = 0
        while from_bits * t - s < to_bits:
            idx = a + t
            shift = from_bits * t - s
            if idx < Lin:
                xi = x[..., idx]
                if shift < 0:
                    term = xi >> (-shift)
                else:
                    pre = (mask_to >> shift) & ((1 << from_bits) - 1)
                    term = (xi & np.uint32(pre)) << shift
                acc = term if acc is None else acc | term
            t += 1
        if acc is None:
            acc = xp.zeros(x.shape[:-1], dtype=xp.uint32)
        outs.append(acc & np.uint32(mask_to))
    return xp.stack(outs, axis=-1)


# ---------------------------------------------------------------------------
# Barrett reduction by a constant modulus
# ---------------------------------------------------------------------------

class Modulus:
    """Precomputed constants for exact division/reduction by a fixed modulus.

    Provides the witness-side equivalents of the reference hint generators:
    BigUintDivRemGenerator (src/gadgets/biguint.rs:483-548) and the q,r hints of
    MulNonnativeGenerator (src/gates/mul_nonnative.rs:249-324), vectorized.
    """

    def __init__(self, m: int, name: str = "", max_x_bits: int | None = None):
        assert m > 1
        self.m = m
        self.name = name
        self.bit_len = m.bit_length()
        self.L = num_limbs(self.bit_len)  # 16-bit limbs of m
        # Default x bound: product of two 9x29-bit values (522 bits) with slack.
        self.max_x_bits = max_x_bits or (2 * 9 * 29 + 16)
        self.Lx = num_limbs(self.max_x_bits)
        self.S = BITS * self.Lx
        self.mu = (1 << self.S) // m
        self.Lmu = num_limbs(self.mu.bit_length())
        self.m_limbs = from_int(m, self.L)
        self.mu_limbs = from_int(self.mu, self.Lmu)
        self.Lq = self.Lx - self.L + 1

    def divmod(self, x):
        """x: [..., <=Lx] limbs -> (q [..., Lq], r [..., L]) with x = q*m + r,
        0 <= r < m. Exact for any x < 2^max_x_bits."""
        xp = _xp(x)
        assert x.shape[-1] <= self.Lx, (x.shape, self.Lx)
        x = resize(x, self.Lx)
        mu = xp.asarray(self.mu_limbs)
        ml = xp.asarray(self.m_limbs)
        prod = mul(x, mu)  # [..., Lx + Lmu]
        qhat = prod[..., self.Lx :]  # floor(x*mu / 2^S); q - qhat in {0,1,2}
        qhat = resize(qhat, self.Lq)
        qm = resize(mul(qhat, ml), self.Lx + 1)
        r_full, borrow = sub(resize(x, self.Lx + 1), qm)
        # r < 3m, fits in L+1 limbs
        r = resize(r_full, self.L + 1)
        q = qhat
        one = from_int(1, self.Lq, xp=xp)
        mpad = resize(ml, self.L + 1)
        for _ in range(2):
            ge = np.uint32(1) - lt(r, mpad)
            r2, _ = sub(r, mul_bool(mpad, ge))
            r = r2
            q = resize(add(q, mul_bool(one, ge)), self.Lq)
        return q, resize(r, self.L)

    def mod_mul(self, a, b):
        """(a*b) mod m with the quotient hint: returns (q, r)."""
        return self.divmod(mul(a, b))

    def mod_add(self, a, b):
        """(a+b) mod m -> (r, overflow 0/1); a, b must be < m."""
        xp = _xp(a, b)
        s = add(resize(a, self.L), resize(b, self.L))
        mpad = xp.asarray(resize(self.m_limbs, self.L + 1))
        ge = np.uint32(1) - lt(s, mpad)
        r, _ = sub(s, mul_bool(mpad, ge))
        return resize(r, self.L), ge

    def mod_sub(self, a, b):
        """(a-b) mod m -> (r, underflow 0/1); a, b must be < m."""
        xp = _xp(a, b)
        d, borrow = sub(resize(a, self.L), resize(b, self.L))
        r = resize(add(d, mul_bool(xp.asarray(self.m_limbs), borrow)), self.L)
        return r, borrow

    def mod_neg(self, a):
        nz = np.uint32(1) - is_zero(a)
        d, _ = sub(mul_bool(self.m_limbs, nz), resize(a, self.L))
        return d

    def mod_inv(self, a):
        """Modular inverse (host numpy path: exact Python pow per element).

        inverse of 0 -> 0. Returns (inv, div) with a*inv = div*m + (a!=0)."""
        ints = to_ints(a)
        flat = np.ravel(ints)
        inv = [pow(int(v), -1, self.m) if int(v) % self.m != 0 else 0 for v in flat]
        inv_arr = from_ints(inv, self.L).reshape(np.shape(ints) + (self.L,))
        prods = mul(resize(a, self.L), inv_arr)
        q, r = self.divmod(prods)
        return inv_arr, q

    def pow_mod(self, a, e: int):
        """a^e mod m (square-and-multiply over mod_mul)."""
        xp = _xp(a)
        r = from_int(1, self.L, shape=a.shape[:-1], xp=xp)
        base = resize(a, self.L)
        while e:
            if e & 1:
                _, r = self.mod_mul(r, base)
            e >>= 1
            if e:
                _, base = self.mod_mul(base, base)
        return r
