"""Bit-exact tests for the u32-pair Goldilocks field vs Python-int ground truth."""

import numpy as np
import pytest

from plonky2_ecdsa.fields import goldilocks as gl

P = gl.P


def rand_elems(rng, n):
    """Random canonical elements including structured edge cases."""
    edge = [0, 1, 2, P - 1, P - 2, 0xFFFFFFFF, 1 << 32, (1 << 32) - 2,
            P - (1 << 32), (1 << 63), P - 0xFFFFFFFF]
    vals = [int(x) % P for x in rng.integers(0, 1 << 64, size=n, dtype=np.uint64)]
    vals = [v % P for v in vals] + edge
    return np.array(vals, dtype=np.uint64) % np.uint64(P)


def test_roundtrip(rng):
    a = rand_elems(rng, 100)
    lo, hi = gl.from_u64(a)
    assert np.array_equal(gl.to_u64(lo, hi), a)


@pytest.mark.parametrize("op,pyop", [
    (gl.add, lambda x, y: (x + y) % P),
    (gl.sub, lambda x, y: (x - y) % P),
    (gl.mul, lambda x, y: (x * y) % P),
])
def test_binary_ops(rng, op, pyop):
    a = rand_elems(rng, 200)
    b = rand_elems(rng, 200)
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    # also test all edge x edge pairs
    am, bm = np.meshgrid(a[-11:], b[-11:])
    a = np.concatenate([a, am.ravel()])
    b = np.concatenate([b, bm.ravel()])
    got = gl.to_u64(*op(*gl.from_u64(a), *gl.from_u64(b)))
    want = np.array([pyop(int(x), int(y)) for x, y in zip(a, b)], dtype=np.uint64)
    assert np.array_equal(got, want)


def test_neg(rng):
    a = rand_elems(rng, 100)
    got = gl.to_u64(*gl.neg(*gl.from_u64(a)))
    want = np.array([(-int(x)) % P for x in a], dtype=np.uint64)
    assert np.array_equal(got, want)


def test_mul_small(rng):
    a = rand_elems(rng, 100)
    for c in [0, 1, 7, 0xFFFFFFFF, 12345]:
        got = gl.to_u64(*gl.mul_small(*gl.from_u64(a), np.uint32(c)))
        want = np.array([(int(x) * c) % P for x in a], dtype=np.uint64)
        assert np.array_equal(got, want), f"c={c}"


def test_inverse(rng):
    a = rand_elems(rng, 50)
    a = a[a != 0]
    inv = gl.to_u64(*gl.inverse(*gl.from_u64(a)))
    for x, ix in zip(a, inv):
        assert (int(x) * int(ix)) % P == 1


def test_pow_const(rng):
    a = rand_elems(rng, 20)
    for e in [0, 1, 2, 5, 1 << 31, P - 2]:
        got = gl.to_u64(*gl.pow_const(*gl.from_u64(a), e))
        want = np.array([pow(int(x), e, P) for x in a], dtype=np.uint64)
        assert np.array_equal(got, want), f"e={e}"


def test_two_adic_generator():
    g = gl.POWER_OF_TWO_GENERATOR
    assert pow(g, 1 << 32, P) == 1
    assert pow(g, 1 << 31, P) == P - 1  # exact order 2^32


def test_w_ext_is_nonresidue():
    assert pow(gl.W_EXT, (P - 1) // 2, P) == P - 1


def _ext_to_ints(x):
    return (gl.to_ints(*x[0]), gl.to_ints(*x[1]))


def test_ext_mul_vs_int(rng):
    a0, a1, b0, b1 = (rand_elems(rng, 40) for _ in range(4))
    n = len(a0)
    A = (gl.from_u64(a0), gl.from_u64(a1))
    B = (gl.from_u64(b0), gl.from_u64(b1))
    C = gl.ext_mul(A, B)
    c0 = gl.to_u64(*C[0]).astype(object)
    c1 = gl.to_u64(*C[1]).astype(object)
    for i in range(n):
        x0, x1, y0, y1 = int(a0[i]), int(a1[i]), int(b0[i]), int(b1[i])
        assert int(c0[i]) == (x0 * y0 + 7 * x1 * y1) % P
        assert int(c1[i]) == (x0 * y1 + x1 * y0) % P


def test_ext_inverse(rng):
    a0, a1 = rand_elems(rng, 30), rand_elems(rng, 30)
    A = (gl.from_u64(a0), gl.from_u64(a1))
    Inv = gl.ext_inverse(A)
    Prod = gl.ext_mul(A, Inv)
    p0 = gl.to_u64(*Prod[0])
    p1 = gl.to_u64(*Prod[1])
    nz = (a0 != 0) | (a1 != 0)
    assert np.all(p0[nz] == 1)
    assert np.all(p1[nz] == 0)


def test_jax_backend_matches_numpy(rng):
    import jax
    import jax.numpy as jnp

    a = rand_elems(rng, 64)
    b = rand_elems(rng, 64)
    alo, ahi = gl.from_u64(a)
    blo, bhi = gl.from_u64(b)

    @jax.jit
    def f(alo, ahi, blo, bhi):
        m = gl.mul(alo, ahi, blo, bhi)
        s = gl.add(*m, blo, bhi)
        return gl.sub(*s, alo, ahi)

    jlo, jhi = f(jnp.asarray(alo), jnp.asarray(ahi), jnp.asarray(blo), jnp.asarray(bhi))
    m = gl.mul(alo, ahi, blo, bhi)
    s = gl.add(*m, blo, bhi)
    nlo, nhi = gl.sub(*s, alo, ahi)
    assert np.array_equal(np.asarray(jlo), nlo)
    assert np.array_equal(np.asarray(jhi), nhi)
