"""Property tests for the limb-tensor bigint engine vs Python ints."""

import numpy as np
import pytest

from plonky2_ecdsa.fields import limbs as lb

SECP_P = 2**256 - 2**32 - 977
SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


def rand_ints(rng, n, bits):
    out = [int.from_bytes(rng.bytes(bits // 8 + 1), "little") % (1 << bits) for _ in range(n)]
    out += [0, 1, (1 << bits) - 1, 1 << (bits - 1)]
    return out


def test_roundtrip(rng):
    vals = rand_ints(rng, 50, 256)
    L = lb.num_limbs(256)
    x = lb.from_ints(vals, L)
    back = lb.to_ints(x)
    assert [int(v) for v in back] == vals


def test_add_sub_mul(rng):
    a = rand_ints(rng, 64, 256)
    b = rand_ints(rng, 64, 256)
    L = lb.num_limbs(256)
    A, B = lb.from_ints(a, L), lb.from_ints(b, L)
    s = lb.to_ints(lb.add(A, B))
    assert all(int(x) == u + v for x, u, v in zip(s, a, b))
    p = lb.to_ints(lb.mul(A, B))
    assert all(int(x) == u * v for x, u, v in zip(p, a, b))
    d, borrow = lb.sub(A, B)
    di = lb.to_ints(d)
    for x, brw, u, v in zip(di, borrow, a, b):
        if u >= v:
            assert brw == 0 and int(x) == u - v
        else:
            assert brw == 1 and int(x) == u - v + (1 << (16 * L))


def test_cmp(rng):
    a = rand_ints(rng, 40, 256)
    b = rand_ints(rng, 40, 256)
    # force some equalities
    b[:5] = a[:5]
    L = lb.num_limbs(256)
    A, B = lb.from_ints(a, L), lb.from_ints(b, L)
    assert [int(x) for x in lb.lt(A, B)] == [int(u < v) for u, v in zip(a, b)]
    assert [int(x) for x in lb.le(A, B)] == [int(u <= v) for u, v in zip(a, b)]
    assert [int(x) for x in lb.eq(A, B)] == [int(u == v) for u, v in zip(a, b)]


@pytest.mark.parametrize("fb,tb", [(16, 29), (29, 16), (16, 32), (32, 29), (29, 2), (29, 4)])
def test_convert(rng, fb, tb):
    vals = rand_ints(rng, 30, 261)
    Lin = lb.num_limbs(261, fb)
    Lout = lb.num_limbs(261, tb)
    x = lb.from_ints(vals, Lin, fb)
    y = lb.convert(x, fb, tb, Lout)
    back = lb.to_ints(y, tb)
    assert [int(v) for v in back] == vals
    # limbs bounded
    assert np.all(np.asarray(y) < (1 << tb))


@pytest.mark.parametrize("m", [SECP_P, SECP_N, 2**255 - 19, 97, 1 << 64])
def test_barrett_divmod(rng, m):
    mod = lb.Modulus(m)
    xs = rand_ints(rng, 40, 2 * 261)
    xs += [m - 1, m, m + 1, 3 * m, m * m if m.bit_length() <= 261 else m]
    xs = [x % (1 << mod.max_x_bits) for x in xs]
    X = lb.from_ints(xs, mod.Lx)
    q, r = mod.divmod(X)
    qi, ri = lb.to_ints(q), lb.to_ints(r)
    for x, qq, rr in zip(xs, qi, ri):
        assert int(qq) == x // m, (x, m)
        assert int(rr) == x % m


def test_mod_ops(rng):
    mod = lb.Modulus(SECP_P)
    a = [x % SECP_P for x in rand_ints(rng, 30, 256)]
    b = [x % SECP_P for x in rand_ints(rng, 30, 256)]
    A, B = lb.from_ints(a, mod.L), lb.from_ints(b, mod.L)
    q, r = mod.mod_mul(A, B)
    ri = lb.to_ints(r)
    qi = lb.to_ints(q)
    for u, v, rr, qq in zip(a, b, ri, qi):
        assert int(rr) == (u * v) % SECP_P
        assert int(qq) == (u * v) // SECP_P
    s, _ = mod.mod_add(A, B)
    assert all(int(x) == (u + v) % SECP_P for x, u, v in zip(lb.to_ints(s), a, b))
    d, _ = mod.mod_sub(A, B)
    assert all(int(x) == (u - v) % SECP_P for x, u, v in zip(lb.to_ints(d), a, b))
    n = mod.mod_neg(A)
    assert all(int(x) == (-u) % SECP_P for x, u in zip(lb.to_ints(n), a))
    inv, div = mod.mod_inv(A)
    for u, iv in zip(a, lb.to_ints(inv)):
        if u % SECP_P:
            assert (u * int(iv)) % SECP_P == 1
        else:
            assert int(iv) == 0


def test_pow_mod(rng):
    mod = lb.Modulus(SECP_N)
    a = [x % SECP_N for x in rand_ints(rng, 5, 256)]
    A = lb.from_ints(a, mod.L)
    e = 0x1234567
    got = lb.to_ints(mod.pow_mod(A, e))
    assert all(int(x) == pow(u, e, SECP_N) for x, u in zip(got, a))


def test_jax_mul_matches(rng):
    import jax
    import jax.numpy as jnp

    a = rand_ints(rng, 16, 256)
    b = rand_ints(rng, 16, 256)
    L = lb.num_limbs(256)
    A, B = lb.from_ints(a, L), lb.from_ints(b, L)
    jf = jax.jit(lambda x, y: lb.mul(x, y))
    got = np.asarray(jf(jnp.asarray(A), jnp.asarray(B)))
    assert np.array_equal(got, lb.mul(A, B))
