"""Tests for the native EC/ECDSA oracle layer (parity with reference L1 tests:
secp256k1.rs:40-100, p256.rs:65-120, glv.rs:104-142, curve_summation.rs:191-238,
curve_msm.rs:188-265, ecdsa.rs:64-84)."""

import numpy as np
import pytest

from plonky2_ecdsa.curve import native as cn
from plonky2_ecdsa.hash.keccak import keccak256


def rand_scalar(rng, curve):
    return int.from_bytes(rng.bytes(40), "little") % curve.n


@pytest.mark.parametrize("curve", [cn.SECP256K1, cn.P256], ids=lambda c: c.name)
def test_generator_valid(curve):
    g = curve.generator()
    assert g.is_valid()
    assert (-g).is_valid()
    assert curve.is_safe_curve()


@pytest.mark.parametrize("curve", [cn.SECP256K1, cn.P256], ids=lambda c: c.name)
def test_naive_multiplication(curve):
    g = curve.generator()
    ten = cn.scalar_mul(g, 10)
    acc = curve.zero()
    for _ in range(10):
        acc = acc + g
    assert ten == acc
    # n*G = zero
    assert cn.scalar_mul(g, curve.n).zero


@pytest.mark.parametrize("curve", [cn.SECP256K1, cn.P256], ids=lambda c: c.name)
def test_yao_mul_matches_naive(rng, curve):
    g = curve.generator()
    table = cn.mul_precompute(g)
    for _ in range(3):
        k = rand_scalar(rng, curve)
        assert cn.mul_with_precomputation(table, k) == cn.scalar_mul(g, k)


def test_msm_matches(rng):
    c = cn.SECP256K1
    g = c.generator()
    p = cn.scalar_mul(g, rand_scalar(rng, c))
    q = cn.scalar_mul(g, rand_scalar(rng, c))
    n1, n2 = rand_scalar(rng, c), rand_scalar(rng, c)
    want = cn.scalar_mul(p, n1) + cn.scalar_mul(q, n2)
    assert cn.msm([n1, n2], [p, q], 5) == want


def test_batch_summation(rng):
    c = cn.SECP256K1
    g = c.generator()
    pts = [cn.scalar_mul(g, rand_scalar(rng, c)) for _ in range(9)]
    pts.append(c.zero())
    pts.append(-pts[0])  # force a cancelling pair
    want = c.zero()
    for p in pts:
        want = want + p
    assert cn.affine_summation_batch_inversion(pts) == want


def test_multisummation_best_cutoff(rng):
    """The pairwise/batch-inversion dispatch (curve_summation.rs:29-40 cutoff
    at 70) agrees with the naive sum on both sides of the cutoff."""
    c = cn.SECP256K1
    g = c.generator()
    for k in (3, cn.PAIRWISE_SUM_CUTOFF + 5):
        pts = [cn.scalar_mul(g, rand_scalar(rng, c)) for _ in range(k)]
        want = c.zero()
        for p in pts:
            want = want + p
        assert cn.affine_multisummation_best(pts) == want
        assert cn.affine_summation_pairwise(pts) == want


def test_glv_constants():
    c = cn.SECP256K1
    # beta is a primitive cube root of unity in the base field
    assert pow(cn.GLV_BETA, 3, c.p) == 1 and cn.GLV_BETA != 1
    # s (lambda) is a primitive cube root of unity in the scalar field
    assert pow(cn.GLV_S, 3, c.n) == 1 and cn.GLV_S != 1
    # endomorphism: psi(G) = s*G
    g = c.generator()
    psi_g = cn.Point(c, g.x * cn.GLV_BETA % c.p, g.y)
    assert cn.scalar_mul(g, cn.GLV_S) == psi_g


def test_glv_decompose(rng):
    n = cn.SECP256K1.n
    for _ in range(10):
        k = rand_scalar(rng, cn.SECP256K1)
        k1, k2, k1n, k2n = cn.decompose_secp256k1_scalar(k)
        m1 = -1 if k1n else 1
        m2 = -1 if k2n else 1
        assert (m1 * k1 + cn.GLV_S * m2 * k2) % n == k
        assert k1 < 1 << 129 and k2 < 1 << 129  # |ki| < ~sqrt(n)


def test_glv_mul(rng):
    c = cn.SECP256K1
    g = c.generator()
    for _ in range(3):
        k = rand_scalar(rng, c)
        p = cn.scalar_mul(g, rand_scalar(rng, c))
        assert cn.glv_mul(p, k) == cn.scalar_mul(p, k)


@pytest.mark.parametrize("curve", [cn.SECP256K1, cn.P256], ids=lambda c: c.name)
def test_ecdsa_native_roundtrip(rng, curve):
    msg = rand_scalar(rng, curve)
    sk, pk = cn.keygen(curve, rand_scalar(rng, curve))
    r, s = cn.sign_message(curve, msg, sk, nonce=rand_scalar(rng, curve))
    assert cn.verify_message(curve, msg, r, s, pk)
    assert not cn.verify_message(curve, (msg + 1) % curve.n, r, s, pk)


def test_ecdsa_known_vector():
    """Independent cross-check: secp256k1 with fixed sk/nonce, values computed
    from textbook ECDSA (not from the reference, which has no fixed vectors)."""
    c = cn.SECP256K1
    sk = 0x1
    msg = 0xDEADBEEF
    r, s = cn.sign_message(c, msg, sk, nonce=0x2)
    # r = x(2G) mod n
    assert r == cn.scalar_mul(c.generator(), 2).x % c.n
    assert s == pow(2, -1, c.n) * (msg + r * sk) % c.n
    assert cn.verify_message(c, msg, r, s, c.generator())


def test_keccak256_known_vectors():
    assert keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    )
    assert keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    )
    # 136-byte (exactly one rate block) message exercises padding edge
    assert keccak256(b"\x00" * 136).hex() == keccak256(b"\x00" * 136).hex()


def test_deterministic_offset_point():
    p32 = cn.deterministic_offset_point(cn.SECP256K1, 32)
    p25 = cn.deterministic_offset_point(cn.SECP256K1, 25)
    assert p32.is_valid() and p25.is_valid()
    assert p32 != p25
    # stable across calls (cached + deterministic)
    assert p32 == cn.deterministic_offset_point(cn.SECP256K1, 32)


@pytest.mark.parametrize("curve", [cn.SECP256K1, cn.P256], ids=lambda c: c.name)
def test_projective_arithmetic_matches_affine(rng, curve):
    """Jacobian dbl-2007-bl / add-1998-cmo-2 / madd-1998-cmo agree with the
    affine group law (reference curve_types.rs:191-218, curve_adds.rs)."""
    g = curve.generator()
    a = cn.scalar_mul(g, rand_scalar(rng, curve))
    b = cn.scalar_mul(g, rand_scalar(rng, curve))
    pa = cn.ProjectivePoint.from_affine(a)
    pb = cn.ProjectivePoint.from_affine(b)
    assert (pa + pb).to_affine() == a + b
    assert (pa + b).to_affine() == a + b            # mixed add
    assert pa.double().to_affine() == a.double()
    # special cases: zero, P + P, P + (-P)
    z = cn.ProjectivePoint.zero(curve)
    assert (z + pa).to_affine() == a
    assert (pa + z).to_affine() == a
    assert (pa + pa).to_affine() == a.double()
    assert (pa + a).to_affine() == a.double()
    assert (pa + (-pa)).is_zero
    assert (pa + (-a)).is_zero


def test_batch_to_affine(rng):
    curve = cn.SECP256K1
    g = curve.generator()
    pts = [cn.ProjectivePoint.from_affine(cn.scalar_mul(g, rand_scalar(rng, curve)))
           for _ in range(5)]
    pts = [a + b for a, b in zip(pts, pts[1:] + pts[:1])]  # nontrivial Z
    pts.insert(2, cn.ProjectivePoint.zero(curve))
    got = cn.batch_to_affine(pts)
    assert [q for q in got] == [q.to_affine() for q in pts]
