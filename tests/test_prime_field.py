"""plonky2-Field-shaped prime field classes (reference p256_base.rs /
p256_scalar.rs parity: constants, Fermat inversion, two-adic generators)."""

import numpy as np
import pytest

from plonky2_ecdsa.curve import native as cn
from plonky2_ecdsa.fields.prime_field import (P256Base, P256Scalar,
                                                  Secp256K1Base,
                                                  Secp256K1Scalar)

FIELDS = [P256Base, P256Scalar, Secp256K1Base, Secp256K1Scalar]


@pytest.mark.parametrize("F", FIELDS, ids=lambda f: f.__name__)
def test_field_axioms_and_inverse(rng, F):
    a = F.rand(rng)
    b = F.rand(rng)
    assert (a + b) - b == a
    assert a * F.one() == a
    assert a + F.zero() == a
    assert (-a) + a == F.zero()
    assert a.square() == a * a
    if not a.is_zero():
        assert a * a.inverse() == F.one()
    assert F.zero().try_inverse() is None
    assert F.neg_one() + F.one() == F.zero()


@pytest.mark.parametrize("F", FIELDS, ids=lambda f: f.__name__)
def test_two_adic_generators(F):
    """POWER_OF_TWO_GENERATOR has exact order 2^TWO_ADICITY and the
    multiplicative generator is a non-residue chain root (reference
    p256_base.rs:90-96, p256_scalar.rs:107-119)."""
    g2 = F(F.POWER_OF_TWO_GENERATOR)
    assert g2.exp(1 << F.TWO_ADICITY) == F.one()
    assert g2.exp(1 << (F.TWO_ADICITY - 1)) != F.one()
    # (order-1) / 2^TWO_ADICITY must be odd
    assert ((F.ORDER - 1) >> F.TWO_ADICITY) & 1 == 1
    g = F(F.MULTIPLICATIVE_GROUP_GENERATOR)
    # g^((p-1)/2^v) must have full 2-adic order
    assert g.exp((F.ORDER - 1) >> F.TWO_ADICITY).exp(
        1 << (F.TWO_ADICITY - 1)) != F.one()


def test_orders_match_curve_params():
    assert P256Base.ORDER == cn.P256.p
    assert P256Scalar.ORDER == cn.P256.n
    assert Secp256K1Base.ORDER == cn.SECP256K1.p
    assert Secp256K1Scalar.ORDER == cn.SECP256K1.n


def test_u64_limb_roundtrip(rng):
    a = P256Scalar.rand(rng)
    assert P256Scalar.from_u64_limbs(a.to_u64_limbs()) == a
    # the reference's NEG_ONE limb constants (p256_scalar.rs:100-105)
    assert P256Scalar.neg_one().to_u64_limbs() == [
        0xF3B9CAC2FC632550, 0xBCE6FAADA7179E84,
        0xFFFFFFFFFFFFFFFF, 0xFFFFFFFF00000000]
