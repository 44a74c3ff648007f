"""Frozen golden-vector suite (SURVEY.md §7 hard part 6).

tests/vectors/*.json are generated by scripts/gen_vectors.py from a
SELF-CONTAINED textbook implementation (pure Python ints, no library
imports), so these tests cross-check the library's limb / field / curve /
GLV / ECDSA layers against an independent source rather than against
themselves.  The reference's tests are RNG-driven (OsRng, SURVEY.md §4);
frozen vectors are deliberately stronger.
"""

import json
import os

import numpy as np
import pytest

from plonky2_ecdsa import api
from plonky2_ecdsa.curve import native as cn
from plonky2_ecdsa.fields import goldilocks as gl
from plonky2_ecdsa.fields import limbs as fl
from plonky2_ecdsa.fields import prime_field as pf

VEC = os.path.join(os.path.dirname(__file__), "vectors")


def load(name):
    with open(os.path.join(VEC, name)) as f:
        return json.load(f)


def test_limb_vectors():
    for row in load("limbs.json"):
        v = int(row["value"], 16)
        assert api.int_to_limbs([v]).tolist()[0] == row["limbs29"]
        assert api.limbs_to_int(np.array([row["limbs29"]], dtype=np.uint64))[0] == v
        # tensor convert_base: 32-bit digits -> 29-bit limbs (biguint.rs:27-51)
        d32 = fl.from_int(v, 9, bits=32)
        got = fl.convert(d32, 32, 29, 10)
        assert fl.to_ints(got, bits=29)[()] == v


def test_goldilocks_vectors():
    for row in load("goldilocks.json"):
        a, b = int(row["a"], 16), int(row["b"], 16)
        ap, bp = gl.from_u64(np.array([a], np.uint64)), gl.from_u64(np.array([b], np.uint64))
        assert gl.to_u64(*gl.add(*ap, *bp))[0] == int(row["add"], 16)
        assert gl.to_u64(*gl.sub(*ap, *bp))[0] == int(row["sub"], 16)
        assert gl.to_u64(*gl.mul(*ap, *bp))[0] == int(row["mul"], 16)
        assert gl.to_u64(*gl.inverse(*ap))[0] == int(row["inv_a"], 16)


def test_goldilocks_vectors_u32_interior():
    """Same vectors through the forced u32-pair interior (the u32-pair device formulation)."""
    old = gl._FORCE_U32
    gl._FORCE_U32 = True
    try:
        test_goldilocks_vectors()
    finally:
        gl._FORCE_U32 = old


_FIELD_CLASSES = {
    "secp256k1_base": pf.Secp256K1Base, "secp256k1_scalar": pf.Secp256K1Scalar,
    "p256_base": pf.P256Base, "p256_scalar": pf.P256Scalar,
}


def test_foreign_field_vectors():
    data = load("foreign_fields.json")
    for key, cls in _FIELD_CLASSES.items():
        blk = data[key]
        assert cls.order() == int(blk["modulus"], 16)
        for row in blk["ops"]:
            a, b = cls(int(row["a"], 16)), cls(int(row["b"], 16))
            assert (a + b).v == int(row["add"], 16)
            assert (a - b).v == int(row["sub"], 16)
            assert (a * b).v == int(row["mul"], 16)
            assert a.inverse().v == int(row["inv_a"], 16)
        # tensor-limb modulus path (fields/limbs.py Modulus; 16-bit limbs)
        m = fl.Modulus(int(blk["modulus"], 16))
        row = blk["ops"][0]
        L = fl.num_limbs(256)
        a_t = fl.from_int(int(row["a"], 16), L)
        b_t = fl.from_int(int(row["b"], 16), L)
        _q, r = m.mod_mul(a_t, b_t)
        assert fl.to_ints(r)[()] == int(row["mul"], 16)
        r, _ovf = m.mod_add(a_t, b_t)
        assert fl.to_ints(r)[()] == int(row["add"], 16)
        r, _brw = m.mod_sub(a_t, b_t)
        assert fl.to_ints(r)[()] == int(row["sub"], 16)


_CURVES = {"secp256k1": cn.SECP256K1, "p256": cn.P256}


def test_curve_vectors():
    data = load("curve.json")
    for name, curve in _CURVES.items():
        blk = data[name]
        G = curve.generator()
        assert (G.x, G.y) == (int(blk["G"]["x"], 16), int(blk["G"]["y"], 16))
        for k, want in (("2G", 2), ("3G", 3)):
            got = cn.scalar_mul(G, want)
            assert (got.x, got.y) == (int(blk["small"][k]["x"], 16),
                                      int(blk["small"][k]["y"], 16))
        for row in blk["muls"]:
            got = cn.scalar_mul(G, int(row["k"], 16))
            assert (got.x, got.y) == (int(row["x"], 16), int(row["y"], 16))
            # Yao-precomputation path must agree too
            got2 = cn.msm([int(row["k"], 16)], [G])
            assert (got2.x, got2.y) == (got.x, got.y)
        for row in blk["adds"]:
            A = cn.Point(curve, int(row["ax"], 16), int(row["ay"], 16))
            B = cn.Point(curve, int(row["bx"], 16), int(row["by"], 16))
            S = A + B
            D = A + A
            assert (S.x, S.y) == (int(row["sum_x"], 16), int(row["sum_y"], 16))
            assert (D.x, D.y) == (int(row["dbl_x"], 16), int(row["dbl_y"], 16))


def test_glv_decomposition_against_curve_vectors():
    """GLV path must reproduce the independently-computed k*G points, and
    the (k1, k2) decomposition must satisfy k1 + s*k2 == k with |ki| < 2^129
    (glv.rs:39-77 lattice bound)."""
    data = load("curve.json")["secp256k1"]
    curve = cn.SECP256K1
    G = curve.generator()
    for row in data["muls"]:
        k = int(row["k"], 16)
        got = cn.glv_mul(G, k)
        assert (got.x, got.y) == (int(row["x"], 16), int(row["y"], 16))
        k1, k2, neg1, neg2 = cn.decompose_secp256k1_scalar(k)
        s1 = -k1 if neg1 else k1
        s2 = -k2 if neg2 else k2
        assert (s1 + cn.GLV_S * s2) % curve.n == k % curve.n
        assert k1 < (1 << 129) and k2 < (1 << 129)


def test_ecdsa_vectors():
    for name, curve in _CURVES.items():
        for row in load("ecdsa.json")[name]:
            sk = int(row["sk"], 16)
            msg = int(row["msg"], 16)
            nonce = int(row["nonce"], 16)
            r, s = cn.sign_message(curve, msg, sk, nonce)
            assert (r, s) == (int(row["r"], 16), int(row["s"], 16))
            _, pk = cn.keygen(curve, sk)
            assert (pk.x, pk.y) == (int(row["pk_x"], 16), int(row["pk_y"], 16))
            assert cn.verify_message(curve, msg, r, s, pk)
            assert not cn.verify_message(curve, (msg + 1) % curve.n, r, s, pk)


def test_transcript_frozen_vectors():
    """The full proof transcript for the demo circuit is pinned
    (tests/vectors/transcript_demo.json, scripts/gen_transcript_vectors.py):
    any silent drift in Poseidon constants, absorb order, challenge
    squeezing, FRI schedule, PoW grind or index sampling fails here.
    Regenerate ONLY for a conscious protocol change."""
    from plonky2_ecdsa.circuit.examples import (small_demo_circuit,
                                                    small_demo_witness)
    from plonky2_ecdsa.prover.data import build_circuit_data
    from plonky2_ecdsa.prover.prover import prove

    want = load("transcript_demo.json")
    circuit = small_demo_circuit().build()
    data = build_circuit_data(circuit)
    assert data.n == want["n"]
    W, pis = small_demo_witness(circuit, batch=want["batch"], seed=want["seed"])
    proof = prove(data, W, pis)

    def hexs(lo, hi):
        return [hex(int(v)) for v in
                np.ravel(gl.to_u64(np.asarray(lo), np.asarray(hi)))]

    assert hexs(*proof.wires_cap)[:16] == want["wires_cap"]
    assert hexs(*proof.zs_cap)[:16] == want["zs_cap"]
    assert hexs(*proof.quotient_cap)[:16] == want["quotient_cap"]
    assert hexs(*proof.openings0[0])[:16] == want["openings0_c0"]
    assert hexs(*proof.openings0[1])[:16] == want["openings0_c1"]
    assert hexs(*proof.fri_proof.final_coeffs[0])[:8] == want["fri_final_coeffs_c0"]
    assert [int(v) for v in np.ravel(proof.fri_proof.indices)[:16]] == want["fri_indices"]
    assert hexs(*proof.fri_proof.pow_witness)[:2] == want["pow_witness"]
