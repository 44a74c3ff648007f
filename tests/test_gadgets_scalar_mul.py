"""Per-gadget circuit tests for every scalar-multiplication strategy, each
checked against the native oracle — reference parity with the per-path tests
in curve_windowed_mul.rs:176-257, curve_msm.rs:81-137,
curve_fixed_base.rs:68-117, glv.rs:173-219, and curve.rs:459-515.

These paths were previously exercised only transitively through the full
ECDSA circuits."""

import numpy as np
import pytest

from plonky2_ecdsa.circuit.builder import CircuitBuilder
from plonky2_ecdsa.circuit.config import CircuitConfig
from plonky2_ecdsa.circuit.foreign import BITS, scalar_field
from plonky2_ecdsa.circuit.witness import check_constraints
from plonky2_ecdsa.curve import native as cn
from plonky2_ecdsa.gadgets import curve as gc
from plonky2_ecdsa.gadgets import curve_fixed_base as gfb
from plonky2_ecdsa.gadgets import curve_msm as gmsm
from plonky2_ecdsa.gadgets import curve_windowed as gw
from plonky2_ecdsa.gadgets import glv as gglv
from plonky2_ecdsa.gadgets import nonnative as gn

N = 9
MASK = (1 << BITS) - 1


def to_limbs(vals, n=N):
    out = np.zeros((len(vals), n), np.uint64)
    for i, v in enumerate(vals):
        for j in range(n):
            out[i, j] = (v >> (BITS * j)) & MASK
    return out


def from_limbs(arr):
    return [sum(int(l) << (BITS * j) for j, l in enumerate(row)) for row in arr]


def virtual_point(b, curve, name):
    p = gc.add_virtual_affine_point(b, curve)
    b.register_input(name + "_x", p.x.limbs)
    b.register_input(name + "_y", p.y.limbs)
    return p


def virtual_scalar(b, curve, name):
    k = gn.add_virtual_nonnative(b, scalar_field(curve))
    b.register_input(name, k.limbs)
    return k


def rand_point(rng, curve):
    k = int.from_bytes(rng.bytes(40), "little") % curve.n
    return cn.scalar_mul(curve.generator(), k or 1)


def run(build_fn, inputs, B):
    b = CircuitBuilder(CircuitConfig.test_config())
    build_fn(b)
    c = b.build()
    W = c.generate_witness(inputs, B)
    pis = c.public_input_values()
    assert check_constraints(c, W, pis) == {}
    return c, pis


def check_points(pis, want):
    assert from_limbs(pis[:, :N]) == [p.x for p in want]
    assert from_limbs(pis[:, N:2 * N]) == [p.y for p in want]


def test_windowed_scalar_mul_matches_native(rng):
    """curve_scalar_mul_windowed vs native (curve_windowed_mul.rs:176-257)."""
    curve = cn.SECP256K1
    pts = [rand_point(rng, curve) for _ in range(2)]
    ks = [int.from_bytes(rng.bytes(40), "little") % curve.n for _ in range(2)]

    def build(b):
        p = virtual_point(b, curve, "p")
        k = virtual_scalar(b, curve, "k")
        out = gw.curve_scalar_mul_windowed(b, p, k)
        b.register_public_inputs(out.x.limbs + out.y.limbs)

    inputs = {"p_x": to_limbs([p.x for p in pts]),
              "p_y": to_limbs([p.y for p in pts]), "k": to_limbs(ks)}
    _c, pis = run(build, inputs, 2)
    check_points(pis, [cn.scalar_mul(p, k) for p, k in zip(pts, ks)])


def test_dual_msm_matches_native(rng):
    """curve_msm_circuit: n*p + m*q vs native (curve_msm.rs:81-137)."""
    curve = cn.SECP256K1
    p, q = rand_point(rng, curve), rand_point(rng, curve)
    kn = int.from_bytes(rng.bytes(40), "little") % curve.n
    km = int.from_bytes(rng.bytes(40), "little") % curve.n

    def build(b):
        pt = virtual_point(b, curve, "p")
        qt = virtual_point(b, curve, "q")
        n_t = virtual_scalar(b, curve, "kn")
        m_t = virtual_scalar(b, curve, "km")
        out = gmsm.curve_msm_circuit(b, pt, qt, n_t, m_t)
        b.register_public_inputs(out.x.limbs + out.y.limbs)

    inputs = {"p_x": to_limbs([p.x]), "p_y": to_limbs([p.y]),
              "q_x": to_limbs([q.x]), "q_y": to_limbs([q.y]),
              "kn": to_limbs([kn]), "km": to_limbs([km])}
    _c, pis = run(build, inputs, 1)
    check_points(pis, [cn.scalar_mul(p, kn) + cn.scalar_mul(q, km)])


def test_fixed_base_mul_matches_native(rng):
    """fixed_base_curve_mul_circuit vs native (curve_fixed_base.rs:68-117)."""
    curve = cn.SECP256K1
    g = curve.generator()
    ks = [int.from_bytes(rng.bytes(40), "little") % curve.n for _ in range(2)]

    def build(b):
        k = virtual_scalar(b, curve, "k")
        out = gfb.fixed_base_curve_mul_circuit(b, g, k)
        b.register_public_inputs(out.x.limbs + out.y.limbs)

    _c, pis = run(build, {"k": to_limbs(ks)}, 2)
    check_points(pis, [cn.scalar_mul(g, k) for k in ks])


def test_glv_mul_matches_native(rng):
    """glv_mul (endomorphism decomposition path) vs native (glv.rs:173-219)."""
    curve = cn.SECP256K1
    pts = [rand_point(rng, curve) for _ in range(2)]
    ks = [int.from_bytes(rng.bytes(40), "little") % curve.n for _ in range(2)]

    def build(b):
        p = virtual_point(b, curve, "p")
        k = virtual_scalar(b, curve, "k")
        out = gglv.glv_mul(b, p, k)
        b.register_public_inputs(out.x.limbs + out.y.limbs)

    inputs = {"p_x": to_limbs([p.x for p in pts]),
              "p_y": to_limbs([p.y for p in pts]), "k": to_limbs(ks)}
    _c, pis = run(build, inputs, 2)
    check_points(pis, [cn.scalar_mul(p, k) for p, k in zip(pts, ks)])


def test_naive_scalar_mul_matches_native(rng):
    """curve_scalar_mul 261-bit double-and-add vs native (curve.rs:459-515)."""
    curve = cn.P256
    p = rand_point(rng, curve)
    k = int.from_bytes(rng.bytes(40), "little") % curve.n

    def build(b):
        pt = virtual_point(b, curve, "p")
        kt = virtual_scalar(b, curve, "k")
        out = gc.curve_scalar_mul(b, pt, kt)
        b.register_public_inputs(out.x.limbs + out.y.limbs)

    inputs = {"p_x": to_limbs([p.x]), "p_y": to_limbs([p.y]),
              "k": to_limbs([k])}
    _c, pis = run(build, inputs, 1)
    check_points(pis, [cn.scalar_mul(p, k)])


def test_fixed_base_catches_injected_table_bug(rng, monkeypatch):
    """Deliberately corrupt one precomputed fixed-base table entry; the
    oracle comparison must catch the silently-wrong constant table
    (a deliberately injected table bug)."""
    curve = cn.SECP256K1
    g = curve.generator()
    k = int.from_bytes(rng.bytes(40), "little") % curve.n

    real_tables = gfb._window_tables.__wrapped__  # bypass lru_cache

    def bad_tables(curve_, base_x, base_y, num_windows):
        tables = [list(t) for t in real_tables(curve_, base_x, base_y,
                                               num_windows)]
        pt = tables[3][7]
        tables[3][7] = cn.Point(curve_, (pt.x + 1) % curve_.p, pt.y)
        return tuple(tuple(t) for t in tables)

    monkeypatch.setattr(gfb, "_window_tables", bad_tables)

    def build(b):
        kt = virtual_scalar(b, curve, "k")
        out = gfb.fixed_base_curve_mul_circuit(b, g, kt)
        b.register_public_inputs(out.x.limbs + out.y.limbs)

    b = CircuitBuilder(CircuitConfig.test_config())
    build(b)
    c = b.build()
    # table row index 7 = digit t=8 of window 3: scalar 8 * 16^3 hits it
    kbad = 8 * 16 ** 3
    W = c.generate_witness({"k": to_limbs([kbad])}, 1)
    pis = c.public_input_values()
    got = (from_limbs(pis[:, :N])[0], from_limbs(pis[:, N:2 * N])[0])
    want = cn.scalar_mul(g, kbad)
    assert got != (want.x, want.y), "corrupted table went undetected"


# ---------------------------------------------------------------------------
# Prove-through-FRI versions: the reference
# proves every gadget path through the real prover (curve_windowed_mul.rs:
# 176-257, curve_msm.rs:81-137, glv.rs:173-219, curve_fixed_base.rs:68-117);
# constraint-check-only tests cannot catch prover/verifier-side bugs.
# ---------------------------------------------------------------------------

def _prove_cfg():
    from plonky2_ecdsa.circuit.config import FriConfig

    # reduced FRI query count for CPU wall-time; still a real FRI proof
    return CircuitConfig(range_lookup_limb_bits=11, range_lookup_vals=28,
                         fri=FriConfig(rate_bits=2, cap_height=1,
                                       num_query_rounds=6,
                                       proof_of_work_bits=0))


def _prove_and_verify(build_fn, inputs, B, want):
    from plonky2_ecdsa.prover.data import build_circuit_data
    from plonky2_ecdsa.prover.prover import prove
    from plonky2_ecdsa.prover.verifier import verify

    b = CircuitBuilder(_prove_cfg())
    build_fn(b)
    c = b.build()
    W = c.generate_witness(inputs, B)
    pis = c.public_input_values()
    data = build_circuit_data(c)
    proof = prove(data, W, pis)
    assert verify(data, proof)
    check_points(pis, want)
    # soundness probe: a tampered opening must not verify
    t = (proof.openings0[0][0].copy(), proof.openings0[0][1])
    t[0][0, 0] ^= 1
    import dataclasses

    bad = dataclasses.replace(proof, openings0=(t, proof.openings0[1]))
    assert not verify(data, bad)


@pytest.mark.slow
def test_windowed_scalar_mul_proves(rng):
    curve = cn.SECP256K1
    p = rand_point(rng, curve)
    k = int.from_bytes(rng.bytes(40), "little") % curve.n

    def build(b):
        pt = virtual_point(b, curve, "p")
        kt = virtual_scalar(b, curve, "k")
        out = gw.curve_scalar_mul_windowed(b, pt, kt)
        b.register_public_inputs(out.x.limbs + out.y.limbs)

    inputs = {"p_x": to_limbs([p.x]), "p_y": to_limbs([p.y]),
              "k": to_limbs([k])}
    _prove_and_verify(build, inputs, 1, [cn.scalar_mul(p, k)])


@pytest.mark.slow
def test_dual_msm_proves(rng):
    curve = cn.SECP256K1
    p, q = rand_point(rng, curve), rand_point(rng, curve)
    kn = int.from_bytes(rng.bytes(40), "little") % curve.n
    km = int.from_bytes(rng.bytes(40), "little") % curve.n

    def build(b):
        pt = virtual_point(b, curve, "p")
        qt = virtual_point(b, curve, "q")
        n_t = virtual_scalar(b, curve, "kn")
        m_t = virtual_scalar(b, curve, "km")
        out = gmsm.curve_msm_circuit(b, pt, qt, n_t, m_t)
        b.register_public_inputs(out.x.limbs + out.y.limbs)

    inputs = {"p_x": to_limbs([p.x]), "p_y": to_limbs([p.y]),
              "q_x": to_limbs([q.x]), "q_y": to_limbs([q.y]),
              "kn": to_limbs([kn]), "km": to_limbs([km])}
    _prove_and_verify(build, inputs, 1,
                      [cn.scalar_mul(p, kn) + cn.scalar_mul(q, km)])


@pytest.mark.slow
def test_fixed_base_mul_proves(rng):
    curve = cn.SECP256K1
    g = curve.generator()
    k = int.from_bytes(rng.bytes(40), "little") % curve.n

    def build(b):
        kt = virtual_scalar(b, curve, "k")
        out = gfb.fixed_base_curve_mul_circuit(b, g, kt)
        b.register_public_inputs(out.x.limbs + out.y.limbs)

    _prove_and_verify(build, {"k": to_limbs([k])}, 1, [cn.scalar_mul(g, k)])


@pytest.mark.slow
def test_glv_mul_proves(rng):
    curve = cn.SECP256K1
    p = rand_point(rng, curve)
    k = int.from_bytes(rng.bytes(40), "little") % curve.n

    def build(b):
        pt = virtual_point(b, curve, "p")
        kt = virtual_scalar(b, curve, "k")
        out = gglv.glv_mul(b, pt, kt)
        b.register_public_inputs(out.x.limbs + out.y.limbs)

    inputs = {"p_x": to_limbs([p.x]), "p_y": to_limbs([p.y]),
              "k": to_limbs([k])}
    _prove_and_verify(build, inputs, 1, [cn.scalar_mul(p, k)])
