"""Prover stack tests: NTT, Poseidon/Merkle, and end-to-end prove+verify on
small circuits (the reference's gadget tests all run through the real prover,
SURVEY.md §4; CPU-sized circuits here, full ECDSA proving on device)."""

import os

import numpy as np
import pytest

from plonky2_ecdsa.circuit.builder import CircuitBuilder
from plonky2_ecdsa.circuit.config import CircuitConfig
from plonky2_ecdsa.fields import goldilocks as gl
from plonky2_ecdsa.hash import merkle, poseidon
from plonky2_ecdsa.prover import ntt
from plonky2_ecdsa.prover.data import build_circuit_data
from plonky2_ecdsa.prover.prover import prove
from plonky2_ecdsa.prover.verifier import verify, verify_strict

P = gl.P


def test_ntt_roundtrip(rng):
    n = 64
    vals = rng.integers(0, P, size=(3, n), dtype=np.uint64) % np.uint64(P)
    pair = gl.from_u64(vals)
    back = ntt.intt(*ntt.ntt(*pair))
    assert np.array_equal(gl.to_u64(*back), vals)


def test_ntt_matches_naive_dft(rng):
    n = 8
    g = pow(gl.POWER_OF_TWO_GENERATOR, (1 << 32) // n, P)
    vals = [int(x) % P for x in rng.integers(0, P, n, dtype=np.uint64)]
    pair = gl.from_u64(np.array(vals, dtype=np.uint64))
    got = gl.to_u64(*ntt.ntt(*pair)).tolist()
    # interpret input as coefficients: output[i] = sum_j c_j g^(ij)
    want = [sum(vals[j] * pow(g, i * j, P) for j in range(n)) % P for i in range(n)]
    assert got == want


def test_coset_lde_agrees_pointwise(rng):
    n, rate = 16, 3
    vals = rng.integers(0, P, size=n, dtype=np.uint64) % np.uint64(P)
    pair = gl.from_u64(vals)
    lde = ntt.coset_lde(*pair, rate)
    # polynomial through values: coeffs
    coeffs = [int(v) for v in gl.to_u64(*ntt.intt(*pair))]
    N = n << rate
    pts = ntt.lde_domain(N)
    for i in [0, 1, 5, N - 1]:
        x = int(pts[i])
        want = sum(c * pow(x, k, P) for k, c in enumerate(coeffs)) % P
        assert int(gl.to_u64(*lde)[i]) == want


def test_ext_powers(rng):
    z = (gl.from_int(123456789, (2,)), gl.from_int(987654321, (2,)))
    zp = ntt.ext_powers(z, 8)
    z0, z1 = 123456789, 987654321
    a0, a1 = 1, 0
    for k in range(8):
        assert int(gl.to_u64(*zp[0][0:2][0])[0, k] if False else gl.to_u64(zp[0][0][..., k], zp[0][1][..., k])[0]) == a0
        assert int(gl.to_u64(zp[1][0][..., k], zp[1][1][..., k])[0]) == a1
        a0, a1 = (a0 * z0 + 7 * a1 * z1) % P, (a0 * z1 + a1 * z0) % P


def test_poseidon_shapes_and_determinism():
    elems = [gl.from_int(i + 1, (5,)) for i in range(10)]
    d1 = poseidon.hash_no_pad(elems)
    d2 = poseidon.hash_no_pad(elems)
    assert len(d1) == 4
    for a, b in zip(d1, d2):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    # different input -> different hash
    elems2 = [gl.from_int(i + 2, (5,)) for i in range(10)]
    d3 = poseidon.hash_no_pad(elems2)
    assert not np.array_equal(d1[0][0], d3[0][0])


def test_merkle_roundtrip(rng):
    L, Wd = 32, 3
    data = rng.integers(0, P, size=(L, Wd), dtype=np.uint64) % np.uint64(P)
    lo, hi = gl.from_u64(data)
    tree = merkle.build_merkle_tree(lo, hi, cap_height=1)
    for idx in [0, 7, 31]:
        path = tree.open(np.array([idx]))
        ok = merkle.verify_merkle_proof(
            lo[idx], hi[idx], idx, np.asarray(path[0][0]), np.asarray(path[1][0]),
            np.asarray(tree.cap[0]), np.asarray(tree.cap[1]))
        assert ok
    # corrupt leaf
    path = tree.open(np.array([3]))
    bad_lo = lo[3].copy()
    bad_lo[0] ^= np.uint32(1)
    assert not merkle.verify_merkle_proof(
        bad_lo, hi[3], 3, np.asarray(path[0][0]), np.asarray(path[1][0]),
        np.asarray(tree.cap[0]), np.asarray(tree.cap[1]))


def _small_circuit():
    b = CircuitBuilder(CircuitConfig.test_config())
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    b.register_input("x", [x])
    b.register_input("y", [y])
    z = b.mul(x, y)
    w = b.mul_add(z, z, y)
    bits = b.split_le_base2(x, 29)
    b.range_check(x, 29)
    v = b.random_access(bits[0], [b.constant(i * i) for i in range(16)])
    eq = b.is_equal(x, y)
    out = b.select(eq, z, w)
    b.register_public_inputs([z, w, out, v])
    return b


_CACHE = {}


def _prove_small(B):
    if B in _CACHE:
        return _CACHE[B]
    rng = np.random.default_rng(42 + B)
    b = _small_circuit()
    c = b.build()
    xs = (rng.integers(0, 1 << 29, size=(B, 1), dtype=np.uint64))
    ys = (rng.integers(0, P, size=(B, 1), dtype=np.uint64) % np.uint64(P))
    W = c.generate_witness({"x": xs, "y": ys}, B)
    pis = c.public_input_values()
    data = build_circuit_data(c)
    proof = prove(data, W, pis)
    _CACHE[B] = (data, proof, c)
    return data, proof, c


def test_prove_verify_small():
    data, proof, c = _prove_small(2)
    assert verify(data, proof)


def test_verify_rejects_tampered_opening():
    import copy

    data, proof, c = _prove_small(2)
    proof = copy.deepcopy(proof)
    proof.openings0[0][0][0, 5] ^= np.uint32(1)
    assert not verify(data, proof)
    with pytest.raises(AssertionError):
        verify_strict(data, proof)


def test_verify_rejects_tampered_pi():
    import copy

    data, proof, c = _prove_small(2)
    proof = copy.deepcopy(proof)
    proof.pis[0, 0] ^= np.uint64(1)
    assert not verify(data, proof)
    with pytest.raises(AssertionError):
        verify_strict(data, proof)


def test_verify_rejects_tampered_fri_data():
    import copy

    data, proof, c = _prove_small(2)
    proof = copy.deepcopy(proof)
    if proof.fri_proof.layer_leaves:
        proof.fri_proof.layer_leaves[0][0][0, 0, 0] ^= np.uint32(1)
    else:  # tiny circuits fold zero layers; tamper the final polynomial
        proof.fri_proof.final_coeffs[0][0][0, 0] ^= np.uint32(1)
    assert not verify(data, proof)
    with pytest.raises(AssertionError):
        verify_strict(data, proof)


def test_verify_rejects_tampered_initial_leaf():
    import copy

    data, proof, c = _prove_small(2)
    proof = copy.deepcopy(proof)
    proof.initial_leaves["wires"][0][0, 0, 3] ^= np.uint32(1)
    assert not verify(data, proof)
    with pytest.raises(AssertionError):
        verify_strict(data, proof)


def test_challenger_pow_grind_roundtrip():
    """grind() and check_pow() agree and keep prover/verifier transcripts in
    sync (plonky2 FRI proof_of_work_bits protocol step)."""
    from plonky2_ecdsa.prover.challenger import Challenger

    ch = Challenger(np, (3,))
    ch.observe(gl.from_int(12345, (3,)))
    w = ch.grind(8)
    ch2 = Challenger(np, (3,))
    ch2.observe(gl.from_int(12345, (3,)))
    assert ch2.check_pow(w, 8).all()
    a, b = ch.get_challenge(), ch2.get_challenge()
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    # a wrong witness fails the response check (w.h.p.)
    ch3 = Challenger(np, (3,))
    ch3.observe(gl.from_int(12345, (3,)))
    bad = (w[0] ^ np.uint32(1), w[1])
    assert not ch3.check_pow(bad, 8).any()


def test_grind_compacted_matches_numpy():
    """The lane-compacted device grind (B > 8 path) picks the SAME witness
    per lane as the numpy wide sweep (both scan each lane's candidate space
    strictly in order), so np/jnp proofs stay bit-identical."""
    import jax.numpy as jnp

    from plonky2_ecdsa.prover.challenger import Challenger

    B = 12
    seed = gl.from_int(987654, (B,))
    ch_np = Challenger(np, (B,))
    ch_np.observe(seed)
    w_np = ch_np.grind(8)
    ch_j = Challenger(jnp, (B,))
    ch_j.observe((jnp.asarray(seed[0]), jnp.asarray(seed[1])))
    w_j = ch_j.grind(8)
    assert np.array_equal(np.asarray(w_j[0]), w_np[0])
    assert np.array_equal(np.asarray(w_j[1]), w_np[1])
    a, b = ch_np.get_challenge(), ch_j.get_challenge()
    assert np.array_equal(a[0], np.asarray(b[0]))
    assert np.array_equal(a[1], np.asarray(b[1]))


@pytest.mark.slow
def test_preflight_frozen_digests_match_recomputed():
    """tests/vectors/preflight_digests.json (the bench preflight's frozen
    numpy references) still matches a from-scratch recomputation — guards
    silent Poseidon/field/batch-inverse semantic drift behind the digests."""
    import json
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import scripts.device_parity as t

    with open(t._PREFLIGHT_VECTORS) as f:
        frozen = json.load(f)
    saved = t._PREFLIGHT_VECTORS
    t._PREFLIGHT_VECTORS = saved + ".force-recompute"
    try:
        _inputs, recomputed = t._preflight_host_side(
            np.random.default_rng(0xECD5A))
    finally:
        t._PREFLIGHT_VECTORS = saved
    assert recomputed == frozen


def test_verify_rejects_tampered_pow_witness():
    import copy

    data, proof, c = _prove_small(2)
    assert data.circuit.config.fri.proof_of_work_bits > 0
    assert proof.fri_proof.pow_witness is not None
    proof = copy.deepcopy(proof)
    proof.fri_proof.pow_witness[0][0] ^= np.uint32(1)
    assert not verify(data, proof)
    with pytest.raises(AssertionError):
        verify_strict(data, proof)


@pytest.mark.slow
def test_batched_verifier_matches_exact():
    """The vectorized verifier and the python-int reference path agree."""
    from plonky2_ecdsa.prover.verifier import verify_one_exact

    data, proof, c = _prove_small(2)
    verify_strict(data, proof)
    for b in range(proof.pis.shape[0]):
        verify_one_exact(data, proof, b)


def test_poseidon_matches_python_int_oracle(rng):
    """Pin the vectorized Poseidon2 permutation against exact python-int
    modular math (independent of the lazy part-plane / u32-pair tricks and
    of the M4 application schedule: the oracle uses plain matvecs)."""
    v = rng.integers(0, P, size=(12,), dtype=np.uint64)
    state = [int(x) for x in v]

    def ext(s):
        return [sum(poseidon.EXT_MATRIX[i][j] * s[j] for j in range(12)) % P
                for i in range(12)]

    def internal(s):
        tot = sum(s)
        return [(tot + (poseidon.INTERNAL_DIAG[i] - 1) * s[i]) % P
                for i in range(12)]

    state = ext(state)  # Poseidon2 initial external layer
    for r in range(poseidon.TOTAL_ROUNDS):
        full = r < poseidon.HALF_FULL_ROUNDS or r >= poseidon.HALF_FULL_ROUNDS + poseidon.PARTIAL_ROUNDS
        state = [(s + int(poseidon._RC_U64[r, i])) % P
                 for i, s in enumerate(state)]  # padded table: 0 off-lane-0
        for i in range(12 if full else 1):
            state[i] = pow(state[i], 7, P)
        state = ext(state) if full else internal(state)
    lo, hi = gl.from_u64(v.reshape(12, 1))
    out = poseidon.permute_stacked(lo, hi)
    got = [int(x) for x in gl.to_u64(*out)[:, 0]]
    assert got == state


def test_poseidon_grain_constants_pinned():
    """Freeze the Grain-LFSR round constants + a permutation output so any
    accidental drift in the derivation (poseidon._gen_round_constants) is
    caught; the derivation itself is the canonical one from the Poseidon
    reference implementation (no plonky2 constants available offline —
    poseidon.py module docstring)."""
    rc = poseidon.ROUND_CONSTANTS
    assert len(rc) == 118  # Poseidon2: R_F*t + R_P
    assert rc[:4] == [0x13DCF33ABA214F46, 0x30B3B654A1DA6D83,
                      0x1FC634ADA6159B56, 0x937459964DC03466]
    assert rc[-2:] == [0xF798E24961823EC7, 0x962DEBA3E9A2CD94]
    lo = np.arange(12, dtype=np.uint32).reshape(12, 1)
    hi = np.zeros((12, 1), np.uint32)
    out = gl.to_u64(*poseidon.permute_stacked(lo, hi)).ravel()
    assert [int(v) for v in out[:4]] == [
        0x1B7E25130101BE72, 0xAD3F64AD4495E8EE,
        0x730300498CECFC32, 0xF72238C9D44C5941]


def test_poseidon_constants_from_spec():
    """Constants-drift guard: the package's Grain-LFSR
    round constants + Poseidon2 matrices must match BOTH the frozen vector
    file and a from-scratch re-derivation by the independent generator in
    scripts/gen_poseidon_constants.py (int-state LFSR, no shared code), so
    the instance is reproducible from spec rather than trusted from one
    implementation.  Also re-runs the Poseidon2 paper's internal-layer
    security condition: the deterministic diagonal search must land on the
    package's INTERNAL_DIAG with an IRREDUCIBLE characteristic polynomial
    over GF(p) (no invariant-subspace trails)."""
    import json
    import os

    from scripts import gen_poseidon_constants as gen

    with open(os.path.join(os.path.dirname(__file__), "vectors",
                           "poseidon_constants.json")) as f:
        vec = json.load(f)
    frozen_rc = [int(c) for c in vec["round_constants"]]
    assert frozen_rc == poseidon.ROUND_CONSTANTS
    assert gen.derive_constants() == poseidon.ROUND_CONSTANTS
    assert vec["ext_matrix"] == poseidon.EXT_MATRIX == gen.ext_matrix()
    assert vec["internal_diag"] == list(poseidon.INTERNAL_DIAG)
    assert gen.derive_internal_diag() == list(poseidon.INTERNAL_DIAG)
    assert gen.poly_irreducible(
        gen.char_poly_internal(list(poseidon.INTERNAL_DIAG)))


def test_poseidon_m4_is_mds():
    """Exhaustive MDS check on the Poseidon2 external layer's M4 block (the
    paper's MDS requirement lives on M4; the 12x12 block-circulant is
    deliberately not MDS overall): every square submatrix nonsingular."""
    from scripts.check_mds import all_minors_nonzero

    assert all_minors_nonzero()


@pytest.mark.slow
def test_streaming_wire_commit_matches_plain(rng):
    """_lde_commit_wires_stream (fori_loop + sponge absorb) must produce the
    exact coeffs/LDE/cap of the plain path, incl. the k%8 remainder absorb
    (live for wide_ecc_config's 234 wires)."""
    import jax.numpy as jnp

    from plonky2_ecdsa.prover.prover import _lde_commit, _lde_commit_wires_stream

    n, N, caph = 32, 128, 2
    for k in (16, 10):  # multiple-of-rate and remainder paths
        vals = rng.integers(0, P, size=(3, k, n), dtype=np.uint64)
        pair = gl.from_u64(vals)
        ref_coeffs, ref_lde, ref_tree = _lde_commit(pair, n, N, caph, np)
        jpair = (jnp.asarray(pair[0]), jnp.asarray(pair[1]))
        coeffs, lde, tree = _lde_commit_wires_stream(jpair, n, N, caph, jnp)
        assert np.array_equal(np.asarray(coeffs[0]), ref_coeffs[0])
        assert np.array_equal(np.asarray(coeffs[1]), ref_coeffs[1])
        assert np.array_equal(np.asarray(lde[0]), ref_lde[0])
        assert np.array_equal(np.asarray(lde[1]), ref_lde[1])
        assert np.array_equal(np.asarray(tree.cap[0]), ref_tree.cap[0])
        assert np.array_equal(np.asarray(tree.cap[1]), ref_tree.cap[1])


def test_merkle_open_packed_matches_loop(rng):
    """The device-path packed open (one gather for all levels) returns
    exactly the per-level loop's sibling paths, batched and unbatched."""
    import jax.numpy as jnp

    B, L, W = 3, 64, 5
    vals = rng.integers(0, P, size=(B, L, W), dtype=np.uint64)
    lo, hi = gl.from_u64(vals)
    tree_np = merkle.build_merkle_tree(lo, hi, 2)
    tree_j = merkle.MerkleTree(
        levels=[(jnp.asarray(a), jnp.asarray(b)) for a, b in tree_np.levels],
        cap_height=tree_np.cap_height)
    idx = rng.integers(0, L, size=(B, 7)).astype(np.int32)
    want = tree_np.open(idx)
    got = tree_j.open(jnp.asarray(idx))
    assert np.array_equal(np.asarray(got[0]), want[0])
    assert np.array_equal(np.asarray(got[1]), want[1])
    # unbatched (fixed-commitment) tree
    tree1_np = merkle.build_merkle_tree(lo[0], hi[0], 1)
    tree1_j = merkle.MerkleTree(
        levels=[(jnp.asarray(a), jnp.asarray(b)) for a, b in tree1_np.levels],
        cap_height=tree1_np.cap_height)
    want1 = tree1_np.open(idx)
    got1 = tree1_j.open(jnp.asarray(idx))
    assert np.array_equal(np.asarray(got1[0]), want1[0])
    assert np.array_equal(np.asarray(got1[1]), want1[1])


@pytest.mark.slow
def test_streamed_zs_branch_b48_matches_numpy():
    """prove_core switches to the streaming zs commit purely on batch size
    (B >= 48, prover.py); before this test the branch's only exercise was the
    on-device B=64 bench (the scale-gated untested class of code that once
    hid a regression).  Drive it on CPU-backend JAX at
    B=48 and require the full proof bit-identical to the numpy path (which
    always uses the unstreamed commit)."""
    import jax
    import jax.numpy as jnp

    from plonky2_ecdsa.prover.prover import _register_pytrees

    _register_pytrees()
    B = 48
    rng = np.random.default_rng(148)
    b = _small_circuit()
    c = b.build()
    xs = rng.integers(0, 1 << 29, size=(B, 1), dtype=np.uint64)
    ys = rng.integers(0, P, size=(B, 1), dtype=np.uint64) % np.uint64(P)
    W = c.generate_witness({"x": xs, "y": ys}, B)
    pis = c.public_input_values()
    data = build_circuit_data(c)
    ref = prove(data, W, pis, xp=np)
    got = prove(data, W, pis, xp=jnp)
    assert verify(data, got)
    ref_leaves = jax.tree_util.tree_leaves(ref)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(ref_leaves) == len(got_leaves)
    for i, (r, g) in enumerate(zip(ref_leaves, got_leaves)):
        assert np.array_equal(np.asarray(r), np.asarray(g)), f"leaf {i} differs"


def test_prefix_suffix_scans_and_batch_inverse(rng):
    """Semantics of the log-depth scans + Montgomery batch inverse at the
    production LogUp width k=155 (round-3 regression: the old reversed-view
    suffix scan was miscompiled at exactly this non-tile-aligned width;
    scripts/device_parity.py carries the on-device parity guard)."""
    import jax
    import jax.numpy as jnp

    from plonky2_ecdsa.prover.prover import (
        _batch_inverse_axis1, _prefix_prod_exclusive, _suffix_prod_exclusive)

    for k in (1, 2, 20, 155):
        v = rng.integers(1, P, size=(2, 3, k), dtype=np.uint64)
        pair = gl.from_u64(v)
        pre = gl.to_u64(*_prefix_prod_exclusive(*pair, np))
        suf = gl.to_u64(*_suffix_prod_exclusive(*pair, np))
        for b in range(2):
            for r in range(3):
                acc = 1
                for i in range(k):
                    assert int(pre[b, r, i]) == acc
                    acc = acc * int(v[b, r, i]) % P
                acc = 1
                for i in reversed(range(k)):
                    assert int(suf[b, r, i]) == acc
                    acc = acc * int(v[b, r, i]) % P
        # batch inverse: numpy path and jitted jnp path both invert exactly
        inv_np = _batch_inverse_axis1((pair[0].transpose(0, 2, 1),
                                       pair[1].transpose(0, 2, 1)), np)
        got = gl.to_u64(*inv_np)
        vv = v.transpose(0, 2, 1)
        for idx in np.ndindex(2, k, 3):
            assert int(got[idx]) == pow(int(vv[idx]), P - 2, P)
        jinv = jax.jit(lambda p: _batch_inverse_axis1(p, jnp))(
            (jnp.asarray(pair[0].transpose(0, 2, 1)),
             jnp.asarray(pair[1].transpose(0, 2, 1))))
        assert np.array_equal(np.asarray(jinv[0]), inv_np[0])
        assert np.array_equal(np.asarray(jinv[1]), inv_np[1])
