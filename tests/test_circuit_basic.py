"""Circuit-layer smoke tests: build small templates, generate batched
witnesses, and verify every gate constraint over the witness matrix."""

import numpy as np

from plonky2_ecdsa.circuit.builder import CircuitBuilder
from plonky2_ecdsa.circuit.config import CircuitConfig
from plonky2_ecdsa.circuit.witness import check_constraints, gmul
from plonky2_ecdsa.fields.goldilocks import P


def test_arithmetic_circuit(rng):
    b = CircuitBuilder(CircuitConfig.test_config())
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    b.register_input("x", [x])
    b.register_input("y", [y])
    z = b.mul(x, y)
    w = b.add(z, x)
    v = b.sub(w, y)
    u = b.mul_add(v, v, z)
    b.register_public_input(u)
    c = b.build()

    B = 5
    xs = rng.integers(0, P, size=(B, 1), dtype=np.uint64) % np.uint64(P)
    ys = rng.integers(0, P, size=(B, 1), dtype=np.uint64) % np.uint64(P)
    W = c.generate_witness({"x": xs, "y": ys}, B)
    pis = c.public_input_values()
    for i in range(B):
        xi, yi = int(xs[i, 0]), int(ys[i, 0])
        zi = xi * yi % P
        wi = (zi + xi) % P
        vi = (wi - yi) % P
        ui = (vi * vi + zi) % P
        assert int(pis[i, 0]) == ui
    assert check_constraints(c, W, pis) == {}


def test_constraint_checker_catches_bad_witness(rng):
    b = CircuitBuilder(CircuitConfig.test_config())
    x = b.add_virtual_target()
    b.register_input("x", [x])
    z = b.mul(x, x)
    b.register_public_input(z)
    c = b.build()
    W = c.generate_witness({"x": np.array([[3]], dtype=np.uint64)}, 1)
    pis = c.public_input_values()
    # corrupt the multiplication output wire
    bad = W.copy()
    rows = c.gate_rows[[g.gate_id() for g in c.gates].index("Arithmetic(20)")]
    # find a nonzero wire in that row and flip it
    r = rows[0]
    bad[3, r, 0] ^= np.uint64(1)
    fails = check_constraints(c, bad, pis, raise_on_fail=False)
    assert fails  # at least one violated constraint


def test_split_and_range_check(rng):
    b = CircuitBuilder(CircuitConfig.test_config())
    x = b.add_virtual_target()
    b.register_input("x", [x])
    bits = b.split_le_base2(x, 29)
    assert len(bits) == 29
    b.range_check(x, 29)
    # recombine two bits
    two = b.mul_add(bits[1], b.constant(2), bits[0])
    b.register_public_input(two)
    c = b.build()

    B = 4
    vals = rng.integers(0, 1 << 29, size=(B, 1), dtype=np.uint64)
    W = c.generate_witness({"x": vals}, B)
    pis = c.public_input_values()
    for i in range(B):
        assert int(pis[i, 0]) == int(vals[i, 0]) & 3
    assert check_constraints(c, W, pis) == {}


def test_is_equal_and_select(rng):
    b = CircuitBuilder(CircuitConfig.test_config())
    x, y = b.add_virtual_target(), b.add_virtual_target()
    b.register_input("x", [x])
    b.register_input("y", [y])
    eq = b.is_equal(x, y)
    ne = b.not_(eq)
    sel = b.select(eq, x, b.constant(777))
    b.register_public_inputs([eq, ne, sel])
    c = b.build()
    xs = np.array([[5], [9], [0]], dtype=np.uint64)
    ys = np.array([[5], [8], [1]], dtype=np.uint64)
    W = c.generate_witness({"x": xs, "y": ys}, 3)
    pis = c.public_input_values()
    assert pis[:, 0].tolist() == [1, 0, 0]
    assert pis[:, 1].tolist() == [0, 1, 1]
    assert pis[:, 2].tolist() == [5, 777, 777]
    assert check_constraints(c, W, pis) == {}


def test_random_access(rng):
    b = CircuitBuilder(CircuitConfig.test_config())
    items = [b.constant(int(v)) for v in rng.integers(0, P, 16, dtype=np.uint64)]
    idx = b.add_virtual_target()
    b.register_input("idx", [idx])
    out = b.random_access(idx, items)
    b.register_public_input(out)
    c = b.build()
    idxs = np.array([[0], [7], [15], [3]], dtype=np.uint64)
    W = c.generate_witness({"idx": idxs}, 4)
    pis = c.public_input_values()
    vals = [c.constant_values[t] for t in items]
    for i, ix in enumerate(idxs[:, 0]):
        assert int(pis[i, 0]) == vals[int(ix)] % P
    assert check_constraints(c, W, pis) == {}


def test_wide_ecc_config_ecdsa_constraints():
    """wide_ecc_config parity (reference runs ECDSA under standard + wide,
    src/gadgets/ecdsa.rs:163-181).  Builds the full secp256k1 verify circuit
    under the wide config and checks every constraint on a signature batch
    (~10 s with the native witness executor)."""
    from plonky2_ecdsa import api
    from plonky2_ecdsa.curve import native as cn

    system = api.EcdsaProverSystem(cn.SECP256K1, CircuitConfig.wide_ecc_config())
    stmts = api.random_statements(cn.SECP256K1, 2, seed=9)
    assert system.check(stmts)


def test_p256_ecdsa_circuit_constraints():
    """P-256 verify circuit parity (reference verify_p256_message_circuit,
    src/gadgets/ecdsa.rs:55-78 + test_ecdsa_circuit p256 variants): builds the
    full circuit (4-bit windowed mul for u2*pk, no GLV) and checks every
    constraint on a signature batch."""
    from plonky2_ecdsa import api
    from plonky2_ecdsa.curve import native as cn

    system = api.EcdsaProverSystem(cn.P256)
    stmts = api.random_statements(cn.P256, 2, seed=10)
    assert system.check(stmts)
