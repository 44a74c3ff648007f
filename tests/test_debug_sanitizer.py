"""Device-shaped witness sanitizer (utils/debug.py): honest witnesses report
zero violations; corrupted range-pool values / lookup limbs / non-canonical
wires are detected and classified.  The analogue of the reference CI's armed
debug assertions (continuous-integration.yml:47; biguint.rs:46-49)."""

import numpy as np
import pytest

from plonky2_ecdsa.circuit.examples import (nonnative_mul_chain_circuit,
                                                small_demo_witness)
from plonky2_ecdsa.circuit.gates import RangeLookupGate
from plonky2_ecdsa.utils.debug import assert_witness_ok, witness_violations
from plonky2_ecdsa.api import int_to_limbs
from plonky2_ecdsa.curve import native as cn
from plonky2_ecdsa.fields.goldilocks import P


@pytest.fixture(scope="module")
def chain():
    c = nonnative_mul_chain_circuit().build()
    rng = np.random.default_rng(11)
    B = 2
    xs = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p
          for _ in range(B)]
    ys = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p
          for _ in range(B)]
    W = c.generate_witness({"x": int_to_limbs(xs), "y": int_to_limbs(ys)}, B)
    return c, W


def _lookup_gates(c):
    return [(gi, g) for gi, g in enumerate(c.gates)
            if isinstance(g, RangeLookupGate)]


def test_honest_witness_clean(chain):
    c, W = chain
    counts = {k: int(v) for k, v in witness_violations(c, W).items()}
    assert any(k.startswith("range_") for k in counts), "no range pools seen"
    assert all(v == 0 for v in counts.values()), counts
    assert_witness_ok(c, W)


def test_detects_noncanonical_wire(chain):
    c, W = chain
    bad = W.copy()
    bad[0, 0, 0] = np.uint64(P)  # == p: non-canonical encoding of 0
    counts = witness_violations(c, bad)
    assert int(counts["canonicity"]) == 1
    with pytest.raises(AssertionError, match="canonicity"):
        assert_witness_ok(c, bad)


def test_detects_out_of_range_pool_value(chain):
    c, W = chain
    gi, g = _lookup_gates(c)[0]
    row = int(c.gate_rows[gi][0])
    bad = W.copy()
    bad[g.wire_value(0), row, 0] += np.uint64(1) << np.uint64(g.bits)
    counts = {k: int(v) for k, v in witness_violations(c, bad).items()}
    assert counts[f"range_{g.bits}"] >= 1


def test_detects_corrupt_lookup_limb(chain):
    c, W = chain
    gi, g = _lookup_gates(c)[0]
    row = int(c.gate_rows[gi][0])
    bad = W.copy()
    col = g.wire_limb(0, 0)
    bad[col, row, 0] = np.uint64(1) << np.uint64(g.limb_bits)
    counts = {k: int(v) for k, v in witness_violations(c, bad).items()}
    assert counts[f"lookup_limb_{g.bits}"] >= 1


def test_jnp_device_kernel_matches_numpy(chain):
    jnp = pytest.importorskip("jax.numpy")
    c, W = chain
    n = {k: int(v) for k, v in witness_violations(c, W, np).items()}
    d = {k: int(v) for k, v in witness_violations(c, jnp.asarray(W), jnp).items()}
    assert n == d
