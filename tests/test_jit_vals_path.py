"""The production upload path (make_jit_prover.run_vals): compact value-table
dispatch with the narrow/wide split planes must produce proofs identical in
validity to the full-witness path, ship measurably less data, and reject a
misclassified (wide value in the narrow plane) table loudly."""

import numpy as np
import pytest

from plonky2_ecdsa.api import int_to_limbs
from plonky2_ecdsa.circuit.examples import nonnative_mul_chain_circuit
from plonky2_ecdsa.curve import native as cn
from plonky2_ecdsa.prover.data import build_circuit_data
from plonky2_ecdsa.prover.prover import _narrow_mask, make_jit_prover
from plonky2_ecdsa.prover.verifier import verify


@pytest.fixture(scope="module")
def system():
    c = nonnative_mul_chain_circuit().build()
    data = build_circuit_data(c)
    rng = np.random.default_rng(5)
    B = 2
    xs = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p
          for _ in range(B)]
    ys = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p
          for _ in range(B)]
    vals = c._run_tape({"x": int_to_limbs(xs), "y": int_to_limbs(ys)}, B, None)
    return c, data, vals


def test_run_vals_proof_verifies(system):
    c, data, vals = system
    run = make_jit_prover(data)
    pis = c.public_input_values()
    proof = run.run_vals(vals, pis)
    assert verify(data, proof)


def test_narrow_classification_sound_and_substantial(system):
    c, data, vals = system
    mask = _narrow_mask(c)
    assert not (vals[mask] >> np.uint64(32)).any()
    # the split must actually pay: most values are 29-bit limb domain
    assert mask.mean() > 0.5, f"narrow fraction only {mask.mean():.2f}"


def test_misclassified_wide_value_falls_back_to_wide_path(system, capfd):
    """A >=2^32 value under a narrow-classified slot must NOT be silently
    truncated: the dispatch detects it, warns, and re-routes the batch
    through the wide witness path (an availability fallback instead of a
    hard abort).  The injected value is semantically wrong for the
    circuit, so the resulting proof must fail verification — proving the
    fallback shipped the REAL 64-bit value, not a truncation (a truncated
    witness here would differ from the honest one only above bit 32)."""
    from plonky2_ecdsa.prover.verifier import verify

    c, data, vals = system
    run = make_jit_prover(data)
    mask = _narrow_mask(c)
    mask[c.derived_tids] = False  # derived targets are not uploaded at all
    tid = int(np.nonzero(mask)[0][0])
    bad = vals.copy()
    bad[tid, 0] |= np.uint64(1) << np.uint64(40)
    proof = run.run_vals(bad, c.public_input_values())
    assert "falling back to the wide witness path" in capfd.readouterr().err
    assert not verify(data, proof)
    # honest table still proves through the narrow path afterwards
    good = run.run_vals(vals, c.public_input_values())
    assert verify(data, good)
