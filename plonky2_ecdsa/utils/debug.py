"""Witness sanitizers: checkify-style debug range kernels (SURVEY.md §5).

Reference equivalent: CI compiles with `-Cdebug-assertions -Coverflow-checks=y`
(/root/reference/.github/workflows/continuous-integration.yml:47), which arms
the limb-bound `assert!`s inside witness generators
(src/gadgets/biguint.rs:46-49, src/gates/mul_nonnative.rs:274-277,527).

This framework's host witness fills carry the same asserts; this module adds
the device-shaped half: `witness_violations` is a single xp-agnostic
(numpy or jax.numpy — jittable) kernel that validates an entire witness batch
against the contracts the proof system ASSUMES of honest witnesses:

  * canonicity      — every wire value < Goldilocks p,
  * range pools     — every pooled range-checked value (29-bit limbs, 34-bit
                      nonnative-mul carries) within its declared bound, and
                      every derived lookup limb within the scaled table bound.

Violations here mean a witness-generator bug (the proof would fail anyway,
but with an opaque quotient/lookup mismatch); this reports per-class counts
instead.  Set PLONKY2_DEBUG=1 to arm the check inside `prove()`.
"""

from __future__ import annotations

import numpy as np

from ..fields import goldilocks as gl
from ..circuit.gates import RangeLookupGate


def witness_violations(circuit, W, xp=np) -> dict:
    """Per-class violation counts for a witness matrix W [wires, n, B] u64.

    Returns {"canonicity": k, "range_<bits>": k, "lookup_limb_<bits>": k}.
    Zero everywhere for an honest witness.  xp=jnp makes this a device
    kernel (counts come back as device scalars; jittable for fixed circuit).
    """
    W = xp.asarray(W)
    out = {"canonicity": (W >= np.uint64(gl.P)).sum()}
    for gi, gate in enumerate(circuit.gates):
        if not isinstance(gate, RangeLookupGate):
            continue
        rows = circuit.gate_rows[gi]
        lb = gate.limb_bits
        # declared bound on each pooled value
        vals = W[: gate.num_vals][:, rows, :]  # value wires are cols 0..V-1
        key = f"range_{gate.bits}"
        bad = (vals >> np.uint64(gate.bits)).sum()
        out[key] = out.get(key, 0) + bad
        # derived limbs must sit inside the (scaled) lookup table range
        limb_cols = np.array([gate.wire_limb(v, j)
                              for v in range(gate.num_vals)
                              for j in range(gate.num_limbs)])
        limbs = W[limb_cols][:, rows, :]
        lbad = (limbs >> np.uint64(lb)).sum()
        if gate.scale > 1:
            top_cols = np.array([gate.wire_limb(v, gate.num_limbs - 1)
                                 for v in range(gate.num_vals)])
            tops = W[top_cols][:, rows, :]
            # only scale-check tops that already pass the plain limb bound:
            # a wildly corrupt top could wrap tops*scale in u64 and
            # under-count (it is already counted by the plain check above)
            in_range = tops < np.uint64(1 << lb)
            scaled_bad = (tops * np.uint64(gate.scale) >> np.uint64(lb)) != 0
            lbad = lbad + (in_range & scaled_bad).sum()
        lkey = f"lookup_limb_{gate.bits}"
        out[lkey] = out.get(lkey, 0) + lbad
    return out


def assert_witness_ok(circuit, W, xp=np) -> None:
    """Raise AssertionError listing every violated contract class."""
    counts = {k: int(v) for k, v in witness_violations(circuit, W, xp).items()}
    bad = {k: v for k, v in counts.items() if v}
    assert not bad, f"witness sanitizer violations: {bad}"
