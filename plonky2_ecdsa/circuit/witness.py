"""Host-side Goldilocks helpers on uint64 arrays + witness constraint checker.

The tape (builder.py) computes witness values on the host in numpy; these
helpers do canonical Goldilocks arithmetic directly on uint64 arrays (the host
has 64-bit lanes; the u32-pair forms in fields/goldilocks.py are for device
code).  `check_constraints` evaluates every gate's constraints over the full
witness matrix — the fast CI-side correctness check for circuits too large to
FRI-prove on 2 CPU cores (SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np

from ..fields import goldilocks as gl
from .algebra import BaseAlgebra
from .gates import PublicInputGate

P = gl.P
_P64 = np.uint64(P)
_EPS = np.uint64(0xFFFFFFFF)
_M32 = np.uint64(0xFFFFFFFF)


def gadd(a, b):
    s = a + b
    c = s < a
    s = s + c * _EPS  # cannot re-wrap (see fields/goldilocks.py add proof)
    return np.where(s >= _P64, s - _P64, s)


def gsub(a, b):
    d = a - b
    brw = a < b
    return d - brw * _EPS


def gneg(a):
    return np.where(a == 0, a, _P64 - a)


def gmul(a, b):
    a0, a1 = a & _M32, a >> np.uint64(32)
    b0, b1 = b & _M32, b >> np.uint64(32)
    ll = a0 * b0
    mid = a0 * b1
    mid2 = a1 * b0
    mid = mid + mid2
    midc = (mid < mid2).astype(np.uint64)  # carry into bit 96
    hh = a1 * b1
    lo = ll + (mid << np.uint64(32))
    c = (lo < ll).astype(np.uint64)
    hi = hh + (mid >> np.uint64(32)) + (midc << np.uint64(32)) + c
    # reduce 128 -> 64: lo + (hi&M32)*EPS - (hi>>32)
    b96 = hi >> np.uint64(32)
    t = lo - b96
    t = t - (lo < b96) * _EPS
    u = (hi & _M32) * _EPS
    r = t + u
    r = r + (r < u) * _EPS
    return np.where(r >= _P64, r - _P64, r)


def gmul_const(a, c: int):
    c %= P
    if c == 0:
        return np.zeros_like(a)
    if c == 1:
        return a.copy()
    return gmul(a, np.uint64(c))


def ginv(a):
    """Elementwise modular inverse via vectorized Fermat a^(P-2); inv(0)=0."""
    return gpow(a, P - 2)


def gpow(a, e: int):
    r = np.ones_like(a)
    base = a
    while e:
        if e & 1:
            r = gmul(r, base)
        e >>= 1
        if e:
            base = gmul(base, base)
    return r


# ---------------------------------------------------------------------------
# Constraint checking over the witness matrix
# ---------------------------------------------------------------------------

def check_constraints(circuit, W: np.ndarray, pi_values: np.ndarray | None = None,
                      raise_on_fail: bool = True):
    """Evaluate all gate constraints on all rows.

    W: [num_wires, n, B] uint64.  Returns dict gate_id -> max abs violation
    count; raises AssertionError on any nonzero constraint if raise_on_fail.
    """
    failures = {}
    alg = BaseAlgebra(np)
    for gi, gate in enumerate(circuit.gates):
        rows = circuit.gate_rows.get(gi, np.array([], dtype=np.int64))
        if len(rows) == 0 or gate.num_constraints == 0:
            continue
        wires_u64 = W[:, rows, :]  # [num_wires, R, B]
        wires = [gl.from_u64(wires_u64[c]) for c in range(gate.num_wires)]
        consts = [gl.from_u64(np.broadcast_to(circuit.constants[j, rows][:, None],
                                              wires_u64.shape[1:]).copy())
                  for j in range(circuit.config.num_constant_cols)]
        ctx = {}
        if isinstance(gate, PublicInputGate):
            ctx["pi_vals"] = _pi_vals_for_rows(circuit, rows, pi_values, wires_u64.shape[1:])
        cons = gate.eval(alg, wires, consts, ctx)
        bad = 0
        for ci, c in enumerate(cons):
            v = gl.to_u64(*c)
            nz = int(np.count_nonzero(v))
            if nz:
                bad += nz
                if raise_on_fail:
                    idx = np.argwhere(v != 0)[0]
                    raise AssertionError(
                        f"constraint {ci} of {gate.gate_id()} violated at "
                        f"row={rows[idx[0]]} batch={idx[1]}: value {v[tuple(idx)]}"
                    )
        if bad:
            failures[gate.gate_id()] = bad
    return failures


def _pi_vals_for_rows(circuit, rows, pi_values, shape):
    """Per-row public-input column values for the PI gate rows.

    pi_values: [B, num_pis] (from circuit.public_input_values())."""
    K = circuit.pi.num_cols
    B = shape[-1]
    out = np.zeros((K,) + tuple(shape), dtype=np.uint64)
    if pi_values is not None:
        row_index = {r: i for i, r in enumerate(circuit.pi.rows)}
        for ri, r in enumerate(rows):
            blk = row_index.get(int(r))
            if blk is None:
                continue
            for j in range(K):
                pi_idx = blk * K + j
                if pi_idx < circuit.pi.count:
                    out[j, ri, :] = pi_values[:, pi_idx]
    return [gl.from_u64(out[j]) for j in range(K)]
