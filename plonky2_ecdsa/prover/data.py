"""Prover preprocessing: fixed polynomials, their commitment, domain tables.

plonky2 `CircuitData`/`ProverOnlyCircuitData` equivalent (SURVEY.md §2.9
"builder.build::<C>()"): computed once per circuit shape, reused for every
proof batch ("build-once / prove-many", the reference's circuit-serialization
checkpoint analogue)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..circuit.builder import Circuit
from ..fields import goldilocks as gl
from ..hash import merkle
from . import ntt

P = gl.P


@dataclass
class LookupInfo:
    """LogUp range-lookup metadata (None on circuits without lookups).

    The argument (per challenge c, challenge alpha_c drawn after the wires
    commitment):  sum over looked-up limb terms of 1/(alpha - f) equals
    sum over rows of m(x)/(alpha - t(x)), where t is the canonical-row-index
    fixed polynomial and m the multiplicity wire column.  Committed with the
    permutation Zs: helper columns h_b (batches of 3 rational terms), the
    table helper h_tab = m/(alpha - t), and the running sum Z."""
    gates: list          # [(gate_idx, RangeLookupGate)]
    mult_col: int        # wire column of multiplicities
    table_idx: int       # row index of t(x) within fixed_values
    num_batches: int     # helper columns per challenge (max over gates)
    cols_per_challenge: int   # num_batches + 2 (h_tab, Z)
    slots: int           # constraint slots: 1 + num_batches + 1 + 1


@dataclass
class CircuitData:
    circuit: Circuit
    n: int
    N: int                      # LDE size = n << rate_bits
    g: int                      # subgroup generator (order n)
    fixed_values: np.ndarray    # [F0, n] u64: constants, selectors, sigmas[, table]
    fixed_lde: tuple            # pairs [F0, N]
    fixed_tree: merkle.MerkleTree
    fixed_coeffs: tuple         # pairs [F0, n]
    id_encodings: np.ndarray    # [80, n] u64 (k_j * g^i)
    x_lde: np.ndarray           # [N] u64 domain points
    zh_inv: tuple               # pairs [N]: 1 / (x^n - 1)
    l0_lde: tuple               # pairs [N]: Lagrange L_0 over the coset
    num_constraint_slots: int   # perm constraints + max gate constraints [+ lookup]
    perm_slots: int
    lookup: LookupInfo | None = None


def _use_device() -> bool:
    """Build the one-time fixed data on the accelerator (jitted).

    Same integer math either way (ntt/merkle are backend-generic); numpy is
    kept on the CPU backend, where jit compiles would dominate."""
    import jax

    return jax.default_backend() != "cpu"


def _fixed_commit(fixed_values: np.ndarray, n: int, N: int, cap_height: int):
    """fixed u64 [F0, n] -> (coeffs, lde, tree) pairs, device-jitted off the
    CPU.  A device failure raises: it is never retried on the host."""
    flo, fhi = gl.from_u64(fixed_values)
    if _use_device():
        return _fixed_commit_device(flo, fhi, n, N, cap_height)
    return _fixed_commit_host(flo, fhi, n, N, cap_height)


def _fixed_commit_host(flo, fhi, n: int, N: int, cap_height: int):
    """The numpy fixed commitment (the reference the device build matches)."""
    fixed_coeffs = ntt.intt(flo, fhi)
    clo = np.concatenate([fixed_coeffs[0],
                          np.zeros((fixed_coeffs[0].shape[0], N - n), np.uint32)], -1)
    chi = np.concatenate([fixed_coeffs[1],
                          np.zeros((fixed_coeffs[1].shape[0], N - n), np.uint32)], -1)
    fixed_lde = ntt.coset_ntt_from_coeffs(clo, chi)
    leaves_lo = np.ascontiguousarray(fixed_lde[0].T)  # [N, F0]: polys -> leaf axis
    leaves_hi = np.ascontiguousarray(fixed_lde[1].T)
    tree = merkle.build_merkle_tree(leaves_lo, leaves_hi, cap_height)
    return fixed_coeffs, fixed_lde, tree


def _fixed_commit_device(flo, fhi, n: int, N: int, cap_height: int):
    import jax
    import jax.numpy as jnp

    tabs = jax.tree_util.tree_map(jnp.asarray, ntt.host_tables([n, N]))

    @jax.jit
    def go(tabs, flo, fhi):
        tok = ntt._DEVICE_TABLES.set(tabs)
        try:
            coeffs = ntt.intt(flo, fhi)
            pad = jnp.zeros((flo.shape[0], N - n), jnp.uint32)
            lde = ntt.coset_ntt_from_coeffs(
                jnp.concatenate([coeffs[0], pad], -1),
                jnp.concatenate([coeffs[1], pad], -1))
            tree = merkle.build_merkle_tree(lde[0].T, lde[1].T, cap_height)
            return coeffs, lde, tree.levels
        finally:
            ntt._DEVICE_TABLES.reset(tok)

    coeffs, lde, levels = jax.tree_util.tree_map(
        np.asarray, go(tabs, jnp.asarray(flo), jnp.asarray(fhi)))
    tree = merkle.MerkleTree(levels=list(levels), cap_height=min(
        cap_height, (N).bit_length() - 1))
    return coeffs, lde, tree


def build_circuit_data(circuit: Circuit) -> CircuitData:
    cfg = circuit.config
    n = circuit.n
    N = n << cfg.fri.rate_bits
    # Quotient representability: a degree-d gate's constraint
    # poly has degree ~d*n; the quotient (degree ~(d-1)*n) is committed as
    # 2^rate_bits chunks of degree < n, so d must not exceed the blowup.
    # Without this, a degree-7 gate (PoseidonGate) under a rate-4 config
    # silently yields proofs that fail verification with an unrelated-looking
    # FRI/quotient error.
    for gi, gate in enumerate(circuit.gates):
        if (len(circuit.gate_rows.get(gi, ())) > 0
                and gate.degree > (1 << cfg.fri.rate_bits)):
            raise ValueError(
                f"gate {gate.gate_id()} has degree {gate.degree} > blowup "
                f"2^{cfg.fri.rate_bits}: the quotient cannot represent its "
                f"constraints; use a config with rate_bits >= "
                f"{max(1, (gate.degree - 1).bit_length())} "
                f"(e.g. standard_recursion_config for PoseidonGate)")
    g = pow(gl.POWER_OF_TWO_GENERATOR, (1 << 32) // n, P)

    from ..circuit.gates import RangeLookupGate

    lk_gates = [(gi, g_) for gi, g_ in enumerate(circuit.gates)
                if isinstance(g_, RangeLookupGate)
                and len(circuit.gate_rows.get(gi, ())) > 0]
    fixed_rows = [circuit.constants, circuit.selectors, circuit.sigmas]
    lookup = None
    if lk_gates:
        # t(x) = canonical row index: [0, 2^limb_bits) then padding zeros
        lb = cfg.range_lookup_limb_bits
        table = np.arange(n, dtype=np.uint64)
        table[1 << lb:] = 0
        fixed_rows.append(table[None])
        nb = max(g_.num_batches for _gi, g_ in lk_gates)
        lookup = LookupInfo(
            gates=lk_gates,
            mult_col=circuit.lookup_mult_col,
            table_idx=(cfg.num_constant_cols + len(circuit.gates)
                       + cfg.num_routed_wires),
            num_batches=nb,
            cols_per_challenge=nb + 2,
            slots=nb + 3,
        )
    fixed_values = np.concatenate(fixed_rows, axis=0).astype(np.uint64)
    fixed_coeffs, fixed_lde, fixed_tree = _fixed_commit(
        fixed_values, n, N, cfg.fri.cap_height)

    # identity encodings k_j * g^i
    g_pows = np.zeros(n, dtype=np.uint64)
    acc = 1
    for i in range(n):
        g_pows[i] = acc
        acc = acc * g % P
    ids = np.zeros((cfg.num_routed_wires, n), dtype=np.uint64)
    gp = gl.from_u64(g_pows)
    for j, kj in enumerate(circuit.k_coeffs):
        ids[j] = gl.to_u64(*gl.mul(*gp, *gl.from_int(kj, (n,))))

    x_lde = ntt.lde_domain(N)
    # Z_H(x) = x^n - 1 over the coset: shift^n * (G^n)^i - 1, period 2^rate
    shift_n = pow(ntt.COSET_SHIFT, n, P)
    gn = pow(pow(gl.POWER_OF_TWO_GENERATOR, (1 << 32) // N, P), n, P)
    period = N // n
    zh_small = [(shift_n * pow(gn, i, P) - 1) % P for i in range(period)]
    zh_inv_small = [pow(v, -1, P) for v in zh_small]
    zh_inv_u64 = np.tile(np.array(zh_inv_small, dtype=np.uint64), n)
    zh_inv = gl.from_u64(zh_inv_u64)

    # L_0(x) = (x^n - 1) / (n * (x - 1))
    from ..circuit.witness import ginv, gmul_const, gsub

    zh_u64 = np.tile(np.array(zh_small, dtype=np.uint64), n)
    x_min_1 = gsub(x_lde, np.uint64(1))
    denom_inv = ginv(gmul_const(x_min_1, n % P))
    l0 = gl.mul(*gl.from_u64(zh_u64), *gl.from_u64(denom_inv))

    max_gate_cons = max((gate.num_constraints for gate in circuit.gates), default=0)
    # L_0 first-row constraint + one step constraint per chunk (last = Z(gx))
    perm_slots = 1 + cfg.num_routed_wires // cfg.permutation_chunk_size
    slots = perm_slots + max_gate_cons + (lookup.slots if lookup else 0)

    return CircuitData(
        circuit=circuit,
        n=n,
        N=N,
        g=g,
        fixed_values=fixed_values,
        fixed_lde=fixed_lde,
        fixed_tree=fixed_tree,
        fixed_coeffs=fixed_coeffs,
        id_encodings=ids,
        x_lde=x_lde,
        zh_inv=zh_inv,
        l0_lde=l0,
        num_constraint_slots=slots,
        perm_slots=perm_slots,
        lookup=lookup,
    )
