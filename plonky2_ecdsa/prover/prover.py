"""The batched PLONK+FRI prover.

plonky2 `prove()` equivalent (SURVEY.md §2.9 proving pipeline): wire
commitment -> permutation grand products (+ partial products, chunk size 8)
-> alpha-combined quotient -> FRI batch opening at zeta / g*zeta.

Accelerator-first structure: every step is a tensor program with a leading batch axis
(one lane per signature/proof) — the axis that replaces the reference's rayon
parallelism (SURVEY.md §2 parallelism inventory).  The whole pipeline is
backend-generic: pass xp=numpy for the host/CI path or xp=jax.numpy for the
device path (it is pure/functional, so it jits and shard_maps; see parallel/).
"""

from __future__ import annotations

from dataclasses import dataclass

import os

import numpy as np

from ..circuit.gates import PublicInputGate
from ..circuit.algebra import BaseAlgebra
from ..fields import goldilocks as gl
from ..hash import merkle
from . import fri, ntt
from .challenger import Challenger
from .data import CircuitData

P = gl.P


# ---------------------------------------------------------------------------
# small pair/ext helpers
# ---------------------------------------------------------------------------

def _bc(pair, shape, xp):
    return (xp.broadcast_to(pair[0], shape), xp.broadcast_to(pair[1], shape))


def _prefix_sum_exclusive(lo, hi, xp):
    """Exclusive modular prefix SUM over the last axis (log-depth scan);
    the LogUp running-sum column Z (Z[0]=0, Z[i]=sum_{j<i} contrib[j])."""
    n = lo.shape[-1]
    shift = 1
    while shift < n:
        zlo = xp.zeros(lo.shape[:-1] + (shift,), xp.uint32)
        zhi = xp.zeros_like(zlo)
        slo = xp.concatenate([zlo, lo[..., :-shift]], -1)
        shi = xp.concatenate([zhi, hi[..., :-shift]], -1)
        lo, hi = gl.add(lo, hi, slo, shi)
        shift *= 2
    zlo = xp.zeros(lo.shape[:-1] + (1,), xp.uint32)
    zhi = xp.zeros_like(zlo)
    return (xp.concatenate([zlo, lo[..., :-1]], -1),
            xp.concatenate([zhi, hi[..., :-1]], -1))


def _prefix_prod_exclusive(lo, hi, xp):
    """Exclusive modular prefix product over the last axis (log-depth scan)."""
    n = lo.shape[-1]
    shift = 1
    while shift < n:
        olo = xp.ones(lo.shape[:-1] + (shift,), xp.uint32)
        ohi = xp.zeros_like(olo)
        slo = xp.concatenate([olo, lo[..., :-shift]], -1)
        shi = xp.concatenate([ohi, hi[..., :-shift]], -1)
        lo, hi = gl.mul(lo, hi, slo, shi)
        shift *= 2
    olo = xp.ones(lo.shape[:-1] + (1,), xp.uint32)
    ohi = xp.zeros_like(olo)
    return (xp.concatenate([olo, lo[..., :-1]], -1),
            xp.concatenate([ohi, hi[..., :-1]], -1))


def _suffix_prod_exclusive(lo, hi, xp):
    """Exclusive modular suffix product over the last axis (log-depth scan).

    Mirror of _prefix_prod_exclusive using only positive-offset slices:
    reverse (negative-stride) views feeding the doubling scan were once
    miscompiled at non-tile-aligned lengths (deterministically wrong values
    at k=155), so the reversed-prefix formulation is banned in device code
    (tests/test_lint_device_code.py)."""
    n = lo.shape[-1]
    shift = 1
    while shift < n:
        olo = xp.ones(lo.shape[:-1] + (shift,), xp.uint32)
        ohi = xp.zeros_like(olo)
        slo = xp.concatenate([lo[..., shift:], olo], -1)
        shi = xp.concatenate([hi[..., shift:], ohi], -1)
        lo, hi = gl.mul(lo, hi, slo, shi)
        shift *= 2
    olo = xp.ones(lo.shape[:-1] + (1,), xp.uint32)
    ohi = xp.zeros_like(olo)
    return (xp.concatenate([lo[..., 1:], olo], -1),
            xp.concatenate([hi[..., 1:], ohi], -1))


def _ext_from_base(pair, xp):
    z = (xp.zeros_like(pair[0]), xp.zeros_like(pair[1]))
    return (pair, z)


def _ext_index(e, sl):
    return ((e[0][0][sl], e[0][1][sl]), (e[1][0][sl], e[1][1][sl]))


def _ext_expand(e):
    return ((e[0][0][..., None], e[0][1][..., None]),
            (e[1][0][..., None], e[1][1][..., None]))


def _ext_bc(e, shape, xp):
    ee = _ext_expand(e)
    return (_bc(ee[0], shape, xp), _bc(ee[1], shape, xp))


@dataclass
class OpeningLayout:
    """Canonical poly order shared by openings + FRI reduction."""
    num_fixed: int
    num_wires: int
    num_zs_partials: int
    num_quotient: int

    @property
    def total(self):
        return self.num_fixed + self.num_wires + self.num_zs_partials + self.num_quotient

    def slices(self):
        o = 0
        out = {}
        for name, k in [("fixed", self.num_fixed), ("wires", self.num_wires),
                        ("zs_partials", self.num_zs_partials), ("quotient", self.num_quotient)]:
            out[name] = slice(o, o + k)
            o += k
        return out


@dataclass
class Proof:
    pis: np.ndarray          # [B, npis] u64
    wires_cap: tuple
    zs_cap: tuple
    quotient_cap: tuple
    openings0: tuple         # ext pair [B, layout.total] (everything at zeta)
    openings1: tuple         # ext pair [B, C] (Z polys at g*zeta)
    fri_proof: fri.FriProof
    initial_leaves: dict     # tree name -> (lo, hi) [B, Q, npolys]
    initial_paths: dict      # tree name -> (lo, hi) [B, Q, depth, 4]
    layout: OpeningLayout


class Backend:
    """Device-resident copies of the per-circuit fixed data (built once)."""

    def __init__(self, data: CircuitData, xp):
        self.xp = xp
        cvt = (lambda a: a) if xp is np else (lambda a: xp.asarray(a))

        def cpair(pair):
            return (cvt(pair[0]), cvt(pair[1]))

        self.fixed_lde = cpair(data.fixed_lde)
        self.fixed_coeffs = cpair(data.fixed_coeffs)
        self.fixed_levels = [cpair(l) for l in data.fixed_tree.levels]
        self.fixed_cap_height = data.fixed_tree.cap_height
        self.ids = cpair(gl.from_u64(data.id_encodings))
        nc = data.circuit.config.num_constant_cols
        S = len(data.circuit.gates)
        nr = data.circuit.config.num_routed_wires
        self.sig = cpair(gl.from_u64(data.fixed_values[nc + S : nc + S + nr]))
        self.x_pair = cpair(gl.from_u64(data.x_lde))
        self.zh_inv = cpair(data.zh_inv)
        self.l0_lde = cpair(data.l0_lde)

    @property
    def fixed_tree(self):
        return merkle.MerkleTree(levels=self.fixed_levels, cap_height=self.fixed_cap_height)

    # Backend is a pytree so jitted provers take it as an ARGUMENT: closing
    # over it would inline ~100s of MB of fixed-polynomial data as HLO
    # literals (blows up compile payloads and cache keys).
    _LEAF_FIELDS = ("fixed_lde", "fixed_coeffs", "fixed_levels", "ids", "sig",
                    "x_pair", "zh_inv", "l0_lde")

    def tree_flatten(self):
        return (tuple(getattr(self, f) for f in self._LEAF_FIELDS),
                (self.xp, self.fixed_cap_height))

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.xp, obj.fixed_cap_height = aux
        for f, v in zip(cls._LEAF_FIELDS, children):
            setattr(obj, f, v)
        return obj


def _lde_commit(vals_pair, n, N, cap_height, xp):
    """values on H [B, k, n] -> (coeffs, lde, tree)."""
    clo, chi = ntt.intt(*vals_pair)
    lde = ntt.coset_ntt_from_coeffs(clo, chi, N)
    tree = merkle.build_merkle_tree_from_polys(lde, cap_height, xp)
    return (clo, chi), lde, tree


# ---------------------------------------------------------------------------
# shard_map column/domain parallelism (parallel/mesh.py 'col' axis)
#
# Under shard_map the GSPMD partitioner is bypassed (per-shard module == the
# single-device module, so jit compile stays tractable) and the collectives
# are explicit: the polynomial-column axis shards for INTT/LDE work, the LDE
# domain axis shards for the pointwise stages (Merkle leaf sponge, quotient
# constraint eval, FRI reduced poly), with tiled all_gathers over the 'col'
# axis at stage boundaries.  `shard` is (axis_name, n_shards) or None.
# ---------------------------------------------------------------------------

def _shard_slice(pair, axis_name, ns, dim):
    """Local [.., k/ns, ..] slice of a (lo, hi) pair along `dim`."""
    import jax

    i = jax.lax.axis_index(axis_name)
    k = pair[0].shape[dim] // ns
    return (jax.lax.dynamic_slice_in_dim(pair[0], i * k, k, dim),
            jax.lax.dynamic_slice_in_dim(pair[1], i * k, k, dim))


def _shard_gather(pair, axis_name, dim):
    import jax

    return (jax.lax.all_gather(pair[0], axis_name, axis=dim, tiled=True),
            jax.lax.all_gather(pair[1], axis_name, axis=dim, tiled=True))


def _lde_commit_sharded(vals_pair, n, N, cap_height, xp, shard):
    """_lde_commit with the column axis sharded for INTT/LDE and the domain
    axis sharded for leaf hashing; bit-identical output on every shard."""
    ax, ns = shard
    k = vals_pair[0].shape[1]
    split_cols = k % ns == 0
    loc = _shard_slice(vals_pair, ax, ns, 1) if split_cols else vals_pair
    clo, chi = ntt.intt(*loc)
    lde_loc = ntt.coset_ntt_from_coeffs(clo, chi, N)
    if split_cols:
        coeffs = _shard_gather((clo, chi), ax, 1)
        lde = _shard_gather(lde_loc, ax, 1)
    else:
        coeffs, lde = (clo, chi), lde_loc
    # leaf digests: each shard hashes its N/ns domain slice of ALL columns
    dslice = _shard_slice(lde, ax, ns, 2)
    dlo, dhi = merkle.leaf_digests_from_polys(dslice[0], dslice[1], xp)
    dlo, dhi = _shard_gather((dlo, dhi), ax, -2)
    tree = merkle._build_tree_from_digests(dlo, dhi, cap_height, xp)
    return coeffs, lde, tree


def _lde_commit_wires_stream(vals_pair, n, N, cap_height, xp):
    """Streaming wires commitment: identical output to _lde_commit, but the
    INTT/LDE runs in rate-8 wire groups inside one fori_loop that absorbs
    each group straight into the Merkle leaf sponge.

    Peak temporaries are one [B, 8, N] group + the persistent outputs
    (coeffs / lde buffers, sponge state) instead of ~4 full [B, k, N]
    copies — the difference between B=8 and B=32 fitting in one chip's HBM."""
    from ..hash import poseidon

    if xp is np:
        return _lde_commit(vals_pair, n, N, cap_height, xp)
    import jax
    import jax.numpy as jnp
    from jax import lax

    B, k, _ = vals_pair[0].shape
    G = poseidon.RATE
    ngroups, rem = divmod(k, G)

    def group_lde(glo, ghi):
        clo, chi = ntt.intt(glo, ghi)
        lde = ntt.coset_ntt_from_coeffs(clo, chi, N)
        return (clo, chi), lde

    coeffs_lo = jnp.zeros((B, k, n), jnp.uint32)
    coeffs_hi = jnp.zeros((B, k, n), jnp.uint32)
    lde_lo = jnp.zeros((B, k, N), jnp.uint32)
    lde_hi = jnp.zeros((B, k, N), jnp.uint32)
    state_lo = jnp.zeros((poseidon.WIDTH, B, N), jnp.uint32)
    state_hi = jnp.zeros_like(state_lo)

    def body(i, carry):
        clo, chi, llo, lhi, slo, shi = carry
        off = i * G
        glo = lax.dynamic_slice_in_dim(vals_pair[0], off, G, axis=1)
        ghi = lax.dynamic_slice_in_dim(vals_pair[1], off, G, axis=1)
        (gclo, gchi), glde = group_lde(glo, ghi)
        clo = lax.dynamic_update_slice_in_dim(clo, gclo, off, axis=1)
        chi = lax.dynamic_update_slice_in_dim(chi, gchi, off, axis=1)
        llo = lax.dynamic_update_slice_in_dim(llo, glde[0], off, axis=1)
        lhi = lax.dynamic_update_slice_in_dim(lhi, glde[1], off, axis=1)
        slo = jnp.concatenate([jnp.moveaxis(glde[0], 1, 0), slo[G:]], 0)
        shi = jnp.concatenate([jnp.moveaxis(glde[1], 1, 0), shi[G:]], 0)
        slo, shi = poseidon.permute_stacked(slo, shi)
        return clo, chi, llo, lhi, slo, shi

    coeffs_lo, coeffs_hi, lde_lo, lde_hi, state_lo, state_hi = lax.fori_loop(
        0, ngroups, body,
        (coeffs_lo, coeffs_hi, lde_lo, lde_hi, state_lo, state_hi))

    if rem:
        off = ngroups * G
        glo = vals_pair[0][:, off:]
        ghi = vals_pair[1][:, off:]
        (gclo, gchi), glde = group_lde(glo, ghi)
        coeffs_lo = lax.dynamic_update_slice_in_dim(coeffs_lo, gclo, off, axis=1)
        coeffs_hi = lax.dynamic_update_slice_in_dim(coeffs_hi, gchi, off, axis=1)
        lde_lo = lax.dynamic_update_slice_in_dim(lde_lo, glde[0], off, axis=1)
        lde_hi = lax.dynamic_update_slice_in_dim(lde_hi, glde[1], off, axis=1)
        state_lo = jnp.concatenate([jnp.moveaxis(glde[0], 1, 0), state_lo[rem:]], 0)
        state_hi = jnp.concatenate([jnp.moveaxis(glde[1], 1, 0), state_hi[rem:]], 0)
        state_lo, state_hi = poseidon.permute_stacked(state_lo, state_hi)

    digests = (jnp.moveaxis(state_lo[:4], 0, -1), jnp.moveaxis(state_hi[:4], 0, -1))
    tree = merkle._build_tree_from_digests(digests[0], digests[1], cap_height, xp)
    return (coeffs_lo, coeffs_hi), (lde_lo, lde_hi), tree


def _lookup_polys_all(data: CircuitData, lk, wires_pair, alphas, xp):
    """LogUp committed columns for ALL challenges: per challenge, helpers
    h_0..h_{nb-1}, table helper h_tab = m/(alpha - t), running sum Z —
    values on H, [B, n] pairs, committed alongside the permutation Zs.

    h_b = sum over lookup gates g of sel_g * N_b^g / D_b^g (sel-masked so
    off-gate rows commit 0; the quotient constraints bind them on gate rows
    and the Z step uses sel_sum * sum_b h_b, so off-row junk cannot affect
    soundness either way).  All challenges' denominators share ONE Montgomery
    batch inversion (one Fermat ladder per proof batch)."""
    circuit = data.circuit
    n = data.n
    B = wires_pair[0].shape[0]
    nb = lk.num_batches
    BSZ = 3

    def asp(pair):
        return ((pair[0] if xp is np else xp.asarray(pair[0])),
                (pair[1] if xp is np else xp.asarray(pair[1])))

    shape = (B, n)
    lb = circuit.config.range_lookup_limb_bits
    tvals = np.arange(n, dtype=np.uint64)
    tvals[1 << lb:] = 0   # t(x) = canonical row index (padding rows -> 0)
    tpair = asp(gl.from_u64(tvals))
    sels = [asp(gl.from_u64(circuit.selectors[gi])) for gi, _g in lk.gates]

    per_c = []   # (gate_Ns, dt) per challenge; D blocks go to the inverse
    inv_lo, inv_hi = [], []
    for alpha in alphas:
        a2 = (alpha[0][:, None], alpha[1][:, None])
        a4 = (alpha[0][:, None, None], alpha[1][:, None, None])
        gate_Ns = []
        for g, (gi, g_) in enumerate(lk.gates):
            colsg, scales = g_.lookup_cols_scales(nb)
            w = (wires_pair[0][:, colsg], wires_pair[1][:, colsg])  # [B, T, n]
            sc = asp(gl.from_u64(np.array(scales, np.uint64)))
            f = gl.mul(*w, sc[0][None, :, None], sc[1][None, :, None])
            d = gl.sub(*_bc(a4, f[0].shape, xp), *f)                # [B, T, n]
            d3l = d[0].reshape(B, nb, BSZ, n)
            d3h = d[1].reshape(B, nb, BSZ, n)
            d0 = (d3l[:, :, 0], d3h[:, :, 0])
            d1 = (d3l[:, :, 1], d3h[:, :, 1])
            d2 = (d3l[:, :, 2], d3h[:, :, 2])
            d01 = gl.mul(*d0, *d1)
            D = gl.mul(*d01, *d2)
            Ng = gl.add(*d01, *gl.mul(*gl.add(*d0, *d1), *d2))
            inv_lo.append(D[0])
            inv_hi.append(D[1])
            gate_Ns.append(Ng)
        dt = gl.sub(*_bc(a2, shape, xp), *_bc(tpair, shape, xp))
        inv_lo.append(dt[0][:, None])
        inv_hi.append(dt[1][:, None])
        per_c.append(gate_Ns)

    inv = _batch_inverse_axis1((xp.concatenate(inv_lo, 1),
                                xp.concatenate(inv_hi, 1)), xp)
    G = len(lk.gates)
    stride = G * nb + 1
    out = []
    for c, gate_Ns in enumerate(per_c):
        base = c * stride
        helpers = (xp.zeros((B, nb, n), xp.uint32),
                   xp.zeros((B, nb, n), xp.uint32))
        for g, Ng in enumerate(gate_Ns):
            lo0 = base + g * nb
            Dinv = (inv[0][:, lo0 : lo0 + nb], inv[1][:, lo0 : lo0 + nb])
            sel = sels[g]
            term = gl.mul(*gl.mul(*Ng, *Dinv),
                          sel[0][None, None], sel[1][None, None])
            helpers = gl.add(*helpers, *term)
        cols = [(helpers[0][:, b], helpers[1][:, b]) for b in range(nb)]
        hsum = _sum_pairs_axis(*helpers, 1, xp)
        m = (wires_pair[0][:, lk.mult_col], wires_pair[1][:, lk.mult_col])
        dt_inv = (inv[0][:, base + G * nb], inv[1][:, base + G * nb])
        h_tab = gl.mul(*m, *dt_inv)
        cols.append(h_tab)
        contrib = gl.sub(*hsum, *h_tab)
        Z = _prefix_sum_exclusive(*contrib, xp)
        cols.append(Z)
        out.append(cols)
    return out


def host_prep(data: CircuitData, W, pis: np.ndarray):
    """Host-side prep: witness/PI tensors -> u32-pair device inputs.

    W: [num_wires, n, B] uint64, or an already-prepared (lo, hi) u32 pair in
    [B, wires, n] layout (from Circuit.generate_witness_pair — the native
    scatter path).  pis: [B, npis] uint64.
    Returns (wires_pair [B,wires,n], pi_pair [B,K,n], pis_pair [B,npis])."""
    circuit = data.circuit
    n = data.n
    if isinstance(W, tuple):
        wires_pair = W
        B = W[0].shape[0]
    else:
        B = W.shape[-1]
        wires_u64 = np.ascontiguousarray(np.moveaxis(W, -1, 0))  # [B, wires, n]
        wires_pair = gl.from_u64(wires_u64)
    K = circuit.pi.num_cols
    pi_vals = np.zeros((B, K, n), np.uint64)
    for blk, row in enumerate(circuit.pi.rows):
        for j in range(K):
            idx = blk * K + j
            if idx < circuit.pi.count:
                pi_vals[:, j, row] = pis[:, idx]
    pi_pair = gl.from_u64(pi_vals)
    pis_pair = gl.from_u64(pis)
    return wires_pair, pi_pair, pis_pair


def prove(data: CircuitData, W: np.ndarray, pis: np.ndarray, xp=np,
          backend: Backend | None = None) -> Proof:
    """W: witness matrix [num_wires, n, B] uint64 (host); pis: [B, npis] u64."""
    if os.environ.get("PLONKY2_DEBUG") == "1" and not isinstance(W, tuple):
        from ..utils.debug import assert_witness_ok

        assert_witness_ok(data.circuit, W)
    wires_pair, pi_pair, pis_pair = host_prep(data, W, pis)
    if xp is not np:
        wires_pair = (xp.asarray(wires_pair[0]), xp.asarray(wires_pair[1]))
        pi_pair = (xp.asarray(pi_pair[0]), xp.asarray(pi_pair[1]))
        pis_pair = (xp.asarray(pis_pair[0]), xp.asarray(pis_pair[1]))
    if backend is None:
        backend = Backend(data, xp)
    out = prove_core(data, backend, wires_pair, pi_pair, pis_pair, xp)
    out.pis = np.asarray(pis)
    return out


def prove_core(data: CircuitData, bk: Backend, wires_pair, pi_pair, pis_pair,
               xp, stop_after: str | None = None,
               stream_commit: bool = True, shard=None) -> Proof:
    """Pure tensor pipeline: (wires, pi polys, pi values) pairs -> Proof.
    Jit-able for a fixed circuit shape.  stop_after: compile-time debug knob
    ('commit'|'zs'|'quotient'|'openings'|'fri') to truncate the pipeline.
    stream_commit: use the fori_loop streaming wires commitment (single-chip
    memory optimization).  shard: (axis_name, n_shards) when running inside a
    shard_map over a column-parallel mesh axis (see parallel/mesh.py): the
    heavy per-column / per-domain-point stages split over that axis with
    explicit all_gathers, everything else computes replicated."""
    circuit = data.circuit
    cfg = circuit.config
    n, N = data.n, data.N
    C = cfg.num_challenges
    nr = cfg.num_routed_wires
    chunk = cfg.permutation_chunk_size
    nchunks = nr // chunk
    B = wires_pair[0].shape[0]
    caph = cfg.fri.cap_height

    if shard is not None:
        def commit_fn(v, n_, N_, c_, x_):
            return _lde_commit_sharded(v, n_, N_, c_, x_, shard)
    else:
        commit_fn = _lde_commit_wires_stream if stream_commit else _lde_commit
    wires_coeffs, wires_lde, wires_tree = commit_fn(wires_pair, n, N, caph, xp)
    if stop_after == 'commit':
        return wires_tree.cap

    pi_clo, pi_chi = ntt.intt(*pi_pair)
    pi_lde = ntt.coset_ntt_from_coeffs(pi_clo, pi_chi, N)

    # ---- transcript --------------------------------------------------------
    ch = Challenger(xp, (B,))
    fixed_cap = bk.fixed_levels[-1]
    ch.observe_cap((xp.broadcast_to(fixed_cap[0], (B,) + fixed_cap[0].shape),
                    xp.broadcast_to(fixed_cap[1], (B,) + fixed_cap[1].shape)))
    ch.observe_array(pis_pair)
    ch.observe_cap(wires_tree.cap)
    betas, gammas = [], []
    for _ in range(C):
        betas.append(ch.get_challenge())
        gammas.append(ch.get_challenge())
    lk = data.lookup
    lk_alphas = [ch.get_challenge() for _ in range(C)] if lk is not None else []
    if stop_after == 'challenges':
        return betas, gammas, lk_alphas

    # ---- permutation grand products ---------------------------------------
    routed = (wires_pair[0][:, :nr], wires_pair[1][:, :nr])  # [B, nr, n]
    rshape = routed[0].shape
    zs_list_lo, zs_list_hi = [], []
    for c in range(C):
        beta = (betas[c][0][:, None, None], betas[c][1][:, None, None])
        gamma = (gammas[c][0][:, None, None], gammas[c][1][:, None, None])
        bid = gl.mul(*_bc(bk.ids, rshape, xp), *_bc(beta, rshape, xp))
        bsg = gl.mul(*_bc(bk.sig, rshape, xp), *_bc(beta, rshape, xp))
        f = gl.add(*gl.add(*routed, *bid), *_bc(gamma, rshape, xp))
        g_ = gl.add(*gl.add(*routed, *bsg), *_bc(gamma, rshape, xp))
        fP = _chunk_prod(f, chunk)
        gP = _chunk_prod(g_, chunk)
        quot = gl.mul(*fP, *_batch_inverse_axis1(gP, xp))
        Rlo, Rhi = [quot[0][:, 0]], [quot[1][:, 0]]
        for t in range(1, nchunks):
            nl, nh = gl.mul(Rlo[-1], Rhi[-1], quot[0][:, t], quot[1][:, t])
            Rlo.append(nl)
            Rhi.append(nh)
        zlo, zhi = _prefix_prod_exclusive(Rlo[-1], Rhi[-1], xp)
        zs_list_lo.append(zlo)
        zs_list_hi.append(zhi)
        for t in range(nchunks - 1):
            plo, phi = gl.mul(zlo, zhi, Rlo[t], Rhi[t])
            zs_list_lo.append(plo)
            zs_list_hi.append(phi)
    if lk is not None:
        for cols in _lookup_polys_all(data, lk, wires_pair, lk_alphas, xp):
            for plo, phi in cols:
                zs_list_lo.append(plo)
                zs_list_hi.append(phi)
    zs_vals = (xp.stack(zs_list_lo, 1), xp.stack(zs_list_hi, 1))
    if stop_after == 'zs_vals':
        return zs_vals
    if shard is not None:
        zs_coeffs, zs_lde, zs_tree = _lde_commit_sharded(zs_vals, n, N, caph, xp, shard)
    elif B >= 48:
        # large batches: the plain commit holds ~4 full [B, k, N] copies of
        # the zs columns live at once; the streaming (fori_loop) commit is
        # bit-identical and bounds peak device memory
        zs_coeffs, zs_lde, zs_tree = _lde_commit_wires_stream(zs_vals, n, N, caph, xp)
    else:
        zs_coeffs, zs_lde, zs_tree = _lde_commit(zs_vals, n, N, caph, xp)
    if stop_after == 'zs':
        return zs_tree.cap
    ch.observe_cap(zs_tree.cap)
    alphas = [ch.get_challenge() for _ in range(C)]

    # ---- quotient ----------------------------------------------------------
    quot_vals = _compute_quotient(data, bk, wires_lde, zs_lde, pi_lde,
                                  betas, gammas, alphas, B, xp, shard,
                                  lk_alphas)
    qc = ntt.coset_intt(*quot_vals)  # [B, C, N]
    rate = N // n
    chunks_lo = qc[0].reshape(B, C * rate, n)
    chunks_hi = qc[1].reshape(B, C * rate, n)
    quot_lde = ntt.coset_ntt_from_coeffs(chunks_lo, chunks_hi, N)
    if shard is not None:
        dsl = _shard_slice(quot_lde, shard[0], shard[1], 2)
        dlo, dhi = merkle.leaf_digests_from_polys(dsl[0], dsl[1], xp)
        dlo, dhi = _shard_gather((dlo, dhi), shard[0], -2)
        quot_tree = merkle._build_tree_from_digests(dlo, dhi, caph, xp)
    else:
        quot_tree = merkle.build_merkle_tree_from_polys(quot_lde, caph, xp)
    ch.observe_cap(quot_tree.cap)
    if stop_after == 'quotient':
        return quot_tree.cap
    zeta = ch.get_ext()

    # ---- openings ----------------------------------------------------------
    layout = OpeningLayout(
        num_fixed=data.fixed_values.shape[0],
        num_wires=cfg.num_wires,
        num_zs_partials=int(zs_vals[0].shape[1]),
        num_quotient=C * rate,
    )
    zpows = ntt.ext_powers(zeta, n)
    zp = _ext_expand_mid(zpows)
    open_fixed = ntt.eval_poly_ext(bk.fixed_coeffs[0][None], bk.fixed_coeffs[1][None], zp)
    open_wires = ntt.eval_poly_ext(*wires_coeffs, zp)
    open_zs = ntt.eval_poly_ext(*zs_coeffs, zp)
    open_quot = ntt.eval_poly_ext(chunks_lo, chunks_hi, zp)
    gz = _ext_mul_base_const(zeta, data.g)
    gzp = _ext_expand_mid(ntt.ext_powers(gz, n))
    z_idx = [c * nchunks for c in range(C)]
    if lk is not None:
        cpc = lk.cols_per_challenge
        z_idx += [C * nchunks + c * cpc + cpc - 1 for c in range(C)]
    zonly = (zs_coeffs[0][:, z_idx], zs_coeffs[1][:, z_idx])
    open_zs_gzeta = ntt.eval_poly_ext(*zonly, gzp)

    openings0 = _ext_concat([open_fixed, open_wires, open_zs, open_quot], xp)
    if stop_after == 'openings':
        return openings0
    ch.observe_ext_array(openings0)
    ch.observe_ext_array(open_zs_gzeta)

    # ---- FRI ---------------------------------------------------------------
    F = _reduced_poly(data, bk, layout, wires_lde, zs_lde, quot_lde, openings0,
                      open_zs_gzeta, zeta, gz, ch.get_ext(), z_idx, B, xp, shard)
    fri_proof = fri.fri_prove(ch, F, N, cfg, xp)
    if stop_after == 'fri':
        # NOTE: returning only the caps lets XLA dead-code-eliminate the
        # PoW grind + query-index/leaf/path work (they feed nothing here);
        # use 'fri_all' to include them in a stage measurement.
        return fri_proof.caps
    if stop_after == 'fri_all':
        return fri_proof

    # ---- initial tree openings ---------------------------------------------
    idx = fri_proof.indices  # [B, Q] int32/int64 array (device ok)
    initial_leaves = {}
    initial_paths = {}
    trees = {
        "fixed": (bk.fixed_lde, bk.fixed_tree, False),
        "wires": (wires_lde, wires_tree, True),
        "zs": (zs_lde, zs_tree, True),
        "quot": (quot_lde, quot_tree, True),
    }
    # Plain take_along gathers, one per tree (tree.open is PACKED,
    # merkle._open_packed).  Integer gathers keep the path exact: a one-hot
    # float-matmul formulation would need precision=HIGHEST to stay exact.
    take = np.take_along_axis if xp is np else _jnp_take_along_axis
    for name, (lde, tree, batched) in trees.items():
        lo, hi = lde
        if batched:
            leaf_lo = take(lo, idx[:, None, :], -1)  # [B, k, Q]
            leaf_hi = take(hi, idx[:, None, :], -1)
            initial_leaves[name] = (xp.moveaxis(leaf_lo, 1, 2), xp.moveaxis(leaf_hi, 1, 2))
        else:
            leaf_lo = lo[:, idx]  # [k, B, Q]
            leaf_hi = hi[:, idx]
            initial_leaves[name] = (xp.moveaxis(leaf_lo, 0, 2), xp.moveaxis(leaf_hi, 0, 2))
        initial_paths[name] = tree.open(idx)

    return Proof(
        pis=None,
        wires_cap=wires_tree.cap,
        zs_cap=zs_tree.cap,
        quotient_cap=quot_tree.cap,
        openings0=openings0,
        openings1=open_zs_gzeta,
        fri_proof=fri_proof,
        initial_leaves=initial_leaves,
        initial_paths=initial_paths,
        layout=layout,
    )


def _jnp_take_along_axis(arr, idx, axis):
    import jax.numpy as jnp

    return jnp.take_along_axis(arr, idx, axis=axis)


# ---------------------------------------------------------------------------
# JAX integration: pytree registration + jitted prover factory
# ---------------------------------------------------------------------------

_PYTREES_DONE = False


def _register_pytrees():
    global _PYTREES_DONE
    if _PYTREES_DONE:
        return
    import jax

    jax.tree_util.register_pytree_node(
        Backend, Backend.tree_flatten, Backend.tree_unflatten)
    jax.tree_util.register_pytree_node(
        fri.FriProof,
        lambda p: ((p.caps, p.final_coeffs, p.indices, p.layer_leaves,
                    p.layer_paths, p.pow_witness), None),
        lambda aux, ch: fri.FriProof(*ch),
    )
    jax.tree_util.register_pytree_node(
        Proof,
        lambda p: ((p.pis, p.wires_cap, p.zs_cap, p.quotient_cap, p.openings0,
                    p.openings1, p.fri_proof, p.initial_leaves, p.initial_paths),
                   p.layout),
        lambda aux, ch: Proof(*ch, layout=aux),
    )
    _PYTREES_DONE = True


def prover_tables(data: CircuitData, jnp):
    """Device-resident NTT/FRI table pytree passed to the jitted prover as an
    argument (keeps the traced HLO free of ~100 MB of table literals)."""
    import jax

    cfg = data.circuit.config
    _nl, final_size, _nf = fri.plan(data.N, cfg)
    tabs = {**ntt.host_tables([data.n, data.N, final_size]),
            **fri.host_tables(data.N, cfg)}
    return jax.tree_util.tree_map(jnp.asarray, tabs)


# Tape-op output roles whose values are structurally < 2^32 (29-bit limbs,
# booleans, small in-gate carries, lookup multiplicities).  Used to split the
# witness upload into a u32 plane + a narrow u64 remainder; every claim here
# is backed by an assert in the corresponding host fill (the reference's
# debug-assertion contracts, e.g. mul_nonnative.rs:274-277) AND re-checked
# loudly at dispatch time (_vals_split).
_NARROW_ROLES = {
    "mul_nn": ("q", "r"),            # 29-bit limbs (carries are 34-bit: wide)
    "inv_nn": ("inv", "q"),
    "add_nn": ("s", "ovf", "c"),
    "sub_nn": ("s", "ovf", "c"),
    "add_many_nn": ("s", "ovf"),     # its in-gate carries can exceed 32 bits
    "cmp_const": ("d", "brw", "le"),
    "split": ("bits",),
    "is_equal": ("eq",),
    "lookup_mult": ("m_ts",),
    "range_lookup": ("limbs",),      # device-derived (dropped from upload)
    "random_access": ("bits",),
}


def _narrow_mask(circuit) -> np.ndarray:
    """[num_targets] bool: True where the value-table slot is statically
    known < 2^32 (by tape-op semantics or constant value)."""
    mask = np.zeros(circuit.num_targets, bool)
    rm = circuit.read_map

    def mark(v):
        ids = np.ravel(np.asarray(v, dtype=np.int64))
        mask[rm[ids]] = True

    for op in circuit.tape:
        if op.rec is None:
            continue
        kind, payload = op.rec
        for role in _NARROW_ROLES.get(kind, ()):
            if role in payload:
                mark(payload[role])
    for tid, v in circuit.constant_values.items():
        if int(v) < 1 << 32:
            mask[rm[tid]] = True
    return mask


def _scatter_maps(data: CircuitData):
    """Static gather maps realizing the witness scatter ON DEVICE.

    The tape's value table is far smaller than the full wire tensor
    [B, wires, n]; shipping it compacted and gathering on device cuts the
    host->device transfer per batch accordingly.  Targets listed in
    circuit.derived_tids (range-check base-4 limbs — ~78% of all targets in
    the ECDSA circuit) are excluded entirely: the device derives them from
    the value wires after the gather.  The last compact index is a zero slot
    for unpopulated cells (incl. derived positions before derivation)."""
    circuit = data.circuit
    cfg = circuit.config
    n = data.n
    T = circuit.num_targets
    # Upload only table rows the device actually gathers (wire positions,
    # PI positions, PI values): the raw table also holds union-find duplicate
    # rows and tape intermediates that never reach a wire — dead weight on
    # the host->device link.
    keep_mask = np.zeros(T, bool)
    keep_mask[circuit.pos_tids] = True
    keep_mask[circuit.pi_tids] = True
    keep_mask[circuit.derived_tids] = False
    # Order kept slots [narrow | wide] so the upload ships one u32 plane for
    # the (statically classified) <2^32 values and u32 pairs only for the
    # rest — less host->device traffic per batch.
    narrow = _narrow_mask(circuit)
    keep_ids = np.concatenate([np.nonzero(keep_mask & narrow)[0],
                               np.nonzero(keep_mask & ~narrow)[0]])
    num_narrow = int((keep_mask & narrow).sum())
    Kc = len(keep_ids)
    new_of = np.full(T + 1, Kc, np.int64)  # default -> zero slot
    new_of[keep_ids] = np.arange(Kc)
    imap = np.full(cfg.num_wires * n, Kc, np.int32)
    imap[circuit.pos_cols * n + circuit.pos_rows] = new_of[circuit.pos_tids]
    K = circuit.pi.num_cols
    imap_pi = np.full(K * n, Kc, np.int32)
    for blk, row in enumerate(circuit.pi.rows):
        for j in range(K):
            idx = blk * K + j
            if idx < circuit.pi.count:
                imap_pi[j * n + row] = new_of[circuit.pi_tids[idx]]
    pit = new_of[circuit.pi_tids].astype(np.int32)
    layouts = sorted(circuit.range_layouts.items())  # [(bits, (V, nl, lb, rows))]
    rows_arrays = [np.asarray(rows, np.int32) for _, (_V, _nl, _lb, rows) in layouts]
    layout_meta = tuple((bits, V, nl, lb) for bits, (V, nl, lb, _r) in layouts)
    return imap, imap_pi, pit, keep_ids, num_narrow, rows_arrays, layout_meta


def _pack_spec(proof_struct):
    """(treedef, shapes, dtypes) for packing a traced Proof into ONE u32
    buffer: one device->host copy instead of one per proof leaf (~100)."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(proof_struct)
    shapes = [tuple(l.shape) for l in leaves]
    dtypes = [np.dtype(l.dtype) for l in leaves]
    return treedef, shapes, dtypes


def _pack_proof(proof, xp):
    import jax

    leaves = jax.tree_util.tree_leaves(proof)
    flat = [l.astype(xp.uint32).reshape(-1) for l in leaves]
    return xp.concatenate(flat) if flat else xp.zeros((0,), xp.uint32)


def _unpack_proof(buf: np.ndarray, spec):
    import jax

    treedef, shapes, dtypes = spec
    out = []
    off = 0
    for shape, dt in zip(shapes, dtypes):
        k = int(np.prod(shape)) if shape else 1
        out.append(buf[off : off + k].astype(dt).reshape(shape))
        off += k
    return jax.tree_util.tree_unflatten(treedef, out)


class _NarrowMisclassification(AssertionError):
    """A statically narrow-classified witness value exceeded 32 bits."""


def _check_grind(proof):
    """Raise loudly if any lane's device PoW grind exhausted its candidate
    space (challenger.GRIND_EXHAUSTED sentinel; the numpy path raises the
    same error inline)."""
    from .challenger import GRIND_EXHAUSTED

    pw = proof.fri_proof.pow_witness
    if pw is not None and np.any(np.asarray(pw[0]) == np.uint32(GRIND_EXHAUSTED)):
        raise AssertionError("PoW grind exhausted candidate space")


def make_jit_prover(data: CircuitData):
    """Returns prove_fn(W, pis) running the full pipeline under jax.jit.

    The circuit's fixed data lives on device as a Backend pytree passed BY
    ARGUMENT (not closure, to keep the HLO free of giant literals); the
    function recompiles only if the witness batch size changes.

    The returned fn also exposes `.run_vals(vals, pis)` taking the tape's
    raw value table [T, B] u64 — the production path: the wire/PI tensors
    are then built on device from static gather maps, minimizing upload."""
    import jax
    import jax.numpy as jnp

    _register_pytrees()
    bk = Backend(data, jnp)
    circuit = data.circuit
    n = data.n
    K = circuit.pi.num_cols
    cfgw = circuit.config.num_wires
    # Platform split: on CPU (tests/CI) the fixed data + tables stay closure
    # literals — XLA:CPU folds them and compiles fastest.  On the GPU they
    # are passed as jit ARGUMENTS: the module then holds no ~100 MB of
    # constants, so it compiles without folding them, and its persistent
    # cache key does not hash them.
    use_params = jax.devices()[0].platform != "cpu"

    (imap, imap_pi, pi_tids32, keep_ids, num_narrow, rows_arrays,
     layout_meta) = _scatter_maps(data)
    keep_n, keep_w = keep_ids[:num_narrow], keep_ids[num_narrow:]
    maps = (jnp.asarray(imap), jnp.asarray(imap_pi), jnp.asarray(pi_tids32),
            tuple(jnp.asarray(r) for r in rows_arrays))
    spec_cell: dict = {}

    def _derive_range_limbs(wl, wh, rows_dev):
        """Recompute range-lookup limb wires from the value wires (limb j of
        v = (v >> lb*j) & (2^lb - 1); they were dropped from the upload)."""
        B = wl.shape[0]
        for (bits, V, nl, lb), rows in zip(layout_meta, rows_dev):
            vlo = wl[:, :V][:, :, rows]  # [B, V, R]
            vhi = wh[:, :V][:, :, rows]
            mask = np.uint32((1 << lb) - 1)
            limbs = []
            for j in range(nl):
                sh = lb * j
                if sh == 0:
                    lv = vlo
                elif sh < 32:
                    lv = (vlo >> np.uint32(sh)) | (vhi << np.uint32(32 - sh))
                else:
                    lv = vhi >> np.uint32(sh - 32)
                limbs.append(lv & mask)
            st = jnp.stack(limbs, 2).reshape(B, V * nl, rows.shape[0])
            wl = wl.at[:, V : V + V * nl, rows].set(st)
            # hi halves of limbs (< 2^lb <= 2^13) are zero: the zero slot
            # already put 0s there
        return wl, wh

    def _expand(maps, vals_split):
        im, ipi, pit, rows_dev = maps
        vn, wlo, whi = vals_split  # [B,Tn] u32, [B,Tw+1] u32 pair (zero slot)
        vals_pair = (jnp.concatenate([vn, wlo], axis=1),
                     jnp.concatenate([jnp.zeros_like(vn), whi], axis=1))
        B = vals_pair[0].shape[0]
        wl = vals_pair[0][:, im].reshape(B, cfgw, n)
        wh = vals_pair[1][:, im].reshape(B, cfgw, n)
        wl, wh = _derive_range_limbs(wl, wh, rows_dev)
        pi_pair = (vals_pair[0][:, ipi].reshape(B, K, n),
                   vals_pair[1][:, ipi].reshape(B, K, n))
        pis_pair = (vals_pair[0][:, pit], vals_pair[1][:, pit])
        return (wl, wh), pi_pair, pis_pair

    if use_params:
        tabs = prover_tables(data, jnp)

        @jax.jit
        def jcore(bk, tabs, wires_pair, pi_pair, pis_pair):
            tok = ntt._DEVICE_TABLES.set(tabs)
            try:
                return prove_core(data, bk, wires_pair, pi_pair, pis_pair, jnp)
            finally:
                ntt._DEVICE_TABLES.reset(tok)

        def core(wires_pair, pi_pair, pis_pair):
            return jcore(bk, tabs, wires_pair, pi_pair, pis_pair)

        @jax.jit
        def jcore_vals(bk, tabs, maps, vals_pair):
            tok = ntt._DEVICE_TABLES.set(tabs)
            try:
                proof = prove_core(data, bk, *_expand(maps, vals_pair), jnp)
            finally:
                ntt._DEVICE_TABLES.reset(tok)
            spec_cell["spec"] = _pack_spec(proof)
            return _pack_proof(proof, jnp)

        def core_vals(vals_pair):
            return jcore_vals(bk, tabs, maps, vals_pair)

        def lower_core_vals(vals_pair):
            return jcore_vals.lower(bk, tabs, maps, vals_pair)
    else:
        @jax.jit
        def core(wires_pair, pi_pair, pis_pair):
            return prove_core(data, bk, wires_pair, pi_pair, pis_pair, jnp)

        @jax.jit
        def core_vals(vals_pair):
            proof = prove_core(data, bk, *_expand(maps, vals_pair), jnp)
            spec_cell["spec"] = _pack_spec(proof)
            return _pack_proof(proof, jnp)

        lower_core_vals = core_vals.lower

    def run(W, pis: np.ndarray) -> Proof:
        wires_pair, pi_pair, pis_pair = host_prep(data, W, pis)
        proof = core(wires_pair, pi_pair, pis_pair)
        # device_get: one bulk readback instead of one per proof array.
        proof = jax.device_get(proof)
        proof.pis = np.asarray(pis)
        _check_grind(proof)
        return proof

    def _vals_split(vals: np.ndarray):
        """[T, B] u64 value table -> (narrow u32 [B,Tn], wide pair [B,Tw+1]).

        The narrow plane's <2^32 claim comes from static tape-op semantics
        (_NARROW_ROLES); re-checked here so a misclassification is caught
        loudly instead of silently truncating a witness value."""
        vn = vals[keep_n]
        over = vn >> np.uint64(32)
        if over.any():
            bad = keep_n[np.nonzero(over.any(axis=1))[0][:5]]
            raise _NarrowMisclassification(
                f"narrow-classified witness targets exceed 32 bits: {bad}")
        w = np.zeros((vals.shape[1], len(keep_w) + 1), np.uint64)
        w[:, :-1] = vals[keep_w].T
        wlo, whi = gl.from_u64(w)
        return vn.T.astype(np.uint32), wlo, whi

    _expand_map_cell: dict = {}

    def _expand_host(vals: np.ndarray):
        """Availability fallback: expand the value table to the
        full [num_wires, n, B] witness on the HOST (raw table rows via
        read_map — derived range limbs are present in the raw table) so a
        narrow-plane misclassification degrades to the wide `run()` path
        instead of aborting the prove.  Slower (bigger upload + separate jit
        module) but correct for any value range."""
        if "map" not in _expand_map_cell:
            full = np.full(cfgw * n, vals.shape[0], np.int64)  # -> zero slot
            full[circuit.pos_cols * n + circuit.pos_rows] = \
                circuit.read_map[circuit.pos_tids]
            _expand_map_cell["map"] = full
        B = vals.shape[1]
        vz = np.concatenate([vals, np.zeros((1, B), np.uint64)])
        return vz[_expand_map_cell["map"], :].reshape(cfgw, n, B)

    def dispatch_vals(vals: np.ndarray, pis: np.ndarray):
        """Async: upload the COMPACTED value table (derived targets dropped,
        u32 plane for statically-narrow values) + enqueue the prove; returns
        a handle for collect().  Dispatching batch k+1 before collecting
        batch k pipelines upload/compute/readback across batches.

        Availability fallback caveat: on a narrow-plane
        misclassification this falls back to the wide path SYNCHRONOUSLY —
        the warning line also means the pipeline stalls behind this batch,
        and the first occurrence pays a second full jit compile of the wide
        `core` module (minutes)."""
        try:
            return ("vals", core_vals(_vals_split(vals))), pis
        except _NarrowMisclassification as e:
            import sys

            print(f"[prover] WARNING: {e}; falling back to the wide witness "
                  "path for this batch", file=sys.stderr)
            return ("wide", run(_expand_host(vals), pis)), pis

    def collect(handle) -> Proof:
        (kind, payload), pis = handle
        if kind == "wide":  # fallback path already produced a host Proof
            return payload
        proof = _unpack_proof(np.asarray(payload), spec_cell["spec"])
        proof.pis = np.asarray(pis)
        _check_grind(proof)
        return proof

    def run_vals(vals: np.ndarray, pis: np.ndarray) -> Proof:
        """vals: the tape's value table [T, B] u64 (Circuit._run_tape).
        Ships ~17x less data up than the expanded wire tensors and reads the
        proof back as ONE packed buffer."""
        return collect(dispatch_vals(vals, pis))

    def lower_vals(vals: np.ndarray):
        """jax `Lowered` of the production (run_vals) step for this value
        table's batch size: `.compile()` it to time the compile or read its
        memory_analysis(); later run_vals calls reuse the compiled step."""
        return lower_core_vals(_vals_split(vals))

    run.core = core
    run.lower_vals = lower_vals
    run.run_vals = run_vals
    run.dispatch_vals = dispatch_vals
    run.collect = collect
    run.backend = bk
    return run


def _ext_expand_mid(zpows):
    """[B, n] ext powers -> [B, 1, n] for broadcasting over a poly axis."""
    return ((zpows[0][0][:, None], zpows[0][1][:, None]),
            (zpows[1][0][:, None], zpows[1][1][:, None]))


def _prod_last(lo, hi):
    """Modular product over the last axis (power-of-two length, log depth)."""
    while lo.shape[-1] > 1:
        k = lo.shape[-1] // 2
        lo, hi = gl.mul(lo[..., :k], hi[..., :k], lo[..., k:], hi[..., k:])
    return lo[..., 0], hi[..., 0]


def _sum_pairs_axis(lo, hi, axis, xp):
    """Modular sum of a (lo, hi) pair over `axis` (log-depth tree)."""
    from .ntt import _sum_last

    return _sum_last((xp.moveaxis(lo, axis, -1), xp.moveaxis(hi, axis, -1)), xp)


def _seal(pair, xp):
    """Fusion fence (identity): jax.lax.optimization_barrier on device paths.

    Miscompile guard, found in round 3 on the first accelerator this prover
    ran on: at the full ECDSA-circuit scale with B=32 lanes, fusing the
    Montgomery batch-inversion chain into its consumers (quotient/grand-
    product muls) produced DETERMINISTICALLY WRONG inverse values, while the
    same HLO on XLA:CPU was bit-exact vs numpy.  Sealing the inverse output
    is an identity op that only pins a fusion boundary; its cost on the GPU
    is not measured yet."""
    if xp is np:
        return pair
    import jax

    return tuple(jax.lax.optimization_barrier(pair))


def _batch_inverse_axis1(pair, xp):
    """Montgomery batch inversion along axis 1 of [B, k, n] pairs: one
    Fermat ladder on the k-product instead of k ladders, with the prefix and
    suffix product chains computed as LOG-DEPTH doubling scans (2*ceil(log2 k)
    tensor muls instead of 2k — at the LogUp helper width k~77 the sequential
    form dominated the traced module).  inv_i = prefix_i * suffix_i * tot^-1.

    Output is _seal'd: fused-into-consumer compilation of this chain was
    once miscompiled at large batch shapes (see _seal)."""
    lo, hi = pair
    k = lo.shape[1]
    if k == 1:
        return _seal(gl.inverse(lo, hi), xp)
    lo, hi = _seal((lo, hi), xp)  # fence the producer graph out, too
    plo, phi = xp.moveaxis(lo, 1, -1), xp.moveaxis(hi, 1, -1)  # [B, n, k]
    pre = _prefix_prod_exclusive(plo, phi, xp)
    suf = _suffix_prod_exclusive(plo, phi, xp)
    tot = gl.mul(pre[0][..., -1], pre[1][..., -1], plo[..., -1], phi[..., -1])
    tinv = gl.inverse(*tot)
    a = gl.mul(*pre, *suf)
    o = gl.mul(*a, tinv[0][..., None], tinv[1][..., None])
    return _seal((xp.moveaxis(o[0], -1, 1), xp.moveaxis(o[1], -1, 1)), xp)


def _chunk_prod(pair, chunk):
    """[B, nr, n] -> per-chunk products [B, nr/chunk, n], log-depth."""
    B, nr, n = pair[0].shape
    lo = pair[0].reshape(B, nr // chunk, chunk, n)
    hi = pair[1].reshape(B, nr // chunk, chunk, n)
    xp = gl._xp(lo, hi)
    return _prod_last(xp.moveaxis(lo, 2, -1), xp.moveaxis(hi, 2, -1))


def _ext_concat(exts, xp):
    l0 = xp.concatenate([e[0][0] for e in exts], -1)
    h0 = xp.concatenate([e[0][1] for e in exts], -1)
    l1 = xp.concatenate([e[1][0] for e in exts], -1)
    h1 = xp.concatenate([e[1][1] for e in exts], -1)
    return ((l0, h0), (l1, h1))


def _ext_mul_base_const(e, c: int):
    xp = gl._xp(e[0][0])
    cp = gl.from_int(c, (), xp)
    return (gl.mul(*e[0], *cp), gl.mul(*e[1], *cp))


def _quotient_num_chunks(N: int, xp, B: int = 32) -> int:
    """Domain-chunk count for the quotient pass: bounds peak temporaries
    (per-gate [nw, B, Nc] broadcasts) at large batch sizes; scales with the
    batch so the per-chunk working set stays roughly constant.

    MUST divide N (the fori_loop chunking writes exactly nch * (N // nch)
    domain points — a non-divisor silently zeroes the tail): the
    batch multiplier is rounded DOWN to a power of two, so with N a power of
    two the product always divides."""
    if xp is np:
        return 1
    env = os.environ.get("PLONKY2_QCHUNKS")
    if env:  # profiling override
        nch = int(env)
        assert N % nch == 0, (N, nch)
        return nch
    bmul = max(1, B // 32)
    bmul = 1 << (bmul.bit_length() - 1)  # largest power of two <= bmul
    # Nc = N/nch = 1024 domain points/chunk at the production shape; the
    # chunk size has not been swept on the GPU yet
    nch = max(1, (N // (1 << 10)) * bmul)
    assert N % nch == 0, (N, nch)
    return nch


def _compute_quotient(data, bk, wires_lde, zs_lde, pi_lde, betas, gammas,
                      alphas, B, xp, shard=None, lk_alphas=()):
    """Combined constraint evals / Z_H over the LDE coset -> [B, C, N] pairs.

    Pointwise in the domain, so it runs in N-chunks (one fori_loop) to bound
    peak HBM: the per-gate stacked evaluations broadcast [nw, B, Nc] wire
    tensors that would otherwise hold several full-N copies live at once."""
    circuit = data.circuit
    cfg = circuit.config
    n, N = data.n, data.N
    C = cfg.num_challenges
    nr = cfg.num_routed_wires
    chunk = cfg.permutation_chunk_size
    nchunks = nr // chunk
    S = len(circuit.gates)

    # alpha powers [B, slots] per challenge (log-depth doubling)
    apow_arr = [gl.powers(alphas[c][0], alphas[c][1], data.num_constraint_slots)
                for c in range(C)]
    apows = [[(apow_arr[c][0][:, s], apow_arr[c][1][:, s])
              for s in range(data.num_constraint_slots)] for c in range(C)]

    sel_off = cfg.num_constant_cols
    roll = N // n
    # id encodings over the LDE domain: k_j * x, stacked [nr, N]
    ids_lo, ids_hi = [], []
    for j, kj in enumerate(circuit.k_coeffs):
        if kj < (1 << 32):
            il, ih = gl.mul_small(*bk.x_pair, np.uint32(kj))
        else:
            kp = gl.from_int(kj, (), xp)
            il, ih = gl.mul(*bk.x_pair, *kp)
        ids_lo.append(il)
        ids_hi.append(ih)
    ids_full = (xp.stack(ids_lo, 0), xp.stack(ids_hi, 0))  # [nr, N]
    # Z(g x) for each challenge (perm Zs, then lookup Zs), precomputed
    # (the roll crosses chunk bounds)
    lk = data.lookup
    zcols = [c * nchunks for c in range(C)]
    if lk is not None:
        cpc = lk.cols_per_challenge
        zcols += [C * nchunks + c * cpc + cpc - 1 for c in range(C)]
    zsh_full = (xp.roll(zs_lde[0][:, zcols], -roll, -1),
                xp.roll(zs_lde[1][:, zcols], -roll, -1))  # [B, len(zcols), N]

    from ..circuit.gates import _sum_axis0

    def eval_chunk(sl):
        """sl: slice-taker f(arr, axis) -> chunk views; returns [B,C,Nc] pair."""
        w_lde = (sl(wires_lde[0]), sl(wires_lde[1]))
        fixed = (sl(bk.fixed_lde[0]), sl(bk.fixed_lde[1]))
        zsc = (sl(zs_lde[0]), sl(zs_lde[1]))
        zshc = (sl(zsh_full[0]), sl(zsh_full[1]))
        pic = (sl(pi_lde[0]), sl(pi_lde[1]))
        ids_st = (sl(ids_full[0]), sl(ids_full[1]))
        l0c = (sl(bk.l0_lde[0]), sl(bk.l0_lde[1]))
        zhc = (sl(bk.zh_inv[0]), sl(bk.zh_inv[1]))
        Nc = w_lde[0].shape[-1]
        shape = (B, Nc)
        sig_lde = (fixed[0][sel_off + S : sel_off + S + nr],
                   fixed[1][sel_off + S : sel_off + S + nr])
        w_all = (w_lde[0][:, :nr], w_lde[1][:, :nr])  # [B, nr, Nc]
        comb = [(xp.zeros(shape, xp.uint32), xp.zeros(shape, xp.uint32))
                for _ in range(C)]
        for c in range(C):
            # wire-axis-vectorized f_j / g_j then log-depth per-chunk products
            beta2 = (betas[c][0][:, None, None], betas[c][1][:, None, None])
            gamma2 = (gammas[c][0][:, None, None], gammas[c][1][:, None, None])
            bid = gl.mul(ids_st[0][None], ids_st[1][None], *beta2)
            bsg = gl.mul(sig_lde[0][None], sig_lde[1][None], *beta2)
            f_all = gl.add(*gl.add(*w_all, *bid), gamma2[0], gamma2[1])
            g_all = gl.add(*gl.add(*w_all, *bsg), gamma2[0], gamma2[1])
            flo = xp.moveaxis(f_all[0].reshape(B, nchunks, chunk, Nc), 2, -1)
            fhi = xp.moveaxis(f_all[1].reshape(B, nchunks, chunk, Nc), 2, -1)
            glo = xp.moveaxis(g_all[0].reshape(B, nchunks, chunk, Nc), 2, -1)
            ghi = xp.moveaxis(g_all[1].reshape(B, nchunks, chunk, Nc), 2, -1)
            fp = _prod_last(flo, fhi)  # [B, nchunks, Nc]
            gp = _prod_last(glo, ghi)
            z = (zsc[0][:, c * nchunks], zsc[1][:, c * nchunks])
            z_shift = (zshc[0][:, c], zshc[1][:, c])
            # prev[t] = (Z, p_0, ..., p_{k-2}); left[t] = (p_0, ..., p_{k-2}, Z<<)
            prev = (zsc[0][:, c * nchunks : c * nchunks + nchunks],
                    zsc[1][:, c * nchunks : c * nchunks + nchunks])
            left = (xp.concatenate([prev[0][:, 1:], z_shift[0][:, None]], 1),
                    xp.concatenate([prev[1][:, 1:], z_shift[1][:, None]], 1))
            termt = gl.sub(*gl.mul(*left, *gp), *gl.mul(*prev, *fp))  # [B, nchunks, Nc]
            # weight by alpha slots 1..nchunks and fold into comb
            a_lo = xp.stack([apows[c][1 + t][0] for t in range(nchunks)], 1)  # [B, nchunks]
            a_hi = xp.stack([apows[c][1 + t][1] for t in range(nchunks)], 1)
            wt = gl.mul(*termt, a_lo[:, :, None], a_hi[:, :, None])
            comb[c] = gl.add(*comb[c], *_sum_pairs_axis(*wt, 1, xp))
            # slot 0: L0 * (Z - 1)
            one = (xp.ones(shape, xp.uint32), xp.zeros(shape, xp.uint32))
            term = gl.mul(*_bc(l0c, shape, xp), *gl.sub(*z, *one))
            ap = _bc((apows[c][0][0][:, None], apows[c][0][1][:, None]), shape, xp)
            comb[c] = gl.add(*comb[c], *gl.mul(*term, *ap))

        # gate constraints (vectorized stacked evaluation, see gates.eval_stacked)
        alg = BaseAlgebra(xp, shape)
        consts = [_bc((fixed[0][j], fixed[1][j]), shape, xp)
                  for j in range(cfg.num_constant_cols)]
        for gi, gate in enumerate(circuit.gates):
            if gate.num_constraints == 0:
                continue
            sel = _bc((fixed[0][sel_off + gi], fixed[1][sel_off + gi]), shape, xp)
            nw = gate.num_wires
            warr = (xp.broadcast_to(xp.moveaxis(w_lde[0][:, :nw], 1, 0), (nw,) + shape),
                    xp.broadcast_to(xp.moveaxis(w_lde[1][:, :nw], 1, 0), (nw,) + shape))
            ctx = {}
            if isinstance(gate, PublicInputGate):
                ctx["pi_vals"] = [_bc((pic[0][:, j], pic[1][:, j]), shape, xp)
                                  for j in range(gate.num_cols)]
            cons = gate.eval_stacked(alg, warr, consts, ctx)  # [ncons, B, Nc]
            ncons = cons[0].shape[0]
            for c in range(C):
                avec_lo = xp.stack([apows[c][data.perm_slots + s][0] for s in range(ncons)], 0)
                avec_hi = xp.stack([apows[c][data.perm_slots + s][1] for s in range(ncons)], 0)
                weighted = gl.mul(cons[0], cons[1], avec_lo[:, :, None], avec_hi[:, :, None])
                term = _sum_axis0(*weighted)
                comb[c] = gl.add(*comb[c], *gl.mul(*sel, *term))

        # ---- LogUp range-lookup constraints (data.LookupInfo docstring) ----
        if lk is not None:
            nb = lk.num_batches
            BSZ = 3
            base_slot = data.num_constraint_slots - lk.slots
            tv = (fixed[0][lk.table_idx], fixed[1][lk.table_idx])  # [Nc]
            mv = (w_lde[0][:, lk.mult_col], w_lde[1][:, lk.mult_col])
            for c in range(C):
                a2 = (lk_alphas[c][0][:, None], lk_alphas[c][1][:, None])
                abc = _bc(a2, shape, xp)
                zoff = C * nchunks + c * lk.cols_per_challenge

                def slot(k, term, c=c):
                    ap = apows[c][base_slot + k]
                    comb[c] = gl.add(*comb[c], *gl.mul(
                        *term, ap[0][:, None], ap[1][:, None]))
                    return comb[c]

                # slot 0: h_tab * (alpha - t) - m = 0 (all rows)
                h_tab = (zsc[0][:, zoff + nb], zsc[1][:, zoff + nb])
                dtab = gl.sub(*abc, *_bc(tv, shape, xp))
                comb[c] = slot(0, gl.sub(*gl.mul(*h_tab, *dtab), *mv))
                # slots 1..nb: sel_g * (h_b * D_b^g - N_b^g) summed over gates
                # (vectorized: all nb*3 term denominators in stacked tensors)
                Nc2 = shape[-1]
                a4 = (lk_alphas[c][0][:, None, None], lk_alphas[c][1][:, None, None])
                hb_all = (zsc[0][:, zoff : zoff + nb], zsc[1][:, zoff : zoff + nb])
                batch_cons = (xp.zeros((B, nb, Nc2), xp.uint32),
                              xp.zeros((B, nb, Nc2), xp.uint32))
                selsum = (xp.zeros(shape, xp.uint32), xp.zeros(shape, xp.uint32))
                for gi, g_ in lk.gates:
                    selp = (fixed[0][sel_off + gi], fixed[1][sel_off + gi])
                    colsg, scales = g_.lookup_cols_scales(nb)
                    wv = (w_lde[0][:, colsg], w_lde[1][:, colsg])  # [B, T, Nc]
                    sc = gl.from_u64(np.array(scales, np.uint64))
                    if xp is not np:
                        sc = (xp.asarray(sc[0]), xp.asarray(sc[1]))
                    f = gl.mul(*wv, sc[0][None, :, None], sc[1][None, :, None])
                    d = gl.sub(*_bc(a4, f[0].shape, xp), *f)
                    d3l = d[0].reshape(B, nb, BSZ, Nc2)
                    d3h = d[1].reshape(B, nb, BSZ, Nc2)
                    d0 = (d3l[:, :, 0], d3h[:, :, 0])
                    d1 = (d3l[:, :, 1], d3h[:, :, 1])
                    d2 = (d3l[:, :, 2], d3h[:, :, 2])
                    d01 = gl.mul(*d0, *d1)
                    Db = gl.mul(*d01, *d2)
                    Nb = gl.add(*d01, *gl.mul(*gl.add(*d0, *d1), *d2))
                    cb = gl.sub(*gl.mul(*hb_all, *Db), *Nb)
                    batch_cons = gl.add(*batch_cons, *gl.mul(
                        *cb, selp[0][None, None], selp[1][None, None]))
                    selsum = gl.add(*selsum, *_bc(selp, shape, xp))
                # weight slots 1..nb by their alpha powers and fold at once
                a_lo = xp.stack([apows[c][base_slot + 1 + b][0] for b in range(nb)], 1)
                a_hi = xp.stack([apows[c][base_slot + 1 + b][1] for b in range(nb)], 1)
                wt = gl.mul(*batch_cons, a_lo[:, :, None], a_hi[:, :, None])
                comb[c] = gl.add(*comb[c], *_sum_pairs_axis(*wt, 1, xp))
                hsum = _sum_pairs_axis(*hb_all, 1, xp)
                # slot nb+1: Z(gx) - Z(x) - sel_sum * sum_b h_b + h_tab = 0
                zlk = (zsc[0][:, zoff + nb + 1], zsc[1][:, zoff + nb + 1])
                zlk_sh = (zshc[0][:, C + c], zshc[1][:, C + c])
                step = gl.add(*gl.sub(*gl.sub(*zlk_sh, *zlk),
                                      *gl.mul(*selsum, *hsum)), *h_tab)
                comb[c] = slot(1 + nb, step)
                # slot nb+2: L0 * Z = 0 (running sum starts at zero)
                comb[c] = slot(2 + nb, gl.mul(*_bc(l0c, shape, xp), *zlk))

        zh = _bc(zhc, shape, xp)
        out_lo, out_hi = [], []
        for c in range(C):
            q = gl.mul(*comb[c], *zh)
            out_lo.append(q[0])
            out_hi.append(q[1])
        return (xp.stack(out_lo, 1), xp.stack(out_hi, 1))

    if shard is not None:
        import jax
        from jax import lax

        ax, ns = shard
        Nloc = N // ns
        base = jax.lax.axis_index(ax) * Nloc
        nch = _quotient_num_chunks(Nloc, xp, B)
        Nc = Nloc // nch
        out_lo = xp.zeros((B, C, Nloc), xp.uint32)
        out_hi = xp.zeros((B, C, Nloc), xp.uint32)

        def sbody(i, out):
            olo, ohi = out
            off = i * Nc
            qlo, qhi = eval_chunk(lambda a: lax.dynamic_slice_in_dim(
                a, base + off, Nc, axis=a.ndim - 1))
            return (lax.dynamic_update_slice_in_dim(olo, qlo, off, axis=2),
                    lax.dynamic_update_slice_in_dim(ohi, qhi, off, axis=2))

        loc = lax.fori_loop(0, nch, sbody, (out_lo, out_hi))
        return _shard_gather(loc, ax, 2)

    nch = _quotient_num_chunks(N, xp, B)
    if nch == 1:
        return eval_chunk(lambda a: a)

    import jax
    from jax import lax

    Nc = N // nch
    out_lo = xp.zeros((B, C, N), xp.uint32)
    out_hi = xp.zeros((B, C, N), xp.uint32)

    def body(i, out):
        olo, ohi = out
        start = i * Nc
        qlo, qhi = eval_chunk(
            lambda a: lax.dynamic_slice_in_dim(a, start, Nc, axis=a.ndim - 1))
        olo = lax.dynamic_update_slice_in_dim(olo, qlo, start, axis=2)
        ohi = lax.dynamic_update_slice_in_dim(ohi, qhi, start, axis=2)
        return olo, ohi

    return lax.fori_loop(0, nch, body, (out_lo, out_hi))


def _reduced_poly(data, bk, layout, wires_lde, zs_lde, quot_lde, openings0,
                  open_zs_gzeta, zeta, gzeta, alpha, z_idx, B, xp, shard=None):
    """F(x) = sum_i a^i (p_i(x)-y_i)/(x-zeta) + a^n0 sum_j a^j (z_j(x)-y'_j)/(x-g zeta).

    Fully vectorized over the poly axis: all T = layout.total committed polys
    are stacked as one [B, T, N] base-field tensor and combined with the
    alpha-power vector in a handful of big tensor ops (a per-poly Python loop
    here traces ~200x more XLA primitives and dominates jit compile time)."""
    N = data.N
    T = layout.total
    Cz = len(z_idx)
    apows = ntt.ext_powers(alpha, T)  # ext pair [B, T]
    apows1 = ntt.ext_powers(alpha, Cz)
    # y-parts: sum_i apow_i * y_i (ext*ext over [B, T]) — domain-independent
    ye = gl.ext_mul(apows, openings0)
    y0 = _sum_pairs_axis(*ye[0], 1, xp)  # [B]
    y1 = _sum_pairs_axis(*ye[1], 1, xp)
    ye1 = gl.ext_mul(apows1, open_zs_gzeta)
    w0 = _sum_pairs_axis(*ye1[0], 1, xp)
    w1 = _sum_pairs_axis(*ye1[1], 1, xp)
    # alpha^T = apows[T-1] * alpha
    alast = ((apows[0][0][:, T - 1], apows[0][1][:, T - 1]),
             (apows[1][0][:, T - 1], apows[1][1][:, T - 1]))
    apow_T = gl.ext_mul(alast, alpha)

    def eval_chunk(sl):
        xc = (sl(bk.x_pair[0]), sl(bk.x_pair[1]))
        fixed = (sl(bk.fixed_lde[0]), sl(bk.fixed_lde[1]))
        wl = (sl(wires_lde[0]), sl(wires_lde[1]))
        zl = (sl(zs_lde[0]), sl(zs_lde[1]))
        ql = (sl(quot_lde[0]), sl(quot_lde[1]))
        Nc = xc[0].shape[-1]
        shape = (B, Nc)
        x_ext = _ext_from_base(_bc(xc, shape, xp), xp)
        # sealed: same inverse-fused-into-consumers shape as the batch
        # inversion that was once miscompiled at scale (see _seal)
        inv0 = gl.ext_inverse(gl.ext_sub(x_ext, _ext_bc(zeta, shape, xp)))
        inv1 = gl.ext_inverse(gl.ext_sub(x_ext, _ext_bc(gzeta, shape, xp)))
        inv0 = (_seal(inv0[0], xp), _seal(inv0[1], xp))
        inv1 = (_seal(inv1[0], xp), _seal(inv1[1], xp))
        # all committed polys stacked [B, T, Nc] (base; order = layout order)
        plo = xp.concatenate([
            xp.broadcast_to(fixed[0][None], (B,) + fixed[0].shape),
            wl[0], zl[0], ql[0]], 1)
        phi = xp.concatenate([
            xp.broadcast_to(fixed[1][None], (B,) + fixed[1].shape),
            wl[1], zl[1], ql[1]], 1)
        # numerator sum_i apow_i * p_i: ext-scalar x base = two base muls
        n0 = gl.mul(plo, phi, apows[0][0][:, :, None], apows[0][1][:, :, None])
        n1 = gl.mul(plo, phi, apows[1][0][:, :, None], apows[1][1][:, :, None])
        s0 = _sum_pairs_axis(*n0, 1, xp)  # [B, Nc]
        s1 = _sum_pairs_axis(*n1, 1, xp)
        acc = (gl.sub(*s0, y0[0][:, None], y0[1][:, None]),
               gl.sub(*s1, y1[0][:, None], y1[1][:, None]))
        F = gl.ext_mul(acc, inv0)
        # Z polys at g*zeta (C of them)
        zplo = xp.stack([zl[0][:, j] for j in z_idx], 1)  # [B, C, Nc]
        zphi = xp.stack([zl[1][:, j] for j in z_idx], 1)
        m0 = gl.mul(zplo, zphi, apows1[0][0][:, :, None], apows1[0][1][:, :, None])
        m1 = gl.mul(zplo, zphi, apows1[1][0][:, :, None], apows1[1][1][:, :, None])
        t0 = _sum_pairs_axis(*m0, 1, xp)
        t1 = _sum_pairs_axis(*m1, 1, xp)
        acc1 = (gl.sub(*t0, w0[0][:, None], w0[1][:, None]),
                gl.sub(*t1, w1[0][:, None], w1[1][:, None]))
        F = gl.ext_add(F, gl.ext_mul(_ext_bc(apow_T, shape, xp),
                                     gl.ext_mul(acc1, inv1)))
        return F

    if shard is not None:
        import jax
        from jax import lax

        ax, ns = shard
        Nloc = N // ns
        base = jax.lax.axis_index(ax) * Nloc
        nch = _quotient_num_chunks(Nloc, xp, B)
        Nc = Nloc // nch
        out = tuple((xp.zeros((B, Nloc), xp.uint32), xp.zeros((B, Nloc), xp.uint32))
                    for _ in range(2))

        def sbody(i, out):
            off = i * Nc
            F = eval_chunk(lambda a: lax.dynamic_slice_in_dim(
                a, base + off, Nc, axis=a.ndim - 1))
            return tuple(
                (lax.dynamic_update_slice_in_dim(out[c][0], F[c][0], off, axis=1),
                 lax.dynamic_update_slice_in_dim(out[c][1], F[c][1], off, axis=1))
                for c in range(2))

        loc = lax.fori_loop(0, nch, sbody, out)
        return tuple(_shard_gather(loc[c], ax, 1) for c in range(2))

    nch = _quotient_num_chunks(N, xp, B)
    if nch == 1:
        return eval_chunk(lambda a: a)

    from jax import lax

    Nc = N // nch
    out = tuple((xp.zeros((B, N), xp.uint32), xp.zeros((B, N), xp.uint32))
                for _ in range(2))

    def body(i, out):
        start = i * Nc
        F = eval_chunk(
            lambda a: lax.dynamic_slice_in_dim(a, start, Nc, axis=a.ndim - 1))
        return tuple(
            (lax.dynamic_update_slice_in_dim(out[c][0], F[c][0], start, axis=1),
             lax.dynamic_update_slice_in_dim(out[c][1], F[c][1], start, axis=1))
            for c in range(2))

    return lax.fori_loop(0, nch, body, out)
