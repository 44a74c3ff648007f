"""Proof verifier (host-side numpy, batched over proof lanes).

plonky2 `verify()` equivalent (SURVEY.md §2.9 "data.verify(proof)"): replays
the Fiat-Shamir transcript, checks the alpha-combined gate + permutation
constraint identity at zeta against the quotient opening, and runs the FRI
query checks (Merkle paths, fold consistency, final-polynomial agreement).

Two paths:
  * `verify_strict` / `verify` — fully vectorized over the whole proof batch
    (one numpy Poseidon permute per transcript/Merkle step covers all B*Q
    lanes; the per-lane scalar formulation took ~1.5 s per query per lane).
  * `verify_one_exact` — exact python-int re-derivation for ONE lane; the
    readable reference implementation used by tests as a cross-check oracle.
"""

from __future__ import annotations

import numpy as np

from ..circuit.algebra import ExtAlgebra
from ..circuit.gates import PublicInputGate
from ..fields import goldilocks as gl
from ..hash import merkle, poseidon
from . import fri as fri_mod
from . import ntt
from .challenger import Challenger
from .data import CircuitData
from .prover import Proof

P = gl.P
W = 7  # extension non-residue


class VerifyError(AssertionError):
    pass


# ---------------------------------------------------------------------------
# python-int extension helpers (exact single-lane path + shared small math)
# ---------------------------------------------------------------------------

def eadd(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def esub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def emul(a, b):
    return ((a[0] * b[0] + W * a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def escalar(a, c):
    return (a[0] * c % P, a[1] * c % P)


def einv(a):
    d = (a[0] * a[0] - W * a[1] * a[1]) % P
    di = pow(d, -1, P)
    return (a[0] * di % P, (-a[1]) * di % P)


def epow(a, e):
    r = (1, 0)
    while e:
        if e & 1:
            r = emul(r, a)
        e >>= 1
        a = emul(a, a)
    return r


# ---------------------------------------------------------------------------
# batched pair/ext helpers ((lo, hi) u32 numpy arrays, any shape)
# ---------------------------------------------------------------------------

def _u64(pair):
    return gl.to_u64(np.asarray(pair[0]), np.asarray(pair[1]))


def _pair(vals_u64):
    return gl.from_u64(np.asarray(vals_u64, dtype=np.uint64))


def _ext_eq(a, b):
    return np.logical_and(
        np.logical_and(a[0][0] == b[0][0], a[0][1] == b[0][1]),
        np.logical_and(a[1][0] == b[1][0], a[1][1] == b[1][1]))


def _ext_bcast(e, shape):
    return ((np.broadcast_to(e[0][0], shape), np.broadcast_to(e[0][1], shape)),
            (np.broadcast_to(e[1][0], shape), np.broadcast_to(e[1][1], shape)))


def _ext_at_idx(e, idx):
    return ((e[0][0][idx], e[0][1][idx]), (e[1][0][idx], e[1][1][idx]))


def verify_merkle_paths_batched(leaf_lo, leaf_hi, idx, path_lo, path_hi,
                                cap_lo, cap_hi):
    """Recompute Merkle roots for many openings at once.

    leaf: [..., W] pairs; idx: [...] ints; path: [..., D, 4]; cap: [C, 4] or
    batch-leading [B, C, 4] (then ... must start with B).  Returns bool [...]."""
    cur = poseidon.hash_no_pad(merkle._pairs_from_axis(leaf_lo, leaf_hi))
    i = np.asarray(idx).astype(np.int64)
    D = path_lo.shape[-2]
    for d in range(D):
        bit = (i & 1).astype(bool)
        elems = []
        for j in range(4):  # first half: sibling if bit else cur
            slo, shi = path_lo[..., d, j], path_hi[..., d, j]
            elems.append((np.where(bit, slo, cur[j][0]), np.where(bit, shi, cur[j][1])))
        for j in range(4):  # second half
            slo, shi = path_lo[..., d, j], path_hi[..., d, j]
            elems.append((np.where(bit, cur[j][0], slo), np.where(bit, cur[j][1], shi)))
        cur = poseidon.hash_no_pad(elems)
        i >>= 1
    if cap_lo.ndim == 2:  # shared (unbatched) tree
        sel_lo, sel_hi = cap_lo[i], cap_hi[i]  # [..., 4]
    else:
        B = cap_lo.shape[0]
        bidx = np.arange(B).reshape((B,) + (1,) * (i.ndim - 1))
        sel_lo, sel_hi = cap_lo[bidx, i], cap_hi[bidx, i]
    ok = np.ones(i.shape, dtype=bool)
    for j in range(4):
        ok &= (cur[j][0] == sel_lo[..., j]) & (cur[j][1] == sel_hi[..., j])
    return ok


def replay_challenges_to_zeta(data: CircuitData, proof: Proof):
    """Shared Fiat-Shamir replay of the prover transcript UP TO zeta (observe
    fixed cap, PIs, wires cap; draw betas/gammas [+ lk_alphas]; observe zs
    cap; draw alphas; observe quotient cap; draw zeta).

    Single source of truth for the transcript schedule prefix, used by both
    verify_strict and the recursive verifier's challenge derivation (a
    schedule change must not be mirrorable by hand in two places).
    Returns (ch, betas, gammas, lk_alphas, alphas, zeta, z_idx); `ch` is the
    live challenger positioned just after zeta."""
    circuit = data.circuit
    cfg = circuit.config
    C = cfg.num_challenges
    nchunks = cfg.num_routed_wires // cfg.permutation_chunk_size
    B = proof.pis.shape[0]
    shape = (B,)
    ch = Challenger(np, shape)
    fixed_cap = data.fixed_tree.cap
    ch.observe_cap((np.broadcast_to(fixed_cap[0], shape + fixed_cap[0].shape),
                    np.broadcast_to(fixed_cap[1], shape + fixed_cap[1].shape)))
    for i in range(proof.pis.shape[1]):
        ch.observe_u64(proof.pis[:, i])
    ch.observe_cap(proof.wires_cap)
    betas, gammas = [], []
    for _ in range(C):
        betas.append(ch.get_challenge())
        gammas.append(ch.get_challenge())
    lk = data.lookup
    lk_alphas = [ch.get_challenge() for _ in range(C)] if lk is not None else []
    z_idx = [c * nchunks for c in range(C)]
    if lk is not None:
        cpc = lk.cols_per_challenge
        z_idx += [C * nchunks + c * cpc + cpc - 1 for c in range(C)]
    ch.observe_cap(proof.zs_cap)
    alphas = [ch.get_challenge() for _ in range(C)]
    ch.observe_cap(proof.quotient_cap)
    zeta = ch.get_ext()
    return ch, betas, gammas, lk_alphas, alphas, zeta, z_idx


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def verify(data: CircuitData, proof: Proof) -> bool:
    """True iff every batch lane's proof verifies (plonky2 data.verify
    equivalent; Result-style bool instead of raising).

    Robust against structurally malformed proofs: any exception from the
    transcript replay / constraint / FRI machinery (wrong dtypes, ranks,
    truncated pytrees -> TypeError/KeyError/AttributeError/...) means the
    proof does not verify; only genuine programming errors (e.g. a wrong
    `data`) should escape via VerifyInternalError-free paths, and a
    malformed proof must never crash a verifying service."""
    try:
        verify_strict(data, proof)
    except Exception:
        return False
    return True


def verify_strict(data: CircuitData, proof: Proof):
    """Raises VerifyError with a diagnostic on the first failing check.
    Vectorized over the full proof batch."""
    circuit = data.circuit
    cfg = circuit.config
    n, N = data.n, data.N
    C = cfg.num_challenges
    nr = cfg.num_routed_wires
    chunk = cfg.permutation_chunk_size
    nchunks = nr // chunk
    S = len(circuit.gates)
    nc = cfg.num_constant_cols
    layout = proof.layout
    rate = N // n
    B = proof.pis.shape[0]
    shape = (B,)

    def req(cond_arr, msg):
        cond_arr = np.asarray(cond_arr)
        if not cond_arr.all():
            lane = int(np.argwhere(~cond_arr.reshape(B, -1).all(1))[0][0])
            raise VerifyError(f"{msg} (first failing lane {lane})")

    # ---- transcript replay (batched; mirrors prove_core exactly) -----------
    (ch, betas, gammas, lk_alphas, alphas, zeta,
     z_idx) = replay_challenges_to_zeta(data, proof)
    lk = data.lookup

    opens0 = proof.openings0  # ext pair [B, total]
    opens1 = proof.openings1  # ext pair [B, len(z_idx)]
    for i in range(layout.total):
        ch.observe_ext(_ext_at_idx(opens0, (slice(None), i)))
    for i in range(len(z_idx)):
        ch.observe_ext(_ext_at_idx(opens1, (slice(None), i)))
    fri_alpha = ch.get_ext()

    num_layers, final_size, nfinal = fri_mod.plan(N, cfg)
    fp = proof.fri_proof
    fri_betas = []
    for li in range(num_layers):
        ch.observe_cap(fp.caps[li])
        fri_betas.append(ch.get_ext())
    final_coeffs = fp.final_coeffs  # ext pair [B, nfinal]
    for k in range(nfinal):
        ch.observe((final_coeffs[0][0][..., k], final_coeffs[0][1][..., k]))
        ch.observe((final_coeffs[1][0][..., k], final_coeffs[1][1][..., k]))
    if cfg.fri.proof_of_work_bits:
        if fp.pow_witness is None:
            raise VerifyError("missing FRI PoW witness")
        w = (np.asarray(fp.pow_witness[0]), np.asarray(fp.pow_witness[1]))
        req(ch.check_pow(w, cfg.fri.proof_of_work_bits), "FRI PoW check failed")
    idx_list = ch.get_indices(N, cfg.fri.num_query_rounds)
    indices = np.stack([ix.astype(np.int64) for ix in idx_list], axis=-1)  # [B, Q]
    req(indices == np.asarray(fp.indices).astype(np.int64), "query indices mismatch")

    # ---- constraint identity at zeta (vectorized over B) -------------------
    sl = layout.slices()

    def open_at(i):
        return _ext_at_idx(opens0, (slice(None), i))

    alg = ExtAlgebra(np, shape)
    one = alg.one()
    zeta_n = gl.ext_pow_const(zeta, n)
    zh = gl.ext_sub(zeta_n, one)
    req(~_ext_eq(zh, alg.zero()), "zeta landed in H (negligible probability)")
    n_pair = gl.from_int(n, shape)
    l0 = gl.ext_mul(zh, gl.ext_inverse(
        gl.ext_scalar_mul(gl.ext_sub(zeta, one), n_pair)))

    # PI column values at zeta
    K = circuit.pi.num_cols
    g = data.g
    pi_at_zeta = []
    for j in range(K):
        acc = alg.zero()
        for blk, row in enumerate(circuit.pi.rows):
            idx = blk * K + j
            if idx < circuit.pi.count:
                grow = pow(g, row, P)
                lrow = gl.ext_mul(zh, gl.ext_inverse(gl.ext_scalar_mul(
                    gl.ext_sub(zeta, alg.const(grow)), n_pair)))
                lrow = alg.mul_const(lrow, grow)
                pv = _pair(proof.pis[:, idx])
                acc = gl.ext_add(acc, gl.ext_scalar_mul(lrow, pv))
        pi_at_zeta.append(acc)

    wires_alg = [open_at(sl["wires"].start + j) for j in range(cfg.num_wires)]
    consts_alg = [open_at(sl["fixed"].start + j) for j in range(nc)]
    sels = [open_at(sl["fixed"].start + nc + gi) for gi in range(S)]
    sigmas = [open_at(sl["fixed"].start + nc + S + j) for j in range(nr)]
    zsp = [open_at(sl["zs_partials"].start + j) for j in range(layout.num_zs_partials)]
    quot = [open_at(sl["quotient"].start + j) for j in range(C * rate)]
    opens1_list = [_ext_at_idx(opens1, (slice(None), i)) for i in range(len(z_idx))]

    max_gate_cons = (data.num_constraint_slots - data.perm_slots
                     - (lk.slots if lk is not None else 0))
    gate_terms = [alg.zero()] * max_gate_cons
    for gi, gate in enumerate(circuit.gates):
        if gate.num_constraints == 0:
            continue
        ctx = {}
        if isinstance(gate, PublicInputGate):
            ctx["pi_vals"] = pi_at_zeta
        cons = gate.eval(alg, wires_alg[: gate.num_wires], consts_alg, ctx)
        for s, cv in enumerate(cons):
            gate_terms[s] = gl.ext_add(gate_terms[s], gl.ext_mul(sels[gi], cv))

    for c in range(C):
        beta, gamma = betas[c], gammas[c]
        gamma_ext = (gamma, gl.from_int(0, shape))
        z_zeta = zsp[c * nchunks]
        partials = zsp[c * nchunks + 1 : c * nchunks + nchunks]
        z_gzeta = opens1_list[c]
        combined = alg.zero()
        apow = gl.from_int(1, shape)  # alpha^slot (base field)
        alpha = alphas[c]

        def fold(term, combined, apow):
            return gl.ext_add(combined, gl.ext_scalar_mul(term, apow))

        combined = fold(gl.ext_mul(l0, gl.ext_sub(z_zeta, one)), combined, apow)
        apow = gl.mul(*apow, *alpha)
        for t in range(nchunks):
            F = one
            G = one
            for j in range(t * chunk, (t + 1) * chunk):
                kj = circuit.k_coeffs[j]
                bk_ = gl.mul(*beta, *gl.from_int(kj, shape))
                fj = gl.ext_add(gl.ext_add(wires_alg[j],
                                           gl.ext_scalar_mul(zeta, bk_)), gamma_ext)
                gj = gl.ext_add(gl.ext_add(wires_alg[j],
                                           gl.ext_scalar_mul(sigmas[j], beta)), gamma_ext)
                F = gl.ext_mul(F, fj)
                G = gl.ext_mul(G, gj)
            left = partials[t] if t < nchunks - 1 else z_gzeta
            prev = z_zeta if t == 0 else partials[t - 1]
            combined = fold(gl.ext_sub(gl.ext_mul(left, G), gl.ext_mul(prev, F)),
                            combined, apow)
            apow = gl.mul(*apow, *alpha)
        for s in range(max_gate_cons):
            combined = fold(gate_terms[s], combined, apow)
            apow = gl.mul(*apow, *alpha)

        if lk is not None:
            nb = lk.num_batches
            BSZ = 3
            zoff = C * nchunks + c * lk.cols_per_challenge
            alpha_lk = (lk_alphas[c], gl.from_int(0, shape))
            t_open = open_at(sl["fixed"].start + lk.table_idx)
            m_open = wires_alg[lk.mult_col]
            h_tab = zsp[zoff + nb]
            # slot 0: h_tab (alpha - t) - m
            combined = fold(gl.ext_sub(gl.ext_mul(
                h_tab, gl.ext_sub(alpha_lk, t_open)), m_open), combined, apow)
            apow = gl.mul(*apow, *alpha)
            # slots 1..nb: sel_g (h_b D_b - N_b), summed over lookup gates
            gate_ds = []
            for gi, g_ in lk.gates:
                colsg, scalesg = g_.lookup_cols_scales(nb)
                ds = [gl.ext_sub(alpha_lk,
                                 alg.mul_const(wires_alg[col], scale))
                      for col, scale in zip(colsg, scalesg)]
                gate_ds.append((sels[gi], ds))
            hsum = alg.zero()
            selsum = alg.zero()
            for sel, _ds in gate_ds:
                selsum = gl.ext_add(selsum, sel)
            for b in range(nb):
                hb = zsp[zoff + b]
                hsum = gl.ext_add(hsum, hb)
                slot_val = alg.zero()
                for sel, ds in gate_ds:
                    d0, d1, d2 = ds[b * BSZ : b * BSZ + BSZ]
                    d01 = gl.ext_mul(d0, d1)
                    D = gl.ext_mul(d01, d2)
                    Nv = gl.ext_add(d01, gl.ext_mul(gl.ext_add(d0, d1), d2))
                    slot_val = gl.ext_add(slot_val, gl.ext_mul(
                        sel, gl.ext_sub(gl.ext_mul(hb, D), Nv)))
                combined = fold(slot_val, combined, apow)
                apow = gl.mul(*apow, *alpha)
            # slot nb+1: Z(g zeta) - Z - sel_sum sum_b h_b + h_tab
            zlk = zsp[zoff + nb + 1]
            zlk_g = opens1_list[C + c]
            step = gl.ext_add(gl.ext_sub(gl.ext_sub(zlk_g, zlk),
                                         gl.ext_mul(selsum, hsum)), h_tab)
            combined = fold(step, combined, apow)
            apow = gl.mul(*apow, *alpha)
            # slot nb+2: L0 * Z
            combined = fold(gl.ext_mul(l0, zlk), combined, apow)
            apow = gl.mul(*apow, *alpha)

        qsum = alg.zero()
        zpow = one
        for t in range(rate):
            qsum = gl.ext_add(qsum, gl.ext_mul(zpow, quot[c * rate + t]))
            zpow = gl.ext_mul(zpow, zeta_n)
        req(_ext_eq(combined, gl.ext_mul(qsum, zh)),
            f"constraint identity fails (challenge {c})")

    # ---- FRI query phase (vectorized over [B, Q]) ---------------------------
    Q = indices.shape[1]
    bq = (B, Q)
    tree_order = ["fixed", "wires", "zs", "quot"]
    tree_caps = {
        "fixed": data.fixed_tree.cap,
        "wires": proof.wires_cap,
        "zs": proof.zs_cap,
        "quot": proof.quotient_cap,
    }
    leaf_vals_lo, leaf_vals_hi = [], []
    for name in tree_order:
        llo, lhi = proof.initial_leaves[name]   # [B, Q, k]
        plo, phi = proof.initial_paths[name]    # [B, Q, D, 4]
        ok = verify_merkle_paths_batched(
            np.asarray(llo), np.asarray(lhi), indices,
            np.asarray(plo), np.asarray(phi),
            np.asarray(tree_caps[name][0]), np.asarray(tree_caps[name][1]))
        req(ok, f"initial merkle proof fails: {name}")
        leaf_vals_lo.append(np.asarray(llo))
        leaf_vals_hi.append(np.asarray(lhi))
    leaf_lo = np.concatenate(leaf_vals_lo, axis=-1)  # [B, Q, total]
    leaf_hi = np.concatenate(leaf_vals_hi, axis=-1)
    req(leaf_lo.shape[-1] == layout.total, "leaf layout mismatch")

    # x at query points from the committed LDE domain
    x_u64 = np.asarray(data.x_lde)[indices]  # [B, Q]
    x = _pair(x_u64)

    # reduced-poly value: sum_i alpha^i (v_i - y_i) / (x - zeta)
    T = layout.total
    apows = ntt.ext_powers(fri_alpha, T)  # ext pair [B, T]
    ap_bq = ((apows[0][0][:, None], apows[0][1][:, None]),
             (apows[1][0][:, None], apows[1][1][:, None]))  # [B, 1, T]
    y0 = ((opens0[0][0][:, None], opens0[0][1][:, None]),
          (opens0[1][0][:, None], opens0[1][1][:, None]))
    # diff = (v - y) with v base-field leaves, y the ext openings
    diff = (gl.sub(leaf_lo, leaf_hi, *y0[0]), gl.ext_neg(y0)[1])
    term = gl.ext_mul(ap_bq, diff)  # broadcasts to [B, Q, T]
    from ..prover.prover import _sum_pairs_axis  # modular tree-sum over T

    red0 = (_sum_pairs_axis(*term[0], -1, np), _sum_pairs_axis(*term[1], -1, np))
    zeta_bq = _ext_bcast((tuple(z[:, None] for z in zeta[0]),
                          tuple(z[:, None] for z in zeta[1])), bq)
    x_ext = ((x[0], x[1]), (np.zeros(bq, np.uint32), np.zeros(bq, np.uint32)))
    Fv = gl.ext_mul(red0, gl.ext_inverse(gl.ext_sub(x_ext, zeta_bq)))

    # Z-poly part at g*zeta (perm Zs + lookup Zs)
    gz = gl.ext_scalar_mul(zeta, gl.from_int(data.g, shape))
    apows1 = ntt.ext_powers(fri_alpha, len(z_idx))
    red1 = ((np.zeros(bq, np.uint32), np.zeros(bq, np.uint32)),
            (np.zeros(bq, np.uint32), np.zeros(bq, np.uint32)))
    for c, zi in enumerate(z_idx):
        vz_lo = leaf_lo[..., sl["zs_partials"].start + zi]
        vz_hi = leaf_hi[..., sl["zs_partials"].start + zi]
        y = opens1_list[c]
        d0 = gl.sub(vz_lo, vz_hi, y[0][0][:, None], y[0][1][:, None])
        d1 = gl.neg(y[1][0][:, None], y[1][1][:, None])
        d1 = (np.broadcast_to(d1[0], bq), np.broadcast_to(d1[1], bq))
        ap = _ext_at_idx(apows1, (slice(None), c))
        ap = ((ap[0][0][:, None], ap[0][1][:, None]), (ap[1][0][:, None], ap[1][1][:, None]))
        red1 = gl.ext_add(red1, gl.ext_mul(ap, (d0, d1)))
    ap_T = gl.ext_mul(_ext_at_idx(apows, (slice(None), T - 1)), fri_alpha)
    ap_T = ((ap_T[0][0][:, None], ap_T[0][1][:, None]), (ap_T[1][0][:, None], ap_T[1][1][:, None]))
    gz_bq = _ext_bcast((tuple(z[:, None] for z in gz[0]), tuple(z[:, None] for z in gz[1])), bq)
    Fv = gl.ext_add(Fv, gl.ext_mul(ap_T, gl.ext_mul(
        red1, gl.ext_inverse(gl.ext_sub(x_ext, gz_bq)))))

    # fold layers: x_{l+1}(i mod half) = (x_l(i))^2
    cur_idx = indices.copy()
    x_cur = x
    inv2 = gl.from_int(pow(2, -1, P), bq)
    size = N
    for li in range(num_layers):
        half = size // 2
        j = cur_idx % half
        llo, lhi = fp.layer_leaves[li]  # [B, Q, 4]
        llo, lhi = np.asarray(llo), np.asarray(lhi)
        a_val = ((llo[..., 0], lhi[..., 0]), (llo[..., 1], lhi[..., 1]))
        b_val = ((llo[..., 2], lhi[..., 2]), (llo[..., 3], lhi[..., 3]))
        low_half = cur_idx < half
        expect = ((np.where(low_half, a_val[0][0], b_val[0][0]),
                   np.where(low_half, a_val[0][1], b_val[0][1])),
                  (np.where(low_half, a_val[1][0], b_val[1][0]),
                   np.where(low_half, a_val[1][1], b_val[1][1])))
        req(_ext_eq(expect, Fv), f"FRI fold mismatch layer {li}")
        plo, phi = fp.layer_paths[li]
        ok = verify_merkle_paths_batched(llo, lhi, j, np.asarray(plo), np.asarray(phi),
                                         np.asarray(fp.caps[li][0]),
                                         np.asarray(fp.caps[li][1]))
        req(ok, f"FRI layer merkle fails layer {li}")
        # the fold formula needs x at the even representative j; for
        # cur_idx >= half, x_l(cur_idx) = -x_l(j)
        xj = (np.where(low_half, x_cur[0], gl.neg(*x_cur)[0]),
              np.where(low_half, x_cur[1], gl.neg(*x_cur)[1]))
        beta = fri_betas[li]
        beta_bq = _ext_bcast((tuple(z[:, None] for z in beta[0]),
                              tuple(z[:, None] for z in beta[1])), bq)
        s_val = gl.ext_add(a_val, b_val)
        d_val = gl.ext_sub(a_val, b_val)
        inv2x = gl.inverse(*gl.add(*xj, *xj))
        even = (gl.mul(*s_val[0], *inv2), gl.mul(*s_val[1], *inv2))
        odd = (gl.mul(*d_val[0], *inv2x), gl.mul(*d_val[1], *inv2x))
        Fv = gl.ext_add(even, gl.ext_mul(beta_bq, odd))
        x_cur = gl.square(*xj)
        cur_idx = j
        size = half

    # final polynomial agreement (Horner at x_cur)
    acc = ((np.zeros(bq, np.uint32), np.zeros(bq, np.uint32)),
           (np.zeros(bq, np.uint32), np.zeros(bq, np.uint32)))
    for k in range(nfinal - 1, -1, -1):
        coef = ((np.broadcast_to(final_coeffs[0][0][:, k : k + 1], bq),
                 np.broadcast_to(final_coeffs[0][1][:, k : k + 1], bq)),
                (np.broadcast_to(final_coeffs[1][0][:, k : k + 1], bq),
                 np.broadcast_to(final_coeffs[1][1][:, k : k + 1], bq)))
        acc = ((gl.mul(*acc[0], *x_cur)), (gl.mul(*acc[1], *x_cur)))
        acc = gl.ext_add(acc, coef)
    req(_ext_eq(acc, Fv), "FRI final polynomial mismatch")
    return True


# ---------------------------------------------------------------------------
# exact single-lane reference path (python ints)
# ---------------------------------------------------------------------------

def _chal_int(ch):
    c = ch.get_challenge()
    return int(gl.to_u64(np.asarray(c[0]), np.asarray(c[1])))


def _chal_ext(ch):
    a = _chal_int(ch)
    b = _chal_int(ch)
    return (a, b)


def _pair_at(pair, index):
    """pair arrays + index tuple -> python int."""
    return int(gl.to_u64(np.asarray(pair[0][index]), np.asarray(pair[1][index])))


def _ext_at(epair, index):
    return (_pair_at(epair[0], index), _pair_at(epair[1], index))


def _to_alg(e):
    """python-int ext -> ExtAlgebra element (0-d pairs)."""
    return (gl.from_int(e[0], ()), gl.from_int(e[1], ()))


def _from_alg(x):
    return (int(gl.to_u64(*x[0])), int(gl.to_u64(*x[1])))


def _cap_at(cap, b):
    lo, hi = cap
    if lo.ndim == 3:
        return lo[b], hi[b]
    return lo, hi


def verify_one_exact(data: CircuitData, proof: Proof, b: int):
    circuit = data.circuit
    cfg = circuit.config
    n, N = data.n, data.N
    C = cfg.num_challenges
    nr = cfg.num_routed_wires
    chunk = cfg.permutation_chunk_size
    nchunks = nr // chunk
    S = len(circuit.gates)
    nc = cfg.num_constant_cols
    layout = proof.layout
    rate = N // n

    ch = Challenger(np, ())
    ch.observe_cap(data.fixed_tree.cap)
    for i in range(proof.pis.shape[1]):
        ch.observe_u64(proof.pis[b, i])
    ch.observe_cap(_cap_at(proof.wires_cap, b))
    betas, gammas = [], []
    for _ in range(C):
        betas.append(_chal_int(ch))
        gammas.append(_chal_int(ch))
    lk = data.lookup
    lk_alphas = [_chal_int(ch) for _ in range(C)] if lk is not None else []
    z_idx = [c * nchunks for c in range(C)]
    if lk is not None:
        cpc = lk.cols_per_challenge
        z_idx += [C * nchunks + c * cpc + cpc - 1 for c in range(C)]
    ch.observe_cap(_cap_at(proof.zs_cap, b))
    alphas = [_chal_int(ch) for _ in range(C)]
    ch.observe_cap(_cap_at(proof.quotient_cap, b))
    zeta = _chal_ext(ch)

    sl = layout.slices()
    opens0 = [_ext_at(proof.openings0, (b, i)) for i in range(layout.total)]
    opens1 = [_ext_at(proof.openings1, (b, i)) for i in range(len(z_idx))]
    for e in opens0:
        ch.observe_ext(_to_alg(e))
    for e in opens1:
        ch.observe_ext(_to_alg(e))

    fixed_o = opens0[sl["fixed"]]
    wires_o = opens0[sl["wires"]]
    zsp_o = opens0[sl["zs_partials"]]
    quot_o = opens0[sl["quotient"]]
    consts_o = fixed_o[:nc]
    sels_o = fixed_o[nc : nc + S]
    sigmas_o = fixed_o[nc + S : nc + S + nr]

    # ---- constraint identity at zeta --------------------------------------
    zeta_n = epow(zeta, n)
    zh = esub(zeta_n, (1, 0))
    assert zh != (0, 0), "zeta landed in H (negligible probability)"
    l0 = emul(zh, einv(escalar(esub(zeta, (1, 0)), n)))

    # PI column values at zeta
    K = circuit.pi.num_cols
    pi_at_zeta = []
    g = data.g
    for j in range(K):
        acc = (0, 0)
        for blk, row in enumerate(circuit.pi.rows):
            idx = blk * K + j
            if idx < circuit.pi.count:
                grow = pow(g, row, P)
                lrow = emul(zh, einv(escalar(esub(zeta, (grow % P, 0)), n)))
                lrow = escalar(lrow, grow)
                acc = eadd(acc, escalar(lrow, int(proof.pis[b, idx])))
        pi_at_zeta.append(acc)

    # gate constraint terms (slot-major), evaluated in the extension algebra
    alg = ExtAlgebra(np, ())
    wires_alg = [_to_alg(w) for w in wires_o]
    consts_alg = [_to_alg(c) for c in consts_o]
    max_gate_cons = (data.num_constraint_slots - data.perm_slots
                     - (lk.slots if lk is not None else 0))
    gate_terms = [(0, 0)] * max_gate_cons
    for gi, gate in enumerate(circuit.gates):
        if gate.num_constraints == 0:
            continue
        ctx = {}
        if isinstance(gate, PublicInputGate):
            ctx["pi_vals"] = [_to_alg(v) for v in pi_at_zeta]
        cons = gate.eval(alg, wires_alg[: gate.num_wires], consts_alg, ctx)
        sel = sels_o[gi]
        for s, cv in enumerate(cons):
            gate_terms[s] = eadd(gate_terms[s], emul(sel, _from_alg(cv)))

    for c in range(C):
        beta, gamma = betas[c], gammas[c]
        z_zeta = zsp_o[c * nchunks]
        partials = zsp_o[c * nchunks + 1 : c * nchunks + nchunks]
        z_gzeta = opens1[c]
        combined = (0, 0)
        apow = 1  # alpha^slot, alpha is base-field
        alpha = alphas[c]

        def add(term, combined, apow):
            return eadd(combined, escalar(term, apow))

        # slot 0: L0 (Z - 1)
        combined = add(emul(l0, esub(z_zeta, (1, 0))), combined, apow)
        apow = apow * alpha % P
        # chunk products
        for t in range(nchunks):
            F = (1, 0)
            G = (1, 0)
            for j in range(t * chunk, (t + 1) * chunk):
                kj = circuit.k_coeffs[j]
                fj = eadd(eadd(wires_o[j], escalar(zeta, beta * kj % P)), (gamma, 0))
                gj = eadd(eadd(wires_o[j], escalar(sigmas_o[j], beta)), (gamma, 0))
                F = emul(F, fj)
                G = emul(G, gj)
            left = partials[t] if t < nchunks - 1 else z_gzeta
            prev = z_zeta if t == 0 else partials[t - 1]
            combined = add(esub(emul(left, G), emul(prev, F)), combined, apow)
            apow = apow * alpha % P
        # gate slots
        for s in range(max_gate_cons):
            combined = add(gate_terms[s], combined, apow)
            apow = apow * alpha % P

        # LogUp lookup slots (mirrors prover._compute_quotient lookup block)
        if lk is not None:
            nb = lk.num_batches
            BSZ = 3
            zoff = C * nchunks + c * lk.cols_per_challenge
            alpha_lk = (lk_alphas[c], 0)
            t_open = fixed_o[lk.table_idx]
            m_open = wires_o[lk.mult_col]
            h_tab = zsp_o[zoff + nb]
            combined = add(esub(emul(h_tab, esub(alpha_lk, t_open)), m_open),
                           combined, apow)
            apow = apow * alpha % P
            gate_ds = []
            for gi, g_ in lk.gates:
                colsg, scalesg = g_.lookup_cols_scales(nb)
                ds = [esub(alpha_lk, escalar(wires_o[col], scale))
                      for col, scale in zip(colsg, scalesg)]
                gate_ds.append((sels_o[gi], ds))
            hsum = (0, 0)
            selsum = (0, 0)
            for sel, _ds in gate_ds:
                selsum = eadd(selsum, sel)
            for bi in range(nb):
                hb = zsp_o[zoff + bi]
                hsum = eadd(hsum, hb)
                slot_val = (0, 0)
                for sel, ds in gate_ds:
                    d0, d1, d2 = ds[bi * BSZ : bi * BSZ + BSZ]
                    d01 = emul(d0, d1)
                    D = emul(d01, d2)
                    Nv = eadd(d01, emul(eadd(d0, d1), d2))
                    slot_val = eadd(slot_val, emul(sel, esub(emul(hb, D), Nv)))
                combined = add(slot_val, combined, apow)
                apow = apow * alpha % P
            zlk = zsp_o[zoff + nb + 1]
            zlk_g = opens1[C + c]
            step = eadd(esub(esub(zlk_g, zlk), emul(selsum, hsum)), h_tab)
            combined = add(step, combined, apow)
            apow = apow * alpha % P
            combined = add(emul(l0, zlk), combined, apow)
            apow = apow * alpha % P

        # quotient recomposition: sum_t zeta^(n t) q_{c,t}(zeta)
        qsum = (0, 0)
        zpow = (1, 0)
        for t in range(rate):
            qsum = eadd(qsum, emul(zpow, quot_o[c * rate + t]))
            zpow = emul(zpow, zeta_n)
        lhs = combined
        rhs = emul(qsum, zh)
        assert lhs == rhs, f"constraint identity fails (batch {b}, challenge {c})"

    # ---- FRI ---------------------------------------------------------------
    fri_alpha = _chal_ext(ch)
    fp = proof.fri_proof
    num_layers, final_size, _nf = fri_mod.plan(N, cfg)
    tables, final_shift = fri_mod._domain_tables(N, num_layers)
    fri_betas = []
    for li in range(num_layers):
        ch.observe_cap(_cap_at(fp.caps[li], b))
        fri_betas.append(_chal_ext(ch))
    nfinal = _nf
    final_coeffs = [
        (_pair_at((fp.final_coeffs[0][0][b], fp.final_coeffs[0][1][b]), (k,)),
         _pair_at((fp.final_coeffs[1][0][b], fp.final_coeffs[1][1][b]), (k,)))
        for k in range(nfinal)
    ]
    for k in range(nfinal):
        ch.observe_ext(_to_alg(final_coeffs[k]))
    if cfg.fri.proof_of_work_bits:
        assert fp.pow_witness is not None, "missing FRI PoW witness"
        w = (np.asarray(fp.pow_witness[0])[b], np.asarray(fp.pow_witness[1])[b])
        assert ch.check_pow(w, cfg.fri.proof_of_work_bits), "FRI PoW check failed"
    idx_arrays = ch.get_indices(N, cfg.fri.num_query_rounds)
    indices = [int(ix) for ix in idx_arrays]
    assert indices == [int(v) for v in fp.indices[b]], "query indices mismatch"

    gz = emul(zeta, (data.g, 0))
    tree_caps = {
        "fixed": data.fixed_tree.cap,
        "wires": _cap_at(proof.wires_cap, b),
        "zs": _cap_at(proof.zs_cap, b),
        "quot": _cap_at(proof.quotient_cap, b),
    }
    tree_order = ["fixed", "wires", "zs", "quot"]
    G_N = pow(gl.POWER_OF_TWO_GENERATOR, (1 << 32) // N, P)

    for qi, idx in enumerate(indices):
        # initial tree openings
        leaf_vals = []
        for name in tree_order:
            llo, lhi = proof.initial_leaves[name]
            plo, phi = proof.initial_paths[name]
            leaf_lo = np.asarray(llo[b, qi])
            leaf_hi = np.asarray(lhi[b, qi])
            ok = merkle.verify_merkle_proof(
                leaf_lo, leaf_hi, idx, np.asarray(plo[b, qi]), np.asarray(phi[b, qi]),
                np.asarray(tree_caps[name][0]),
                np.asarray(tree_caps[name][1]),
            )
            assert ok, f"initial merkle proof fails: {name} q{qi} (batch {b})"
            leaf_vals.extend(int(v) for v in gl.to_u64(leaf_lo, leaf_hi))
        assert len(leaf_vals) == layout.total
        x = ntt.COSET_SHIFT * pow(G_N, idx, P) % P
        opens_list = [_ext_at(proof.openings0, (b, i)) for i in range(layout.total)]
        red0 = (0, 0)
        apow = (1, 0)
        for v, y in zip(leaf_vals, opens_list):
            red0 = eadd(red0, emul(apow, esub((v, 0), y)))
            apow = emul(apow, fri_alpha)
        Fv = emul(red0, einv(esub((x, 0), zeta)))
        red1 = (0, 0)
        apow1 = (1, 0)
        for c, zi in enumerate(z_idx):
            vz = leaf_vals[sl["zs_partials"].start + zi]
            red1 = eadd(red1, emul(apow1, esub((vz, 0), opens1[c])))
            apow1 = emul(apow1, fri_alpha)
        Fv = eadd(Fv, emul(apow, emul(red1, einv(esub((x, 0), gz)))))

        # fold layers
        cur_idx = idx
        for li, (shift, gen, _inv2x) in enumerate(tables):
            size = N >> li
            half = size // 2
            j = cur_idx % half
            llo, lhi = fp.layer_leaves[li]
            leaf_lo = np.asarray(llo[b, qi])
            leaf_hi = np.asarray(lhi[b, qi])
            vals = [int(v) for v in gl.to_u64(leaf_lo, leaf_hi)]
            a_val = (vals[0], vals[1])
            b_val = (vals[2], vals[3])
            expect = a_val if cur_idx < half else b_val
            assert expect == Fv, f"FRI fold mismatch layer {li} q{qi} (batch {b})"
            plo, phi = fp.layer_paths[li]
            ok = merkle.verify_merkle_proof(
                leaf_lo, leaf_hi, j, np.asarray(plo[b, qi]), np.asarray(phi[b, qi]),
                np.asarray(_cap_at(fp.caps[li], b)[0]), np.asarray(_cap_at(fp.caps[li], b)[1]))
            assert ok, f"FRI layer merkle fails layer {li} q{qi}"
            xj = shift * pow(gen, j, P) % P
            beta = fri_betas[li]
            s_val = eadd(a_val, b_val)
            d_val = esub(a_val, b_val)
            inv2 = pow(2, -1, P)
            Fv = eadd(escalar(s_val, inv2),
                      emul(beta, escalar(d_val, pow(2 * xj % P, -1, P))))
            cur_idx = j
        # final polynomial
        size = N >> num_layers
        gfin = pow(gl.POWER_OF_TWO_GENERATOR, (1 << 32) // size, P)
        xfin = final_shift * pow(gfin, cur_idx, P) % P
        acc = (0, 0)
        xp = 1
        for coef in final_coeffs:
            acc = eadd(acc, escalar(coef, xp))
            xp = xp * xfin % P
        assert acc == Fv, f"FRI final polynomial mismatch q{qi} (batch {b})"
    return True
