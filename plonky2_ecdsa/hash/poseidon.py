"""Poseidon2 permutation over Goldilocks, width 12, x^7 S-box — vectorized.

The Merkle/transcript hash of the proof system (the role plonky2's
PoseidonGoldilocksConfig plays for the reference, SURVEY.md §2.9).

Why Poseidon2 and not plonky2's Poseidon (a deliberate, documented design
choice): the prover's largest operation count is the Merkle leaf sponge —
~32M permutations per proof batch, all integer field work.  The
classic Poseidon instance spends a dense 12x12 circulant MDS in EVERY round
(~864 u32 multiply-adds per round in the 22-bit-plane formulation).  The
Poseidon2 construction (Grassi-Khovratovich-Schofnegger 2022, ePrint
2023/323) replaces the linear layers with
  * external rounds: a block-circulant circ(2*M4, M4, M4) built from the
    paper's 4x4 MDS matrix M4, applied with an 8-add/4-double schedule per
    4-lane group (~170 u32 ops vs 864), and
  * internal rounds: M_I = (all-ones) + diag(mu_i - 1), i.e. one 12-lane
    sum plus one small-constant multiply per lane (~150 u32 ops),
with an extra external-layer application before the first round.  Round
structure (R_F = 8 external split 4+4, R_P = 22 internal, x^7) and the
128-bit security target match the width-12 Goldilocks instances of both
Poseidon (plonky2) and Poseidon2 (Plonky3 / Horizen Labs reference).

Instance parameters are fully reproducible offline (no vendored constants
anywhere in this image):
  * M4 is the Poseidon2 paper's published matrix ([[5,7,1,3],[4,6,1,1],
    [1,3,5,7],[1,1,4,6]]; its appendix's efficient application schedule is
    used verbatim, checked against plain matvec in tests).
  * Round constants come from the canonical Grain-LFSR derivation of the
    Poseidon reference implementation (Appendix F / hadeshash
    generate_parameters_grain.sage), instantiated for (prime field, x^alpha,
    n=64, t=12, R_F=8, R_P=22) — the same vetted stream the previous rounds'
    Poseidon instance used; Poseidon2 consumes 118 of them in application
    order (4x12 external, 22x1 internal, 4x12 external), exactly as the
    Horizen Labs poseidon2 parameter script does.
  * INTERNAL_DIAG (the mu_i) is the first tuple of small distinct integers,
    in the deterministic ascending search documented at
    scripts/gen_poseidon_constants.py, whose internal matrix has an
    IRREDUCIBLE characteristic polynomial over GF(p) — the Poseidon2
    paper's condition (§5.3) ruling out invariant-subspace trails of any
    length (irreducible min poly of maximal degree).  The check re-runs in
    tests/test_prover.py::test_poseidon_constants_from_spec.

Proof-transcript bit-compat with the Rust stack was already out of scope
(plonky2's ChaCha-seeded constants are unobtainable offline, BASELINE.md
"Bit-exactness scope"); the transcript is self-frozen instead
(tests/vectors/transcript_demo.json).

The state is carried STACKED: a single (lo, hi) u32-pair tensor with leading
axis 12, so the S-box and linear layers vectorize across lanes as well as
across the hashing batch (2^18 Merkle leaves hash as [12, 2^18] tensors).
"""

from __future__ import annotations


import numpy as np

from ..fields import goldilocks as gl

WIDTH = 12
RATE = 8
HALF_FULL_ROUNDS = 4
PARTIAL_ROUNDS = 22
TOTAL_ROUNDS = 2 * HALF_FULL_ROUNDS + PARTIAL_ROUNDS  # 30

# Poseidon2 paper 4x4 MDS block; external matrix = circ(2*M4, M4, M4).
M4 = ((5, 7, 1, 3),
      (4, 6, 1, 1),
      (1, 3, 5, 7),
      (1, 1, 4, 6))

# Internal-round diagonal mu_i (M_I[i][i] = mu_i, off-diagonal 1): first
# ascending tuple of small distinct ints whose M_I has an irreducible
# characteristic polynomial over GF(p) (deterministic search, see module
# docstring).  Max row sum 11 + 22 = 33 keeps the 22-bit-plane accumulation
# inside the _recombine3 bounds (q0,q1 < 2^30.1, q2 < 2^28.1).
INTERNAL_DIAG = (2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 22)

# Full 12x12 external matrix as ints (gate constraints / reference oracle).
EXT_MATRIX = [[M4[i % 4][j % 4] * (2 if i // 4 == j // 4 else 1)
               for j in range(WIDTH)] for i in range(WIDTH)]
INT_MATRIX = [[INTERNAL_DIAG[i] if i == j else 1 for j in range(WIDTH)]
              for i in range(WIDTH)]


def _gen_round_constants():
    """Grain-LFSR round-constant stream (Poseidon reference derivation).

    Init sequence: field tag 1 (prime field, 2 bits), sbox tag 0 (x^alpha,
    4 bits), field size 64 (12 bits), t=12 (12 bits), R_F=8 (10 bits),
    R_P=22 (10 bits), then 30 ones; 80-bit LFSR with taps 62,51,38,23,13,0;
    first 160 output bits discarded; shrinking sampler (emit the bit
    following each 1, skip the bit following each 0); 64-bit MSB-first
    candidates rejection-sampled until < p.  Poseidon2 consumes 118 values
    in application order: 4 external rounds x 12, 22 internal rounds x 1,
    4 external rounds x 12."""
    bits = []

    def push(v, w):
        bits.extend((v >> (w - 1 - i)) & 1 for i in range(w))

    push(1, 2)                       # prime field
    push(0, 4)                       # x^alpha S-box
    push(64, 12)                     # field bits
    push(WIDTH, 12)                  # t
    push(2 * HALF_FULL_ROUNDS, 10)   # R_F
    push(PARTIAL_ROUNDS, 10)         # R_P
    bits.extend([1] * 30)
    state = bits[:]
    assert len(state) == 80

    def clock():
        nb = (state[62] ^ state[51] ^ state[38] ^ state[23]
              ^ state[13] ^ state[0])
        state.pop(0)
        state.append(nb)
        return nb

    for _ in range(160):
        clock()

    def next_bit():
        while True:
            if clock() == 1:
                return clock()
            clock()

    out = []
    while len(out) < 2 * HALF_FULL_ROUNDS * WIDTH + PARTIAL_ROUNDS:
        v = 0
        for _ in range(64):
            v = (v << 1) | next_bit()
        if v < gl.P:
            out.append(v)
    return out


ROUND_CONSTANTS = _gen_round_constants()  # flat, application order (118)
_NEXT = HALF_FULL_ROUNDS * WIDTH          # 48
RC_EXT = ([ROUND_CONSTANTS[r * WIDTH:(r + 1) * WIDTH]
           for r in range(HALF_FULL_ROUNDS)]
          + [ROUND_CONSTANTS[_NEXT + PARTIAL_ROUNDS + r * WIDTH:
                             _NEXT + PARTIAL_ROUNDS + (r + 1) * WIDTH]
             for r in range(HALF_FULL_ROUNDS)])       # [8][12]
RC_INT = ROUND_CONSTANTS[_NEXT:_NEXT + PARTIAL_ROUNDS]  # [22]

# Padded [30, 12] table in ROUND ORDER (rows 0-3 external, 4-25 internal
# with only column 0 nonzero, 26-29 external), indexed by the jitted rounds.
_RC_TABLE = np.zeros((TOTAL_ROUNDS, WIDTH), dtype=np.uint64)
for _r in range(HALF_FULL_ROUNDS):
    _RC_TABLE[_r] = RC_EXT[_r]
    _RC_TABLE[HALF_FULL_ROUNDS + PARTIAL_ROUNDS + _r] = RC_EXT[HALF_FULL_ROUNDS + _r]
for _p in range(PARTIAL_ROUNDS):
    _RC_TABLE[HALF_FULL_ROUNDS + _p, 0] = RC_INT[_p]
_RC_U64 = _RC_TABLE
_RC_LO = (_RC_U64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
_RC_HI = (_RC_U64 >> np.uint64(32)).astype(np.uint32)


def _check_params():
    # distinct diagonal (equal entries make x - (mu_i - 1) a char-poly
    # factor) and the 22-bit-plane accumulation bound
    assert len(set(INTERNAL_DIAG)) == WIDTH
    assert 11 + max(INTERNAL_DIAG) <= 256, "plane accumulation bound"
    # external matrix invertible mod p (Gaussian elimination)
    mat = [[v % gl.P for v in row] for row in EXT_MATRIX]
    for col in range(WIDTH):
        piv = next((r for r in range(col, WIDTH) if mat[r][col]), None)
        assert piv is not None, "external matrix is singular"
        mat[col], mat[piv] = mat[piv], mat[col]
        inv = pow(mat[col][col], -1, gl.P)
        for r in range(col + 1, WIDTH):
            f = mat[r][col] * inv % gl.P
            if f:
                mat[r] = [(a - f * b) % gl.P for a, b in zip(mat[r], mat[col])]
    # the full irreducibility check for INT_MATRIX lives in
    # scripts/gen_poseidon_constants.py + test_poseidon_constants_from_spec
    # (it costs ~1 s of bigint poly arithmetic — too slow for import)


_check_params()


def _xp_of(lo):
    return gl._xp(lo)


def _sbox(x):
    x2 = gl.square(*x)
    x4 = gl.square(*x2)
    x3 = gl.mul(*x2, *x)
    return gl.mul(*x4, *x3)


# ---------------------------------------------------------------------------
# Linear layers — u64 interior, stacked [12, ...] tensors
# ---------------------------------------------------------------------------

def _recombine_halves_u64(xp, qlo, qhi):
    """32-bit-half accumulators (both < 2^41) -> canonical (lo, hi)."""
    lo64 = qlo + (qhi << np.uint64(32))
    top = (((qlo >> np.uint64(32)) + (qhi & gl._M32)) >> np.uint64(32)) + (
        qhi >> np.uint64(32))
    out = gl._reduce128_u64(xp, top, lo64)
    return gl._split64(xp, out)


def _ext_accum(x, xp, four):
    """External layer on one plane of 12 stacked rows (lazy, no reduction).

    The Poseidon2 paper's M4 schedule (8 adds + 4 doublings per 4-lane
    group), then out_g = y_g + sum_h y_h.  Peak growth 64x the input
    magnitude."""
    ys = []
    for g in range(3):
        x0, x1, x2, x3 = x[4 * g], x[4 * g + 1], x[4 * g + 2], x[4 * g + 3]
        t0 = x0 + x1
        t1 = x2 + x3
        t2 = x1 + x1 + t1
        t3 = x3 + x3 + t0
        t4 = t1 * four + t3
        t5 = t0 * four + t2
        ys.append((t3 + t5, t5, t2 + t4, t4))  # rows of M4 @ x_g
    s = [ys[0][i] + ys[1][i] + ys[2][i] for i in range(4)]
    return [ys[g][i] + s[i] for g in range(3) for i in range(4)]


def _ext_layer_u64(lo, hi, xp):
    v = gl._join64(xp, lo, hi)
    vl = v & gl._M32
    vh = v >> np.uint64(32)
    four = np.uint64(4)
    ql = _ext_accum(vl, xp, four)   # halves < 2^32, weight <= 64 -> < 2^38
    qh = _ext_accum(vh, xp, four)
    return _recombine_halves_u64(xp, xp.stack(ql, 0), xp.stack(qh, 0))


def _int_accum(x, xp, diag):
    s = x[0]
    for i in range(1, WIDTH):
        s = s + x[i]
    return [s + x[i] * diag[i] for i in range(WIDTH)]


_DIAG_M1_U64 = [np.uint64(d - 1) for d in INTERNAL_DIAG]
_DIAG_M1_U32 = [np.uint32(d - 1) for d in INTERNAL_DIAG]


def _int_layer_u64(lo, hi, xp):
    v = gl._join64(xp, lo, hi)
    vl = v & gl._M32
    vh = v >> np.uint64(32)
    ql = _int_accum(vl, xp, _DIAG_M1_U64)  # <= 33 * 2^32 < 2^38
    qh = _int_accum(vh, xp, _DIAG_M1_U64)
    return _recombine_halves_u64(xp, xp.stack(ql, 0), xp.stack(qh, 0))


# ---------------------------------------------------------------------------
# Linear layers — u32 22-bit part planes (the u32-pair interior), on row
# lists of the 12 state elements
# ---------------------------------------------------------------------------

_M22 = np.uint32(0x3FFFFF)
_M12 = np.uint32(0xFFF)
_M10 = np.uint32(0x3FF)
_M20 = np.uint32(0xFFFFF)


def _split3(lo, hi):
    """(lo, hi) u32 pair -> three 22/22/20-bit parts (weights 2^0, 2^22,
    2^44).  Accumulating the linear layers lazily over these planes keeps
    every tap product and row sum in plain u32 lanes (max row sum 64 ->
    < 2^28) with ONE modular recombination per output row."""
    p0 = lo & _M22
    p1 = (lo >> np.uint32(22)) | ((hi & _M12) << np.uint32(10))
    p2 = hi >> np.uint32(12)
    return p0, p1, p2


def _recombine3(q):
    """Three u32 part-sums (weights 2^0, 2^22, 2^44; q0,q1 < 2^30.1,
    q2 < 2^28.1) -> canonical (lo, hi)."""
    q0, q1, q2 = q
    z = np.uint32(0)
    lo32, c1 = gl.addc32(q0, (q1 & _M10) << np.uint32(22))
    mid = (q1 >> np.uint32(10)) + c1             # < 2^21, no wrap
    hi32, c2 = gl.addc32(mid, (q2 & _M20) << np.uint32(12))
    top = (q2 >> np.uint32(20)) + c2             # < 2^9
    # value = lo32 + 2^32 hi32 + 2^64 top; 2^64 = 2^32 - 1 (mod p)
    ulo = z - top
    uhi = top - (top != 0).astype(np.uint32)
    l, h, c = gl.add64(lo32, hi32, ulo, uhi)
    l, h, _ = gl.add64(l, h, c * gl.EPS, c * z)
    return gl.canonicalize(l, h)


def _ext_layer_rows_u32(rows):
    """rows: list of 12 (lo, hi) u32 pairs -> transformed list."""
    parts = [_split3(lo, hi) for lo, hi in rows]
    four = np.uint32(4)
    planes = [_ext_accum([p[k] for p in parts], None, four) for k in range(3)]
    return [_recombine3((planes[0][i], planes[1][i], planes[2][i]))
            for i in range(WIDTH)]


def _int_layer_rows_u32(rows):
    parts = [_split3(lo, hi) for lo, hi in rows]
    planes = [_int_accum([p[k] for p in parts], None, _DIAG_M1_U32)
              for k in range(3)]
    return [_recombine3((planes[0][i], planes[1][i], planes[2][i]))
            for i in range(WIDTH)]


def _rows_of(lo, hi):
    return [(lo[i], hi[i]) for i in range(WIDTH)]


def _stack_rows(rows, xp):
    return (xp.stack([r[0] for r in rows], 0), xp.stack([r[1] for r in rows], 0))


def _ext_layer(lo, hi, xp):
    if gl._use_u64(xp):
        return _ext_layer_u64(lo, hi, xp)
    return _stack_rows(_ext_layer_rows_u32(_rows_of(lo, hi)), xp)


def _int_layer(lo, hi, xp):
    if gl._use_u64(xp):
        return _int_layer_u64(lo, hi, xp)
    return _stack_rows(_int_layer_rows_u32(_rows_of(lo, hi)), xp)


def _add_rc(lo, hi, r, xp):
    shape = (WIDTH,) + (1,) * (lo.ndim - 1)
    rl = xp.asarray(_RC_LO[r]).reshape(shape)
    rh = xp.asarray(_RC_HI[r]).reshape(shape)
    return gl.add(lo, hi, rl, rh)


def permute_stacked(lo, hi):
    """(lo, hi) with leading axis WIDTH -> permuted pair."""
    xp = _xp_of(lo)
    if xp is not np:
        return _permute_stacked_jax(lo, hi)
    lo, hi = _ext_layer(lo, hi, xp)   # Poseidon2 initial external layer
    r = 0
    for _ in range(HALF_FULL_ROUNDS):
        lo, hi = _add_rc(lo, hi, r, xp)
        r += 1
        lo, hi = _sbox((lo, hi))
        lo, hi = _ext_layer(lo, hi, xp)
    for p in range(PARTIAL_ROUNDS):
        s0 = gl.add(lo[0], hi[0], _RC_LO[r, 0], _RC_HI[r, 0])
        r += 1
        s0 = _sbox(s0)
        lo = xp.concatenate([s0[0][None], lo[1:]], axis=0)
        hi = xp.concatenate([s0[1][None], hi[1:]], axis=0)
        lo, hi = _int_layer(lo, hi, xp)
    for _ in range(HALF_FULL_ROUNDS):
        lo, hi = _add_rc(lo, hi, r, xp)
        r += 1
        lo, hi = _sbox((lo, hi))
        lo, hi = _ext_layer(lo, hi, xp)
    return lo, hi


_PERMUTE_JIT = None


def _permute_stacked_jax(lo, hi):
    """JAX path: the permutation body is itself jitted, so each of the ~100
    call sites in a full prove emits one cached pjit call instead of
    re-tracing ~3k primitives."""
    global _PERMUTE_JIT
    if _PERMUTE_JIT is None:
        import jax

        _PERMUTE_JIT = jax.jit(_permute_rounds_jax)
    return _PERMUTE_JIT(lo, hi)


def _permute_rounds_jax(lo, hi):
    import jax
    import jax.numpy as jnp

    rc_lo = jnp.asarray(_RC_LO)  # [30, 12]
    rc_hi = jnp.asarray(_RC_HI)
    shape_tail = (1,) * (lo.ndim - 1)

    def full_round(r, state):
        lo, hi = state
        rl = rc_lo[r].reshape((WIDTH,) + shape_tail)
        rh = rc_hi[r].reshape((WIDTH,) + shape_tail)
        lo, hi = gl.add(lo, hi, rl, rh)
        lo, hi = _sbox((lo, hi))
        return _ext_layer(lo, hi, jnp)

    def partial_round(r, state):
        lo, hi = state
        s0 = gl.add(lo[0], hi[0], rc_lo[r, 0], rc_hi[r, 0])
        s0 = _sbox(s0)
        lo = lo.at[0].set(s0[0])
        hi = hi.at[0].set(s0[1])
        return _int_layer(lo, hi, jnp)

    state = _ext_layer(lo, hi, jnp)
    state = jax.lax.fori_loop(0, HALF_FULL_ROUNDS, full_round, state)
    state = jax.lax.fori_loop(HALF_FULL_ROUNDS, HALF_FULL_ROUNDS + PARTIAL_ROUNDS,
                              partial_round, state)
    state = jax.lax.fori_loop(HALF_FULL_ROUNDS + PARTIAL_ROUNDS, TOTAL_ROUNDS,
                              full_round, state)
    return state


def permute(state):
    """Compatibility wrapper: list of 12 (lo, hi) pairs -> permuted list."""
    xp = _xp_of(state[0][0])
    lo = xp.stack([s[0] for s in state], axis=0)
    hi = xp.stack([s[1] for s in state], axis=0)
    lo, hi = permute_stacked(lo, hi)
    return [(lo[i], hi[i]) for i in range(WIDTH)]


def hash_no_pad(elems):
    """Sponge over a list of (lo,hi) pairs (overwrite mode, rate 8) -> 4-pair
    digest list.  plonky2 hash_n_to_hash_no_pad equivalent.

    Under JAX the full-rate absorb chunks run as one lax.scan so the traced
    program holds a single permutation body per sponge call site."""
    assert elems
    xp = _xp_of(elems[0][0])
    zlo = xp.zeros_like(elems[0][0])
    zhi = xp.zeros_like(elems[0][1])
    lo = xp.stack([zlo] * WIDTH, axis=0)
    hi = xp.stack([zhi] * WIDTH, axis=0)
    nfull = len(elems) // RATE
    if xp is not np and nfull > 1:
        import jax

        clo = xp.stack([xp.stack([xp.broadcast_to(elems[i * RATE + j][0], zlo.shape)
                                  for j in range(RATE)], 0) for i in range(nfull)], 0)
        chi = xp.stack([xp.stack([xp.broadcast_to(elems[i * RATE + j][1], zhi.shape)
                                  for j in range(RATE)], 0) for i in range(nfull)], 0)

        def body(state, chunk):
            slo, shi = state
            slo = xp.concatenate([chunk[0], slo[RATE:]], axis=0)
            shi = xp.concatenate([chunk[1], shi[RATE:]], axis=0)
            return permute_stacked(slo, shi), None

        (lo, hi), _ = jax.lax.scan(body, (lo, hi), (clo, chi))
        rest = elems[nfull * RATE:]
    else:
        rest = None
        for off in range(0, len(elems), RATE):
            chunk = elems[off : off + RATE]
            clo = xp.stack([xp.broadcast_to(e[0], zlo.shape) for e in chunk], axis=0)
            chi = xp.stack([xp.broadcast_to(e[1], zhi.shape) for e in chunk], axis=0)
            lo = xp.concatenate([clo, lo[len(chunk):]], axis=0)
            hi = xp.concatenate([chi, hi[len(chunk):]], axis=0)
            lo, hi = permute_stacked(lo, hi)
    if rest:
        clo = xp.stack([xp.broadcast_to(e[0], zlo.shape) for e in rest], axis=0)
        chi = xp.stack([xp.broadcast_to(e[1], zhi.shape) for e in rest], axis=0)
        lo = xp.concatenate([clo, lo[len(rest):]], axis=0)
        hi = xp.concatenate([chi, hi[len(rest):]], axis=0)
        lo, hi = permute_stacked(lo, hi)
    return [(lo[i], hi[i]) for i in range(4)]


def two_to_one(left, right):
    """Compress two 4-pair digests -> 4-pair digest."""
    return hash_no_pad(list(left) + list(right))
