"""Goldilocks NTT / coset LDE, vectorized over leading axes.

The prover's polynomial engine (plonky2's `PolynomialValues::lde` equivalent,
SURVEY.md §2.9 proving pipeline).  Radix-2 iterative Cooley-Tukey on
(lo, hi) u32-pair tensors; twiddle tables are precomputed per size on the
host and broadcast.  The same code runs under numpy and jax.numpy — stages
are static Python loops (log2 n), shapes static, so the whole transform jits.

Multi-chip sharding of the butterfly axis (all-to-all stage exchange) rides on
top in parallel/; this module is the single-device kernel.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..fields import goldilocks as gl

P = gl.P
COSET_SHIFT = 7  # multiplicative group generator, plonky2's coset shift


@lru_cache(maxsize=None)
def _twiddles(n: int, inverse: bool):
    """Per-stage twiddle tables (u64 numpy, converted at use)."""
    g = pow(gl.POWER_OF_TWO_GENERATOR, (1 << 32) // n, P)
    if inverse:
        g = pow(g, P - 2, P)
    stages = []
    m = 2
    while m <= n:
        wm = pow(g, n // m, P)
        row = np.zeros(m // 2, dtype=np.uint64)
        acc = 1
        for j in range(m // 2):
            row[j] = acc
            acc = acc * wm % P
        stages.append(row)
        m *= 2
    return stages


@lru_cache(maxsize=None)
def _bitrev(n: int):
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@lru_cache(maxsize=None)
def _stage_tables(n: int, inverse: bool):
    """Uniform table-driven butterfly: for every stage s and lane i,
    out[i] = x[A[s,i]] + W[s,i] * x[B[s,i]].

    This makes each stage identical in shape, so the whole transform runs as
    ONE lax.fori_loop body under jit (the unrolled concat formulation traces
    ~log2(n) * O(gl ops) primitives and dominated compile time)."""
    stages = _twiddles(n, inverse)
    S = len(stages)
    idx = np.arange(n, dtype=np.int64)
    A = np.zeros((S, n), np.int32)
    B = np.zeros((S, n), np.int32)
    W = np.zeros((S, n), np.uint64)
    m = 2
    for s, row in enumerate(stages):
        half = m // 2
        pos = idx & (m - 1)
        lo_half = pos < half
        partner = idx ^ half
        A[s] = np.where(lo_half, idx, partner)
        B[s] = np.where(lo_half, partner, idx)
        w = row[pos % half]  # w_m^(pos mod half)
        W[s] = np.where(lo_half, w, (P - w) % P)
        m *= 2
    return A, B, W


# --------------------------------------------------------------------------
# Device table registry.  Host tables (stage indices, twiddles, bit-reversal
# permutations, coset powers) referenced inside a jit trace become HLO
# *literals*, inflating the serialized module by ~100 MB at N=2^18 (slower
# compiles, and a persistent-cache key that hashes all of it).  A prover wrapper installs a
# pytree of these tables — received as a traced jit ARGUMENT — into this
# context for the duration of tracing; lookups then resolve to parameters
# instead of literals.  With no context installed (tests, ad-hoc jits), the
# numpy constants inline as before.
# --------------------------------------------------------------------------

import contextvars

_DEVICE_TABLES: contextvars.ContextVar = contextvars.ContextVar(
    "plonky2_device_tables", default=None)


def _tab(key: str, make):
    tabs = _DEVICE_TABLES.get()
    if tabs is not None and key in tabs:
        return tabs[key]
    return make()


def _stage_tables_dev(n, inverse):
    import jax.numpy as jnp

    A, B, W = _stage_tables(n, inverse)
    Wlo, Whi = gl.from_u64(W)
    return (jnp.asarray(A), jnp.asarray(B), jnp.asarray(Wlo), jnp.asarray(Whi))


def host_tables(sizes) -> dict:
    """Host-side pytree of every table the prover may trace for the given
    transform sizes (pass as a jit argument; unused entries are pruned)."""
    out = {}
    for n in sorted(set(sizes)):
        if n <= 1:
            continue
        if n >= _FOUR_STEP_MIN:
            n1, n2 = _split2(n)
            for nt in {n1, n2}:
                out[f"rev:{nt}"] = _bitrev(nt)
                for inverse in (False, True):
                    out[f"tws:{nt}:{int(inverse)}"] = tuple(_stage_rows(nt, inverse))
            for inverse in (False, True):
                out[f"fsT:{n}:{int(inverse)}"] = _four_step_T(n, inverse)
                out[f"coset:{n}:{int(inverse)}"] = gl.from_u64(_coset_powers(n, inverse))
            continue
        out[f"rev:{n}"] = _bitrev(n)
        for inverse in (False, True):
            A, B, W = _stage_tables(n, inverse)
            Wlo, Whi = gl.from_u64(W)
            out[f"stage:{n}:{int(inverse)}"] = (A, B, Wlo, Whi)
            out[f"coset:{n}:{int(inverse)}"] = gl.from_u64(_coset_powers(n, inverse))
    return out


# --------------------------------------------------------------------------
# Four-step reshape NTT (the large-n path, device and numpy alike).
#
# The table-driven per-stage gather formulation (below) makes every butterfly
# stage a dynamic gather over the whole tensor.  The four-step Bailey
# decomposition n = n1*n2 eliminates ALL per-stage gathers:
#
#   x view [n1, n2] (row-major) ->
#     A[k1, j2] = NTT_{n1} over axis -2          (lanes = n2, contiguous)
#     B        = A * T,  T[k1, j2] = w_n^{k1*j2} (one elementwise mul)
#     transpose -> [j2, k1]                      (one relayout)
#     X[k2, k1] = NTT_{n2} over axis -2          (lanes = n1, contiguous)
#   reshape [n] is natural order (k = k2*n1 + k1).
#
# Each sub-NTT runs DIT with bit-reversed input: the bit-reversal is a take
# over axis -2 (coarse, n1 rows of contiguous lanes) and every butterfly
# stage is reshape + slice + concat on axis -2 — no gathers at all.
# --------------------------------------------------------------------------

_FOUR_STEP_MIN = 1 << 10


def _split2(n: int):
    l = n.bit_length() - 1
    return 1 << (l // 2), 1 << (l - l // 2)  # (n1, n2), n1 <= n2


@lru_cache(maxsize=None)
def _stage_rows(n: int, inverse: bool):
    """Per-stage twiddle rows as (lo, hi) u32 arrays of shape [half, 1]."""
    return [tuple(a[:, None] for a in gl.from_u64(row))
            for row in _twiddles(n, inverse)]


@lru_cache(maxsize=None)
def _four_step_T(n: int, inverse: bool):
    """T[k1, j2] = w_n^{±k1*j2} as (lo, hi) u32 arrays [n1, n2]."""
    n1, n2 = _split2(n)
    g = pow(gl.POWER_OF_TWO_GENERATOR, (1 << 32) // n, P)
    if inverse:
        g = pow(g, P - 2, P)
    col = np.empty(n1, dtype=object)
    acc = 1
    for i in range(n1):
        col[i] = acc
        acc = acc * g % P
    T = np.zeros((n1, n2), dtype=np.uint64)
    for i in range(n1):
        w = int(col[i])
        acc = 1
        row = T[i]
        for j in range(n2):
            row[j] = acc
            acc = acc * w % P
    return gl.from_u64(T)


def _ntt_axis2(lo, hi, n_t: int, inverse: bool, xp):
    """DIT NTT over axis -2 of [..., n_t, L]; lanes on the last axis."""
    rev = _tab_rev(n_t, xp)
    lo = xp.take(lo, rev, axis=-2)
    hi = xp.take(hi, rev, axis=-2)
    rows = _tab_rows(n_t, inverse, xp)
    lead = lo.shape[:-2]
    L = lo.shape[-1]
    for s, (wl, wh) in enumerate(rows):
        half = 1 << s
        m = half * 2
        vl = lo.reshape(lead + (n_t // m, m, L))
        vh = hi.reshape(lead + (n_t // m, m, L))
        al, ah = vl[..., :half, :], vh[..., :half, :]
        bl, bh = vl[..., half:, :], vh[..., half:, :]
        tl, th = gl.mul(bl, bh, wl, wh)
        ul, uh = gl.add(al, ah, tl, th)
        dl, dh = gl.sub(al, ah, tl, th)
        lo = xp.concatenate([ul, dl], axis=-2).reshape(lead + (n_t, L))
        hi = xp.concatenate([uh, dh], axis=-2).reshape(lead + (n_t, L))
    return lo, hi


def _tab_rev(n: int, xp):
    if xp is np:
        return _bitrev(n)
    import jax.numpy as jnp

    return _tab(f"rev:{n}", lambda: jnp.asarray(_bitrev(n)))


def _tab_rows(n: int, inverse: bool, xp):
    if xp is np:
        return _stage_rows(n, inverse)
    import jax.numpy as jnp

    return _tab(f"tws:{n}:{int(inverse)}", lambda: tuple(
        (jnp.asarray(l), jnp.asarray(h)) for l, h in _stage_rows(n, inverse)))


def _tab_T(n: int, inverse: bool, xp):
    if xp is np:
        return _four_step_T(n, inverse)
    import jax.numpy as jnp

    return _tab(f"fsT:{n}:{int(inverse)}", lambda: tuple(
        jnp.asarray(a) for a in _four_step_T(n, inverse)))


def _ntt_four_step(lo, hi, inverse: bool, xp):
    n = lo.shape[-1]
    n1, n2 = _split2(n)
    lead = lo.shape[:-1]
    lo = lo.reshape(lead + (n1, n2))
    hi = hi.reshape(lead + (n1, n2))
    lo, hi = _ntt_axis2(lo, hi, n1, inverse, xp)          # A[k1, j2]
    Tl, Th = _tab_T(n, inverse, xp)
    lo, hi = gl.mul(lo, hi, Tl, Th)                       # B[k1, j2]
    lo = xp.swapaxes(lo, -1, -2)                          # [j2, k1]
    hi = xp.swapaxes(hi, -1, -2)
    lo, hi = _ntt_axis2(lo, hi, n2, inverse, xp)          # X[k2, k1]
    return lo.reshape(lead + (n,)), hi.reshape(lead + (n,))


@lru_cache(maxsize=None)
def _coset_powers(n: int, inverse: bool):
    s = pow(COSET_SHIFT, P - 2, P) if inverse else COSET_SHIFT
    out = np.zeros(n, dtype=np.uint64)
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = acc * s % P
    return out


def ntt(lo, hi, inverse: bool = False):
    """Forward/inverse NTT over the last axis (natural order in and out)."""
    xp = gl._xp(lo, hi)
    n = lo.shape[-1]
    assert n & (n - 1) == 0
    if n == 1:
        return lo, hi
    if n >= _FOUR_STEP_MIN:
        lo, hi = _ntt_four_step(lo, hi, inverse, xp)
        if inverse:
            ninv = pow(n, P - 2, P)
            nlo, nhi = gl.from_int(ninv, (), xp)
            lo, hi = gl.mul(lo, hi, nlo, nhi)
        return lo, hi
    if xp is np:
        rev = _bitrev(n)
        lo, hi = lo[..., rev], hi[..., rev]
        A, B, W = _stage_tables(n, inverse)
        Wlo, Whi = gl.from_u64(W)
        for s in range(A.shape[0]):
            blo, bhi = gl.mul(lo[..., B[s]], hi[..., B[s]], Wlo[s], Whi[s])
            lo, hi = gl.add(lo[..., A[s]], hi[..., A[s]], blo, bhi)
    else:
        import jax
        import jax.numpy as jnp

        revj = _tab(f"rev:{n}", lambda: jnp.asarray(_bitrev(n)))
        lo, hi = jnp.take(lo, revj, axis=-1), jnp.take(hi, revj, axis=-1)
        Aj, Bj, Wloj, Whij = _tab(
            f"stage:{n}:{int(inverse)}", lambda: _stage_tables_dev(n, inverse))

        def body(s, state):
            lo, hi = state
            a = (jnp.take(lo, Aj[s], axis=-1), jnp.take(hi, Aj[s], axis=-1))
            b = (jnp.take(lo, Bj[s], axis=-1), jnp.take(hi, Bj[s], axis=-1))
            t = gl.mul(b[0], b[1], Wloj[s], Whij[s])
            return gl.add(a[0], a[1], t[0], t[1])

        lo, hi = jax.lax.fori_loop(0, Aj.shape[0], body, (lo, hi))
    if inverse:
        ninv = pow(n, P - 2, P)
        nlo, nhi = gl.from_int(ninv, (), xp)
        lo, hi = gl.mul(lo, hi, nlo, nhi)
    return lo, hi


def intt(lo, hi):
    return ntt(lo, hi, inverse=True)


def coset_lde(lo, hi, rate_bits: int):
    """Values on H (order n, natural order) -> values on the coset
    COSET_SHIFT * K (order n * 2^rate_bits, natural order)."""
    n = lo.shape[-1]
    clo, chi = intt(lo, hi)
    return coset_ntt_from_coeffs(clo, chi, n << rate_bits)


def coset_ntt_from_coeffs(clo, chi, N: int | None = None):
    """Coeffs -> evals on shift * K_N.

    Coefficients may be COMPACT: with N > clo.shape[-1] the high coefficients
    are implicit zeros (zero-padded here)."""
    xp = gl._xp(clo, chi)
    k = clo.shape[-1]
    N = k if N is None else N
    if N > k:
        pad = lead_pad(clo.shape[:-1], N - k, xp)
        clo = xp.concatenate([clo, pad], axis=-1)
        chi = xp.concatenate([chi, pad], axis=-1)
    if xp is np:
        plo, phi = gl.from_u64(_coset_powers(N, False))
    else:
        import jax.numpy as jnp

        plo, phi = _tab(f"coset:{N}:0", lambda: tuple(
            jnp.asarray(a) for a in gl.from_u64(_coset_powers(N, False))))
    slo, shi = gl.mul(clo, chi, plo, phi)
    return ntt(slo, shi)


def coset_intt(lo, hi):
    """Evals on shift * K_N -> coefficients."""
    xp = gl._xp(lo, hi)
    N = lo.shape[-1]
    clo, chi = intt(lo, hi)
    if xp is np:
        plo, phi = gl.from_u64(_coset_powers(N, True))
    else:
        import jax.numpy as jnp

        plo, phi = _tab(f"coset:{N}:1", lambda: tuple(
            jnp.asarray(a) for a in gl.from_u64(_coset_powers(N, True))))
    return gl.mul(clo, chi, plo, phi)


def lead_pad(lead, k, xp):
    return xp.zeros(tuple(lead) + (k,), dtype=xp.uint32)


def lde_domain(n_lde: int) -> np.ndarray:
    """The coset points shift * G^i, natural order (u64)."""
    g = pow(gl.POWER_OF_TWO_GENERATOR, (1 << 32) // n_lde, P)
    out = np.zeros(n_lde, dtype=np.uint64)
    acc = COSET_SHIFT % P
    for i in range(n_lde):
        out[i] = acc
        acc = acc * g % P
    return out


def eval_poly_ext(clo, chi, zpows):
    """Evaluate base-coefficient polys at an extension point.

    clo/chi: [..., n]; zpows: ext powers from `ext_powers` broadcastable to
    [..., n].  Returns ext pair of shape [...]."""
    xp = gl._xp(clo, chi)
    p0 = gl.mul(clo, chi, *zpows[0])
    p1 = gl.mul(clo, chi, *zpows[1])
    return (_sum_last(p0, xp), _sum_last(p1, xp))


def _sum_last(pair, xp):
    """Sum a pair array over the last axis, mod p (tree reduction)."""
    lo, hi = pair
    while lo.shape[-1] > 1:
        k = lo.shape[-1]
        if k % 2:
            lo = xp.concatenate([lo, xp.zeros(lo.shape[:-1] + (1,), xp.uint32)], -1)
            hi = xp.concatenate([hi, xp.zeros(hi.shape[:-1] + (1,), xp.uint32)], -1)
            k += 1
        lo1, hi1 = lo[..., : k // 2], hi[..., : k // 2]
        lo2, hi2 = lo[..., k // 2 :], hi[..., k // 2 :]
        lo, hi = gl.add(lo1, hi1, lo2, hi2)
    return lo[..., 0], hi[..., 0]


def ext_powers(zeta, n: int):
    """[1, zeta, ..., zeta^(n-1)] along a NEW last axis.

    zeta: ext pair with arbitrary (e.g. batch) shape S -> ext pair arrays of
    shape [*S, n].  Log-depth doubling, vectorized, jit-friendly."""
    xp = gl._xp(zeta[0][0])

    def expand(pair):
        return (pair[0][..., None], pair[1][..., None])

    one0 = (xp.ones_like(zeta[0][0])[..., None], xp.zeros_like(zeta[0][1])[..., None])
    one1 = (xp.zeros_like(zeta[1][0])[..., None], xp.zeros_like(zeta[1][1])[..., None])
    out = (one0, one1)  # length 1
    p = (expand(zeta[0]), expand(zeta[1]))  # zeta^(current length)
    while out[0][0].shape[-1] < n:
        nxt = gl.ext_mul(out, p)
        out = (
            (xp.concatenate([out[0][0], nxt[0][0]], -1), xp.concatenate([out[0][1], nxt[0][1]], -1)),
            (xp.concatenate([out[1][0], nxt[1][0]], -1), xp.concatenate([out[1][1], nxt[1][1]], -1)),
        )
        p = gl.ext_square(p)
    return (
        (out[0][0][..., :n], out[0][1][..., :n]),
        (out[1][0][..., :n], out[1][1][..., :n]),
    )
