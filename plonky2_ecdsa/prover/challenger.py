"""Fiat-Shamir challenger: Poseidon duplex sponge, batched.

plonky2 Challenger equivalent (overwrite-mode duplex, rate 8).  All observed
values and squeezed challenges are (lo, hi) u32-pair arrays with an arbitrary
shared batch shape, so one instance drives a whole proof batch; the verifier
uses batch shape ().
"""

from __future__ import annotations

import numpy as np

from ..fields import goldilocks as gl
from ..hash import poseidon

# Sentinel written into a lane's PoW witness when the device grind exhausted
# its candidate space (astronomically unlikely; the silent w=0 it
# used to return would only surface as an obscure verification failure).
# Real witnesses are < max_chunks << chunk_log2 <= 2^27, so the sentinel is
# unambiguous; the host raises on it at proof collection (prover.collect).
GRIND_EXHAUSTED = 0xFFFFFFFF


class Challenger:
    def __init__(self, xp=np, batch_shape=()):
        self.xp = xp
        self.batch_shape = tuple(batch_shape)
        z = xp.zeros(self.batch_shape, dtype=xp.uint32)
        self.state = [(z, z) for _ in range(poseidon.WIDTH)]
        self.inputs: list = []
        self.outputs: list = []

    def _bc(self, pair):
        lo = self.xp.broadcast_to(self.xp.asarray(pair[0], dtype=self.xp.uint32), self.batch_shape)
        hi = self.xp.broadcast_to(self.xp.asarray(pair[1], dtype=self.xp.uint32), self.batch_shape)
        return (lo, hi)

    def observe(self, pair):
        self.inputs.append(self._bc(pair))
        self.outputs = []
        if len(self.inputs) == poseidon.RATE:
            self._duplex()

    def observe_elements(self, pairs):
        for p in pairs:
            self.observe(p)

    def observe_u64(self, vals):
        """vals: uint64 array broadcastable to batch shape (host arrays)."""
        arr = np.broadcast_to(np.asarray(vals, dtype=np.uint64), self.batch_shape)
        self.observe(gl.from_u64(arr))

    def observe_cap(self, cap):
        """cap: (lo, hi) arrays [..., C, 4]."""
        lo, hi = cap
        C = lo.shape[-2]
        self.observe_array((lo.reshape(lo.shape[:-2] + (C * 4,)),
                            hi.reshape(hi.shape[:-2] + (C * 4,))))

    def observe_ext(self, ext):
        self.observe(ext[0])
        self.observe(ext[1])

    def observe_ext_array(self, ext):
        """ext pair of [..., K] arrays; same transcript as K observe_ext
        calls (c0[i], c1[i] interleaved along the last axis)."""
        xp = self.xp
        (l0, h0), (l1, h1) = ext
        K = l0.shape[-1]
        lo = xp.stack([l0, l1], -1).reshape(l0.shape[:-1] + (2 * K,))
        hi = xp.stack([h0, h1], -1).reshape(h0.shape[:-1] + (2 * K,))
        self.observe_array((lo, hi))

    def observe_array(self, pair):
        """pair: (lo, hi) arrays of shape [..., K], absorbed in order along
        the last axis.  Bit-identical transcript to K observe() calls, but
        the full-rate chunks run as ONE lax.scan — a whole openings vector
        costs a single traced permutation body instead of K/8 inlined ones
        (the dominant contributor to prover jit compile time)."""
        lo, hi = pair
        K = lo.shape[-1]
        R = poseidon.RATE
        tgt = self.batch_shape + (K,)
        lo = self.xp.broadcast_to(self.xp.asarray(lo, dtype=self.xp.uint32), tgt)
        hi = self.xp.broadcast_to(self.xp.asarray(hi, dtype=self.xp.uint32), tgt)
        if self.xp is np or K < 2 * R:
            for i in range(K):
                self.observe((lo[..., i], hi[..., i]))
            return
        import jax

        xp = self.xp
        self.outputs = []
        pos = 0
        # complete any pending partial chunk element-wise
        j = len(self.inputs)
        if j:
            head = min(R - j, K)
            for i in range(head):
                self.observe((lo[..., i], hi[..., i]))
            pos = head
        nfull = (K - pos) // R
        if nfull:
            # [nfull, R, *batch] chunks, scanned through the duplex
            clo = xp.moveaxis(lo[..., pos : pos + nfull * R], -1, 0)
            chi = xp.moveaxis(hi[..., pos : pos + nfull * R], -1, 0)
            clo = clo.reshape((nfull, R) + self.batch_shape)
            chi = chi.reshape((nfull, R) + self.batch_shape)
            slo = xp.stack([s[0] for s in self.state], 0)
            shi = xp.stack([s[1] for s in self.state], 0)

            def body(state, chunk):
                slo, shi = state
                slo = xp.concatenate([chunk[0], slo[R:]], axis=0)
                shi = xp.concatenate([chunk[1], shi[R:]], axis=0)
                return poseidon.permute_stacked(slo, shi), None

            (slo, shi), _ = jax.lax.scan(body, (slo, shi), (clo, chi))
            self.state = [(slo[i], shi[i]) for i in range(poseidon.WIDTH)]
            self.inputs = []
            self.outputs = list(self.state[:R])
            pos += nfull * R
        for i in range(pos, K):
            self.observe((lo[..., i], hi[..., i]))

    def _duplex(self):
        for i, p in enumerate(self.inputs):
            self.state[i] = p
        self.state = poseidon.permute(self.state)
        self.inputs = []
        self.outputs = list(self.state[: poseidon.RATE])

    def get_challenge(self):
        if self.inputs or not self.outputs:
            self._duplex()
        return self.outputs.pop()

    def get_ext(self):
        a = self.get_challenge()
        b = self.get_challenge()
        return (a, b)

    def get_n_challenges(self, k):
        return [self.get_challenge() for _ in range(k)]

    def get_indices(self, domain_size: int, count: int):
        """count index arrays in [0, domain_size) (power of two: low bits)."""
        assert domain_size & (domain_size - 1) == 0
        mask = np.uint32(domain_size - 1)
        out = []
        for _ in range(count):
            lo, _hi = self.get_challenge()
            out.append(lo & mask)
        return out  # list of [batch] uint32 arrays

    # ------------------------------------------------------------------ PoW
    # FRI proof-of-work grinding (plonky2 fri proof_of_work_bits equivalent,
    # SURVEY.md §2.9 FRI params).  Protocol step shared by prover + verifier:
    # flush pending absorbs, then the response to witness w is the challenge
    # produced by observe(w); get_challenge().  Valid iff the top `pow_bits`
    # bits of the 64-bit response are zero.

    def check_pow(self, wpair, pow_bits: int):
        """Absorb witness pair [batch], return bool [batch] response check.
        Mutates the transcript exactly like the prover's grind."""
        assert 0 < pow_bits <= 32
        if self.inputs:
            self._duplex()
        self.observe(self._bc(wpair))
        _lo, hi = self.get_challenge()
        return (hi >> np.uint32(32 - pow_bits)) == 0

    def grind(self, pow_bits: int, chunk_log2: int = None, max_chunks: int = 4096):
        """Search (vectorized over candidates) for a per-lane witness whose
        response clears pow_bits leading zero bits; absorb it and return the
        witness pair.  Device path: a while_loop whose step runs a candidate
        axis of Poseidon permutations — the grind replaces plonky2's
        sequential per-thread search (rayon) with wide tensor sweeps.  Every
        path returns numpy's first-hit-in-order witness per lane."""
        assert 0 < pow_bits <= 32
        if chunk_log2 is None:
            # ~2^(pow_bits+4) candidates/sweep: per-lane miss prob e^-16/chunk
            chunk_log2 = min(15, pow_bits + 4)
        if self.inputs:
            self._duplex()
        xp = self.xp
        lo = xp.stack([s[0] for s in self.state], 0)  # [12, *batch]
        hi = xp.stack([s[1] for s in self.state], 0)
        shift = np.uint32(32 - pow_bits)
        M = 1 << chunk_log2
        bshape = self.batch_shape
        full = (poseidon.WIDTH,) + bshape + (M,)
        if xp is np:
            found = np.zeros(bshape, bool)
            w = np.zeros(bshape, np.uint32)
            k = 0
            while not found.all():
                assert k < max_chunks, "PoW grind exhausted candidate space"
                base = np.uint32(k << chunk_log2)
                cand = base + np.arange(M, dtype=np.uint32)
                slo = np.broadcast_to(lo[..., None], full).copy()
                shi = np.broadcast_to(hi[..., None], full).copy()
                slo[0] = np.broadcast_to(cand, bshape + (M,))
                shi[0] = 0
                _plo, phi = poseidon.permute_stacked(slo, shi)
                ok = (phi[7] >> shift) == 0  # [*batch, M]
                anyok = ok.any(-1)
                first = ok.argmax(-1).astype(np.uint32)
                w = np.where(~found & anyok, base + first, w)
                found |= anyok
                k += 1
        elif len(bshape) == 1 and bshape[0] > 8:
            # Lane-compacted grind (the wide sweep burns ~8 sweeps x B x
            # 2^15 permutations because FOUND lanes keep grinding;
            # expected work is B * 2^pow_bits * (ln B + c) ~ 4x the
            # per-lane optimum).  Each iteration serves only the first K
            # unfound lanes (stable argsort -> deterministic), scanning each
            # lane's candidate space strictly in order (per-lane base
            # counters), so the chosen witness is IDENTICAL to the wide
            # sweep's / numpy's first-hit-in-order witness.
            import jax
            import jax.numpy as jnp

            B = bshape[0]
            K = 8
            Mc = 1 << 14
            # per-lane budget: each iteration serves K of B lanes, so the
            # shared iteration bound scales by ceil(B/K)
            max_iters = (-(-B // K)) * ((max_chunks << chunk_log2) >> 14)

            def cond(carry):
                found, _w, _base, it = carry
                return jnp.logical_and(it < max_iters, ~found.all())

            def body(carry):
                found, w, base, it = carry
                order = jnp.argsort(found)      # unfound lanes first, stable
                sel = order[:K]                  # [K] unique lane ids
                active = ~found[sel]
                bases = base[sel]                # [K] u32
                cand = bases[:, None] + jax.lax.broadcasted_iota(
                    jnp.uint32, (K, Mc), 1)
                slo = jnp.broadcast_to(lo[:, sel, None], (poseidon.WIDTH, K, Mc))
                shi = jnp.broadcast_to(hi[:, sel, None], (poseidon.WIDTH, K, Mc))
                slo = slo.at[0].set(cand)
                shi = shi.at[0].set(0)
                _plo, phi = poseidon.permute_stacked(slo, shi)
                ok = (phi[7] >> shift) == 0      # [K, Mc]
                hit = jnp.logical_and(ok.any(-1), active)
                firstw = bases + jnp.argmax(ok, axis=-1).astype(jnp.uint32)
                w = w.at[sel].set(jnp.where(hit, firstw, w[sel]))
                found = found.at[sel].set(jnp.logical_or(found[sel], hit))
                base = base.at[sel].set(jnp.where(active, bases + Mc, bases))
                return (found, w, base, it + 1)

            found0 = jnp.zeros(bshape, bool)
            w0 = jnp.zeros(bshape, jnp.uint32)
            base0 = jnp.zeros(bshape, jnp.uint32)
            g_found, w, _base, _ = jax.lax.while_loop(
                cond, body, (found0, w0, base0, jnp.int32(0)))
            w = jnp.where(g_found, w, jnp.uint32(GRIND_EXHAUSTED))
        else:
            import jax
            import jax.numpy as jnp

            def cond(carry):
                found, _w, k = carry
                return jnp.logical_and(k < max_chunks, ~found.all())

            def body(carry):
                found, w, k = carry
                base = k.astype(jnp.uint32) << np.uint32(chunk_log2)
                cand = base + jax.lax.broadcasted_iota(
                    jnp.uint32, bshape + (M,), len(bshape))
                slo = jnp.broadcast_to(lo[..., None], full).at[0].set(cand)
                shi = jnp.broadcast_to(hi[..., None], full).at[0].set(0)
                _plo, phi = poseidon.permute_stacked(slo, shi)
                ok = (phi[7] >> shift) == 0
                anyok = ok.any(-1)
                first = jnp.argmax(ok, axis=-1).astype(jnp.uint32)
                w = jnp.where(jnp.logical_and(~found, anyok), base + first, w)
                return (jnp.logical_or(found, anyok), w, k + 1)

            found0 = jnp.zeros(bshape, bool)
            w0 = jnp.zeros(bshape, jnp.uint32)
            g_found, w, _ = jax.lax.while_loop(cond, body, (found0, w0, jnp.int32(0)))
            w = jnp.where(g_found, w, jnp.uint32(GRIND_EXHAUSTED))
        wpair = (xp.asarray(w, dtype=xp.uint32), xp.zeros(bshape, xp.uint32))
        self.observe(wpair)
        self.get_challenge()  # consume the (zero-prefixed) response
        return wpair
