"""Merkle trees over Poseidon digests (4 Goldilocks elements), with caps.

plonky2 MerkleTree/MerkleCap equivalent (SURVEY.md §2.9 Poseidon Merkle caps):
the tree is truncated `cap_height` levels from the root and all 2^cap_height
subtree roots are published/absorbed.  Fully batched: every level is a
(lo, hi) u32-pair tensor of shape [..., size, 4]; the same code hashes one
tree on CPU or a whole proof batch on the accelerator.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fields import goldilocks as gl
from . import poseidon


def _pairs_from_axis(lo, hi, axis=-1):
    """Split pair arrays [..., W] into a list of W pairs [...]."""
    W = lo.shape[axis]
    return [(lo[..., i], hi[..., i]) for i in range(W)]


def _stack_pairs(pairs, xp):
    lo = xp.stack([p[0] for p in pairs], axis=-1)
    hi = xp.stack([p[1] for p in pairs], axis=-1)
    return lo, hi


def hash_leaves(leaf_lo, leaf_hi):
    """[..., L, W] leaf data -> [..., L, 4] digests."""
    xp = gl._xp(leaf_lo, leaf_hi)
    digest = poseidon.hash_no_pad(_pairs_from_axis(leaf_lo, leaf_hi))
    return _stack_pairs(digest, xp)


@dataclass
class MerkleTree:
    levels: list  # [(lo, hi)] arrays of shape [..., size, 4], leaves first
    cap_height: int

    @property
    def cap(self):
        return self.levels[-1]  # [..., 2^cap_height, 4]

    def open(self, idx):
        """idx: int array [...Q] (broadcast-compatible with batch axes).
        Returns path (lo, hi) arrays [...Q, depth, 4] of sibling digests."""
        xp = gl._xp(self.levels[0][0])
        num_levels = len(self.levels) - 1
        if num_levels == 0:
            shape = tuple(np.shape(idx)) + (0, 4)
            return xp.zeros(shape, xp.uint32), xp.zeros(shape, xp.uint32)
        if xp is not np:
            return self._open_packed(idx, xp, num_levels)
        sib_lo, sib_hi = [], []
        cur = idx
        for d in range(num_levels):
            llo, lhi = self.levels[d]
            sidx = cur ^ 1
            sib_lo.append(_take_batched(llo, sidx, xp))
            sib_hi.append(_take_batched(lhi, sidx, xp))
            cur = cur >> 1
        return xp.stack(sib_lo, axis=-2), xp.stack(sib_hi, axis=-2)

    def _open_packed(self, idx, xp, num_levels):
        """Device path: ONE gather for the whole path instead of one per
        level.  The query phase otherwise runs ~100 small per-level gather
        ops (4 trees x ~11 levels + FRI layers); concatenating the level digests and
        gathering all sibling positions at once collapses each tree.open to
        a single op."""
        idx = xp.asarray(idx)
        cat_lo = xp.concatenate([l[0] for l in self.levels[:-1]], axis=-2)
        cat_hi = xp.concatenate([l[1] for l in self.levels[:-1]], axis=-2)
        offs = np.concatenate([[0], np.cumsum(
            [l[0].shape[-2] for l in self.levels[:-2]])]).astype(np.int64)
        gidx = xp.stack([(idx >> d) ^ 1 for d in range(num_levels)], -1)
        gidx = gidx + xp.asarray(offs)  # [...Q, D] into the packed axis
        flat = gidx.reshape(gidx.shape[:-2] + (-1,))
        if cat_lo.ndim == 2:  # unbatched tree (fixed-poly commitment)
            out_lo = cat_lo[flat]
            out_hi = cat_hi[flat]
        else:
            import jax.numpy as jnp

            out_lo = jnp.take_along_axis(cat_lo, flat[..., None], -2)
            out_hi = jnp.take_along_axis(cat_hi, flat[..., None], -2)
        shape = gidx.shape + (4,)
        return out_lo.reshape(shape), out_hi.reshape(shape)


def _take_batched(arr, idx, xp):
    """arr: [B..., size, 4] or unbatched [size, 4]; idx: [B..., Q] -> [B..., Q, 4]."""
    idx = xp.asarray(idx)
    if arr.ndim == 2:  # unbatched tree (e.g. fixed-poly commitment)
        return arr[idx]
    take = np.take_along_axis if xp is np else _jnp_take_along
    return take(arr, idx[..., None], -2)


def _jnp_take_along(arr, idx, axis):
    import jax.numpy as jnp

    return jnp.take_along_axis(arr, idx, axis=axis)


def leaf_digests_from_polys(lde_lo, lde_hi, xp):
    """Streaming leaf hash from poly-major LDE tensors [..., k, N]: leaf j is
    the sponge over the k poly values at domain point j.

    Absorbs rate-8 slices along the POLY axis (state [12, ..., N]) instead of
    materializing the [..., N, k] leaf-major copy that hash_leaves needs —
    the peak-memory fix that lets the wires commitment stream through HBM.
    Returns digest arrays [..., N, 4]."""
    from . import poseidon

    k = lde_lo.shape[-2]
    lead = lde_lo.shape[:-2] + (lde_lo.shape[-1],)
    state_lo = xp.zeros((poseidon.WIDTH,) + lead, xp.uint32)
    state_hi = xp.zeros_like(state_lo)
    R = poseidon.RATE
    for off in range(0, k, R):
        r = min(R, k - off)
        chunk_lo = xp.moveaxis(lde_lo[..., off : off + r, :], -2, 0)
        chunk_hi = xp.moveaxis(lde_hi[..., off : off + r, :], -2, 0)
        state_lo = xp.concatenate([chunk_lo, state_lo[r:]], 0)
        state_hi = xp.concatenate([chunk_hi, state_hi[r:]], 0)
        state_lo, state_hi = poseidon.permute_stacked(state_lo, state_hi)
    return (xp.moveaxis(state_lo[:4], 0, -1), xp.moveaxis(state_hi[:4], 0, -1))


def build_merkle_tree_from_polys(lde_pair, cap_height: int, xp) -> MerkleTree:
    """Tree over leaves defined by poly-major LDE tensors [..., k, N]."""
    dlo, dhi = leaf_digests_from_polys(lde_pair[0], lde_pair[1], xp)
    return _build_tree_from_digests(dlo, dhi, cap_height, xp)


_SCAN_TAIL = 512  # level width below which tree levels roll into one lax.scan


def _build_tree_from_digests(dlo, dhi, cap_height: int, xp) -> MerkleTree:
    """Digest level stack.  Under JAX, levels narrower than _SCAN_TAIL run as
    ONE lax.scan over a fixed padded width: each scan step hashes the whole
    pad (garbage beyond the valid prefix is computed-and-ignored, < 7% extra
    sponge work) but the traced module holds a single compression body
    instead of one per level — the prover builds ~10 trees and the tail
    levels dominated its jit-module size."""
    L = dlo.shape[-2]
    assert L & (L - 1) == 0
    cap_height = min(cap_height, L.bit_length() - 1)
    cap_size = 1 << cap_height
    levels = [(dlo, dhi)]
    size = L
    while size > cap_size and (xp is np or size > _SCAN_TAIL):
        llo, lhi = levels[-1]
        pair_lo = llo.reshape(llo.shape[:-2] + (size // 2, 8))
        pair_hi = lhi.reshape(lhi.shape[:-2] + (size // 2, 8))
        digest = poseidon.hash_no_pad(_pairs_from_axis(pair_lo, pair_hi))
        levels.append(_stack_pairs(digest, xp))
        size //= 2
    if size > cap_size:
        import jax

        nlev = (size.bit_length() - 1) - cap_height
        W = size // 2  # fixed scanned width
        lead = levels[-1][0].shape[:-2]

        def step(carry, _):
            clo, chi = carry  # [..., size, 4]; valid prefix halves each step
            pair_lo = clo.reshape(lead + (W, 8))
            pair_hi = chi.reshape(lead + (W, 8))
            digest = poseidon.hash_no_pad(_pairs_from_axis(pair_lo, pair_hi))
            nlo, nhi = _stack_pairs(digest, xp)  # [..., W, 4]
            pad = xp.zeros(lead + (size - W, 4), xp.uint32)
            return (xp.concatenate([nlo, pad], -2),
                    xp.concatenate([nhi, pad], -2)), (nlo, nhi)

        _, (ys_lo, ys_hi) = jax.lax.scan(step, levels[-1], None, length=nlev)
        w = W
        for i in range(nlev):
            levels.append((ys_lo[i][..., :w, :], ys_hi[i][..., :w, :]))
            w //= 2
    return MerkleTree(levels=levels, cap_height=cap_height)


def build_merkle_tree(leaf_lo, leaf_hi, cap_height: int) -> MerkleTree:
    """leaf data [..., L, W] -> tree with cap at 2^cap_height roots."""
    xp = gl._xp(leaf_lo, leaf_hi)
    dlo, dhi = hash_leaves(leaf_lo, leaf_hi)
    return _build_tree_from_digests(dlo, dhi, cap_height, xp)


def verify_merkle_proof(leaf_lo, leaf_hi, idx: int, path_lo, path_hi, cap_lo, cap_hi) -> bool:
    """Single-element host-side verification.

    leaf: [W] pair arrays; path: [depth, 4]; cap: [2^cap, 4]."""
    cur = poseidon.hash_no_pad(_pairs_from_axis(leaf_lo, leaf_hi))
    cur_lo = np.stack([c[0] for c in cur], -1)
    cur_hi = np.stack([c[1] for c in cur], -1)
    i = int(idx)
    for d in range(path_lo.shape[0]):
        slo, shi = path_lo[d], path_hi[d]
        if i & 1:
            cat_lo = np.concatenate([slo, cur_lo], -1)
            cat_hi = np.concatenate([shi, cur_hi], -1)
        else:
            cat_lo = np.concatenate([cur_lo, slo], -1)
            cat_hi = np.concatenate([cur_hi, shi], -1)
        dig = poseidon.hash_no_pad(_pairs_from_axis(cat_lo, cat_hi))
        cur_lo = np.stack([c[0] for c in dig], -1)
        cur_hi = np.stack([c[1] for c in dig], -1)
        i >>= 1
    return bool(np.array_equal(cur_lo, cap_lo[i]) and np.array_equal(cur_hi, cap_hi[i]))
