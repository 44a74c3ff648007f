"""Circuit / FRI configuration presets.

Analogues of plonky2's CircuitConfig presets consumed by the reference
(`standard_ecc_config`, `wide_ecc_config`; SURVEY.md §2.9).  Wire counts match
the plonky2 presets; the gate inventory is this framework's own (fused wide
gates, boolean per-gate selectors), so the semantics of "routed" etc. are
self-consistent rather than byte-compatible.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class FriConfig:
    # Blowup 4x (plonky2's standard configs use 8x because their gate set has
    # degree-7 constraints; ours tops out at in-gate degree 4 — see
    # RandomAccessGate's top-bit split — so a 4x LDE carries the same quotient
    # and HALVES the prover's NTT/Merkle/constraint-eval work).  The security
    # level is held at plonky2's 100-bit conjectured target by raising the
    # query count: 42 queries x 2 bits/query + 16 PoW bits = 100.
    rate_bits: int = 2          # LDE blowup 4x
    cap_height: int = 4         # Merkle cap 2^4 roots
    num_query_rounds: int = 42
    proof_of_work_bits: int = 16  # FRI grinding, plonky2 standard-config parity
    arity_bits: int = 1         # fold arity 2
    # Stop folding at degree < 128: two fewer fold layers (each a committed
    # Merkle tree: prover runtime + jit-module size) for a 128-coefficient
    # final-poly check in the verifier.  FRI soundness depends on the rate
    # and query count, not the fold depth, so this is security-neutral.
    final_poly_max_degree_bits: int = 7


@dataclass(frozen=True)
class CircuitConfig:
    # 128 (plonky2 uses 135+1): the widest gate (RangeCheck(29,8)) needs
    # exactly 128, and every wire column costs LDE + Merkle-leaf-hash work
    num_wires: int = 128
    num_routed_wires: int = 80
    # 32 constant columns (plonky2 uses 2): the ECDSA circuit embeds ~18k
    # fixed-base-table constants, which at 2/row cost ~9k rows and pushed the
    # domain to 2^15; at 32/row (plus LogUp range rows, see
    # range_lookup_vals) the whole circuit fits n = 2^13.  Constant polys
    # are unbatched fixed data — widening them is nearly free.
    num_constant_cols: int = 32
    # LogUp range checks: limb width of the row-index lookup table (needs
    # n >= 2^limb_bits; 13 for the n=2^13 ECDSA circuit, small for tiny test
    # circuits) and max values packed per RangeLookup row (1+nl wires each;
    # the last wire column is reserved for the multiplicity counter).
    # 28 balances range-row count against LogUp helper-column count
    # (ceil(terms/3)+2 committed cols per challenge).
    range_lookup_limb_bits: int = 13
    range_lookup_vals: int = 28
    num_challenges: int = 2
    quotient_degree_factor: int = 4
    permutation_chunk_size: int = 4
    fri: FriConfig = field(default_factory=FriConfig)

    @staticmethod
    def standard_ecc_config() -> "CircuitConfig":
        return CircuitConfig()

    @staticmethod
    def p256_ecc_config() -> "CircuitConfig":
        """standard_ecc_config tuned so the P-256 windowed-mul circuit fits
        n = 2^13 (it sat at 2^14 before): 64 constant
        columns halve the ~18k-constant fixed-base-table rows (ConstantGate
        exposes constants as routed wires, so 64 <= 80 routed is the cap),
        and 31 range-lookup values/row (31*4+1 = 125 <= 128 wires) shave the
        range rows.  Costs +32 fixed polys and +8 LogUp helper columns per
        proof — cheap next to halving every per-domain-point stage.  secp
        keeps standard_ecc_config: it is already at 2^13, where these knobs
        only add overhead."""
        return CircuitConfig(num_constant_cols=64, range_lookup_vals=31)

    @staticmethod
    def wide_ecc_config() -> "CircuitConfig":
        # plonky2 wide_ecc_config widens the row (234 wires / 175 routed;
        # routed rounded to 176 here so permutation chunks divide evenly)
        return CircuitConfig(num_wires=234, num_routed_wires=176)

    @staticmethod
    def standard_recursion_config() -> "CircuitConfig":
        """plonky2 `standard_recursion_config` analogue (SURVEY.md §2.9;
        consumed by the reference at src/gadgets/biguint.rs:576): the preset a
        recursive-verifier circuit would run under — plonky2's 135-wire /
        80-routed row shape with the 8x-blowup, 28-query FRI parameterization.
        The gate inventory here is this framework's own, so the preset is
        shape-compatible rather than byte-compatible."""
        return CircuitConfig(
            num_wires=136,  # plonky2 uses 135; rounded even for u32-pair packing
            num_routed_wires=80,
            fri=FriConfig(rate_bits=3, cap_height=4, num_query_rounds=28,
                          proof_of_work_bits=16),
        )

    @staticmethod
    def recursion_ecc_config() -> "CircuitConfig":
        """Outer config for recursively verifying the production ECDSA
        circuit: rate-8 blowup (PoseidonGate is degree
        7), and 128 ROUTED wires so the verifier circuit's ~230k pooled
        arithmetic ops pack 32 per row instead of 20 at plonky2's 80 routed
        — the difference between the outer circuit landing at n=2^14 vs
        2^15.  28 queries x 3 bits/query + 16 PoW bits = 100-bit conjectured
        security (plonky2 standard_recursion_config FRI parity); CI proves
        the same circuit under a reduced-query outer FRI for wall-time."""
        return CircuitConfig(
            num_wires=136, num_routed_wires=128, num_constant_cols=2,
            range_lookup_limb_bits=3,
            fri=FriConfig(rate_bits=3, cap_height=4, num_query_rounds=28,
                          proof_of_work_bits=16),
        )

    @staticmethod
    def dryrun_config() -> "CircuitConfig":
        """Compile-tractable config for the multichip correctness dry run:
        minimal FRI query count, no PoW grinding, cap height 1.  This is a
        CORRECTNESS configuration (the dryrun checks sharding + transcript
        round-trip on CPU hosts), not a security parameterization."""
        return CircuitConfig(
            num_challenges=1,
            range_lookup_limb_bits=3,
            fri=FriConfig(rate_bits=2, cap_height=1, num_query_rounds=4,
                          proof_of_work_bits=0),
        )

    @staticmethod
    def test_config() -> "CircuitConfig":
        """Small fast config for CPU unit tests (lower FRI query count)."""
        return CircuitConfig(
            range_lookup_limb_bits=3,
            fri=FriConfig(rate_bits=2, cap_height=1, num_query_rounds=12,
                          proof_of_work_bits=8),
        )
