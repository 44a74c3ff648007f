"""Device-mesh sharding of the batched prover.

Accelerator replacement for the reference's only parallelism mechanism (rayon
shared-memory loops, src/curve/curve_msm.rs:133, Cargo.toml:8-9 — see
SURVEY.md §2 parallelism inventory): the axes that exist in this workload are

  * ``dp``  — the signature batch: every proof lane is independent, so the
    leading batch axis shards with zero communication (the production scaling
    axis, replacing ``par_chunks``);
  * ``col`` — the polynomial/column axis inside ONE proof: wire columns,
    LDE/NTT evaluation work and per-column Merkle leaf hashing shard over
    ``col``; XLA/GSPMD inserts the all-gathers where a step consumes every
    column (transcript observation, leaf concatenation); on one host these
    ride the all-to-all NVLink fabric, so the mesh is a plain reshape.

Both axes are expressed as a 2-D `jax.sharding.Mesh` + `NamedSharding`
annotations on the jitted prover — the idiomatic pjit/GSPMD formulation (no
hand-written collectives).
"""

from __future__ import annotations

import numpy as np

from ..prover.data import CircuitData
from ..prover import ntt
from ..prover.prover import (Backend, Proof, host_prep, prove_core,
                             prover_tables, _register_pytrees)


def prover_mesh(n_devices: int | None = None, col_parallel: int = 2):
    """2-D (dp, col) mesh over the first `n_devices` devices.

    col_parallel divides the device count when possible; otherwise the mesh
    degenerates to pure batch parallelism (col=1)."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices() if n_devices is None else jax.devices()[:n_devices]
    n = len(devs)
    col = col_parallel if (col_parallel > 0 and n % col_parallel == 0) else 1
    dp = n // col
    return Mesh(np.array(devs).reshape(dp, col), ("dp", "col"))


def prover_mesh_2level(n_hosts: int, chips_per_host: int, col_parallel: int = 2):
    """3-D (dcn, dp, col) mesh: the production multi-host layout.

    The proof batch shards over BOTH 'dcn' (across hosts, slow links) and
    'dp' (within a host) — batch lanes are fully independent, so the only
    cross-host traffic is input/output distribution.  The communicating
    'col' axis (all_gathers inside prove_core) stays INSIDE a host so its
    collectives ride the host's NVLink, per the mesh-axis ordering rule for
    hierarchical networks.
    On CI this is exercised with virtual CPU devices standing in for chips
    (SURVEY.md §7.6; real multi-host runs pass jax.distributed-initialized
    device lists)."""
    import jax
    from jax.sharding import Mesh

    need = n_hosts * chips_per_host
    devs = jax.devices()[:need]
    assert len(devs) == need, (len(devs), need)
    col = col_parallel if (col_parallel > 0 and chips_per_host % col_parallel == 0) else 1
    dp = chips_per_host // col
    return Mesh(np.array(devs).reshape(n_hosts, dp, col), ("dcn", "dp", "col"))


def make_mesh_prover(data: CircuitData, mesh):
    """Jitted prover with the witness batch sharded over 'dp' and the
    polynomial-column/LDE-domain axes over 'col'.  Returns
    run(W, pis) -> Proof (host numpy out).

    Uses shard_map, NOT pjit/GSPMD auto-partitioning: the per-shard module is
    the same single-device prover module (so jit compile cost does not grow
    with the mesh), the 'dp' axis is communication-free batch parallelism,
    and the 'col' axis splits the INTT/LDE column work and the pointwise
    domain work (Merkle leaf sponge, quotient eval, FRI reduced poly) inside
    prove_core with explicit tiled all_gathers at stage boundaries (see
    prover._lde_commit_sharded).  The batch size must be a multiple of the
    'dp' axis size."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as Pspec

    _register_pytrees()
    bk = Backend(data, jnp)
    ncol = mesh.shape.get("col", 1)
    shard = ("col", ncol) if ncol > 1 else None
    # every non-'col' axis shards the batch (dp, and dcn when 2-level)
    batch_axes = tuple(a for a in mesh.axis_names if a != "col")
    dp = Pspec(batch_axes)
    # Same platform split as make_jit_prover: closure literals on CPU (fast
    # XLA:CPU compiles), jit arguments on the GPU (no ~100 MB of constants in
    # the module or its cache key).
    use_params = mesh.devices.flat[0].platform != "cpu"

    if use_params:
        tabs = prover_tables(data, jnp)

        def _core(b, t, w, p, pv):
            tok = ntt._DEVICE_TABLES.set(t)
            try:
                return prove_core(data, b, w, p, pv, jnp,
                                  stream_commit=False, shard=shard)
            finally:
                ntt._DEVICE_TABLES.reset(tok)

        smapped = shard_map(
            _core, mesh=mesh,
            in_specs=(Pspec(), Pspec(), dp, dp, dp),
            out_specs=dp, check_vma=False)
        jcore = jax.jit(smapped)

        def core(w, p, pv):
            return jcore(bk, tabs, w, p, pv)
    else:
        smapped = shard_map(
            lambda w, p, pv: prove_core(data, bk, w, p, pv, jnp,
                                        stream_commit=False, shard=shard),
            mesh=mesh, in_specs=(dp, dp, dp), out_specs=dp, check_vma=False)
        core = jax.jit(smapped)

    def run(W: np.ndarray, pis: np.ndarray) -> Proof:
        ndp = 1
        for a in batch_axes:
            ndp *= mesh.shape[a]
        B = W.shape[-1] if not isinstance(W, tuple) else W[0].shape[0]
        assert B % ndp == 0, f"batch {B} must divide over batch axes ({ndp})"
        wires_pair, pi_pair, pis_pair = host_prep(data, W, pis)
        proof = core(wires_pair, pi_pair, pis_pair)
        proof = jax.device_get(proof)
        proof.pis = np.asarray(pis)
        return proof

    run.core = core
    run.mesh = mesh
    return run
