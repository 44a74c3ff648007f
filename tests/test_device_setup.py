"""Device setup on the CPU: compile-cache location, the Goldilocks interior
per platform, the device grind path, the no-fallback fixed commitment, and
chip_smoke.py's refusal to run without a GPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from plonky2_ecdsa import jaxcfg
from plonky2_ecdsa.fields import goldilocks as gl
from plonky2_ecdsa.prover import data as data_mod
from plonky2_ecdsa.prover.challenger import GRIND_EXHAUSTED, Challenger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcfg.cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxcfg.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_field_interior_is_u64(platform):
    assert jaxcfg.field_interior(platform) == "u64"


def test_field_interior_unknown_platform_raises():
    with pytest.raises(RuntimeError, match="no Goldilocks interior"):
        jaxcfg.field_interior("metal")


def _duplexed(B, seed):
    ch = Challenger(np, (B,))
    ch.observe(gl.from_u64(np.arange(B, dtype=np.uint64) * np.uint64(977)
                           + np.uint64(seed)))
    ch._duplex()
    return ch


def _jnp_grind(ch_np, pow_bits, **kw):
    """Jitted Challenger.grind from a numpy challenger's duplexed state."""
    import jax
    import jax.numpy as jnp

    slo = np.stack([s[0] for s in ch_np.state])
    shi = np.stack([s[1] for s in ch_np.state])

    @jax.jit
    def go(slo, shi):
        ch = Challenger(jnp, (slo.shape[1],))
        ch.state = [(slo[i], shi[i]) for i in range(slo.shape[0])]
        return ch.grind(pow_bits, **kw)

    return jax.device_get(go(jnp.asarray(slo), jnp.asarray(shi)))


def test_jitted_grind_b32_matches_numpy_first_hit():
    """The device grind at the production lane count (B=32, the path a GPU
    takes) returns numpy's first-hit witness for every lane."""
    B = 32
    w_np = _duplexed(B, 11).grind(8)
    w_dev = _jnp_grind(_duplexed(B, 11), 8)
    assert np.array_equal(w_dev[0], w_np[0])
    assert np.array_equal(w_dev[1], w_np[1])


def test_jitted_grind_exhaustion_poisons_lanes():
    """A candidate budget too small for the PoW bits leaves the sentinel in
    each unfound lane, which proof collection turns into a loud error."""
    w = _jnp_grind(_duplexed(12, 5), 26, max_chunks=1)
    assert (w[0] == np.uint32(GRIND_EXHAUSTED)).all()


def test_device_fixed_commit_failure_raises(monkeypatch):
    """A failing device fixed-commitment raises instead of silently
    rebuilding on the host."""
    from plonky2_ecdsa.hash import merkle

    def broken(*a, **k):
        raise RuntimeError("device build failed")

    def host(*a, **k):
        raise AssertionError("fell back to the host build")

    monkeypatch.setattr(data_mod, "_use_device", lambda: True)
    monkeypatch.setattr(data_mod, "_fixed_commit_host", host)
    monkeypatch.setattr(merkle, "build_merkle_tree", broken)
    vals = np.arange(4 * 16, dtype=np.uint64).reshape(4, 16)
    with pytest.raises(RuntimeError, match="device build failed"):
        data_mod._fixed_commit(vals, 16, 64, 1)


def test_stage_parity_small_widths():
    """The parity phase of chip_smoke.py and bench.py's preflight, at small
    slab widths (the frozen-digest stages keep their fixed shapes)."""
    sys.path.insert(0, REPO)
    from scripts.device_parity import stage_parity

    lines = []
    stage_parity(lines.append, lanes=2, wires=8, n=1 << 11, N=1 << 13)
    oks = [ln for ln in lines if ln.endswith(": OK")]
    assert len(oks) == 8, lines


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=600,
                       cwd=REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_contract_line_keys():
    sys.path.insert(0, REPO)
    import chip_smoke

    line = chip_smoke.contract_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "extra": 3})
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_lanes_equal_matches_b1_proof_lane():
    """chip_smoke's lane comparison: lane 0 of a B=2 proof is bit-identical
    to the B=1 proof of the same witness row; lane 1 is not."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from plonky2_ecdsa.circuit.examples import small_demo_circuit, small_demo_witness
    from plonky2_ecdsa.prover.data import build_circuit_data
    from plonky2_ecdsa.prover.prover import prove

    c = small_demo_circuit().build()
    d = build_circuit_data(c)
    W, pis = small_demo_witness(c, batch=2)
    p2 = prove(d, W, pis)
    p1 = prove(d, W[..., :1], pis[:1])
    assert chip_smoke.lanes_equal(p2, 0, p1, 0)
    assert not chip_smoke.lanes_equal(p2, 1, p1, 0)
