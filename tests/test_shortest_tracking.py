"""On-device shortest-chain tracking (decoders_biasednoise.py:93-172).

The reference walks every post-burn sample on the host, keeping per-class
Python sets of chains at the running-minimum n_eff (unbounded, one
set.add per step).  The batched version keeps a ShortestState in the
window scan carry: running min, count at the min, and a BOUNDED buffer of
distinct 64-bit chain keys, deduped with O(U) vector compares — no
per-step host traffic.  These tests pin the update rule to a host
set-based oracle and exercise the decoder/checkpoint integration the old
host loop excluded (engine choice, energy_chunk > 1, ckpt_dir).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mcmc_qec_tpu.decoders.pteq import (
    KEY_W,
    PTEQConfig,
    ShortestState,
    _shortest_update,
    init_shortest,
)


def _host_oracle(T, B, K, U, seed=0):
    """Feed the same random stream to the device update and a host model
    with reference semantics + the bounded-buffer cap."""
    rng = np.random.RandomState(seed)
    sh = init_shortest(B, K, U)
    val = np.full((B, K), np.inf, np.float32)
    cnt = np.zeros((B, K), np.int64)
    rec = [[set() for _ in range(K)] for _ in range(B)]  # recorded keys
    ovf = np.zeros((B, K), bool)
    step = jax.jit(_shortest_update)
    for _ in range(T):
        eq = rng.randint(0, K, B)
        e = rng.randint(3, 7, B).astype(np.float32)  # few levels -> ties
        kk = rng.randint(0, 4, (B, KEY_W)).astype(np.int32)  # collisions
        burned = rng.randint(0, 2, B).astype(np.int32)
        sh = step(sh, jnp.asarray(eq), jnp.asarray(kk), jnp.asarray(e),
                  jnp.asarray(burned))
        for b in range(B):
            if not burned[b]:
                continue
            k, key = eq[b], tuple(kk[b])
            if e[b] < val[b, k]:
                val[b, k] = e[b]
                cnt[b, k] = 1
                rec[b][k] = {key}
                ovf[b, k] = False
            elif e[b] == val[b, k]:
                cnt[b, k] += 1
                # device membership is against the RECORDED buffer: a key
                # dropped at overflow re-counts as overflow if seen again
                if key not in rec[b][k]:
                    if len(rec[b][k]) < U:
                        rec[b][k].add(key)
                    else:
                        ovf[b, k] = True
    nuq = np.array([[len(rec[b][k]) for k in range(K)] for b in range(B)])
    return sh, val, cnt, nuq, ovf


@pytest.mark.parametrize("U", [1, 3, 8])
def test_shortest_update_matches_host_sets(U):
    sh, val, cnt, nuq, ovf = _host_oracle(T=300, B=5, K=4, U=U, seed=U)
    np.testing.assert_array_equal(np.asarray(sh.val), val)
    np.testing.assert_array_equal(np.asarray(sh.cnt), cnt)
    np.testing.assert_array_equal(np.asarray(sh.nuq), nuq)
    np.testing.assert_array_equal(np.asarray(sh.ovf), ovf)
    assert ovf.any(), "oracle stream should exercise buffer overflow"


def test_shortest_buffer_contents_are_the_recorded_keys():
    rng = np.random.RandomState(7)
    B, K, U = 2, 3, 4
    sh = init_shortest(B, K, U)
    step = jax.jit(_shortest_update)
    seen = [[[] for _ in range(K)] for _ in range(B)]
    for _ in range(80):
        eq = rng.randint(0, K, B)
        kk = rng.randint(0, 3, (B, KEY_W)).astype(np.int32)
        e = np.full(B, 5.0, np.float32)  # all ties: pure dedup behavior
        sh = step(sh, jnp.asarray(eq), jnp.asarray(kk), jnp.asarray(e),
                  jnp.asarray(np.ones(B, np.int32)))
        for b in range(B):
            k, key = eq[b], tuple(kk[b])
            if key not in seen[b][k] and len(seen[b][k]) < U:
                seen[b][k].append(key)
    keys = np.asarray(sh.keys)
    nuq = np.asarray(sh.nuq)
    for b in range(B):
        for k in range(K):
            got = [tuple(keys[b, k, u]) for u in range(nuq[b, k])]
            assert got == seen[b][k]  # insertion order preserved


def test_pteq_with_shortest_fused_request_and_chunked_energy():
    """track_shortest does not force energy_chunk=1 or an engine: the
    default engine request with energy_chunk=4 must still match the exact
    shortest-chain posterior argmax at d=3."""
    from mcmc_qec_tpu.decoders import PTEQ_alpha_with_shortest
    from mcmc_qec_tpu.models import get_spec, np_to_class
    from mcmc_qec_tpu.models.noise import sample_depolarizing
    from reference_oracles import exact_class_posterior

    spec = get_spec("xzzx", 3)
    s0 = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(3), spec, 0.1, (1,))
    )[0]
    res = PTEQ_alpha_with_shortest(
        spec, s0[None], 0.15, 2.0,
        PTEQConfig(max_steps=3000, window=200, TOPS=10, SEQ=2,
                   engine="auto", energy_chunk=4), seed=1,
    )
    assert res.shortest_boltzmann.shape == (1, 4)
    assert abs(res.shortest_boltzmann.sum() - 100) < 1.0
    assert abs(res.shortest_counts.sum() - 100) < 1.0
    assert res.shortest_overflow is not None and not res.shortest_overflow.any()
    alpha, pz_tilde = 2.0, 0.15
    b = -np.log(pz_tilde)
    be = np.array([alpha * b, alpha * b, b])
    exact = exact_class_posterior(spec, s0, be, np_to_class)
    assert np.argmax(res.shortest_boltzmann[0]) == np.argmax(exact)


def test_pteq_with_shortest_tiny_cap_sets_overflow_flag():
    """With a unique-buffer cap of 1 the dedup buffer must saturate on any
    instance with >1 distinct shortest chain, and say so in the result."""
    from mcmc_qec_tpu.decoders import PTEQ_alpha_with_shortest
    from mcmc_qec_tpu.models import get_spec
    from mcmc_qec_tpu.models.noise import sample_depolarizing

    spec = get_spec("xzzx", 3)
    s0 = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(3), spec, 0.12, (1,))
    )[0]
    res = PTEQ_alpha_with_shortest(
        spec, s0[None], 0.15, 2.0,
        PTEQConfig(max_steps=2000, window=200, TOPS=8, SEQ=2,
                   shortest_unique_cap=1), seed=2,
    )
    assert res.shortest_overflow.any()
    assert abs(res.shortest_counts.sum() - 100) < 1.0


@pytest.mark.gpu
def test_kernel_shortest_matches_sweep():
    """With the sweep kernel inside the PT window, the on-device dedup scan
    must reproduce the XLA sweep engine's shortest distributions (RNG
    streams differ; replicated-batch comparison)."""
    from mcmc_qec_tpu.decoders import PTEQ_alpha_with_shortest
    from mcmc_qec_tpu.models import get_spec
    from mcmc_qec_tpu.models.noise import sample_depolarizing

    spec = get_spec("xzzx", 3)
    s0 = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(3), spec, 0.1, (1,))
    )[0]
    states = np.tile(s0[None], (8, 1))
    res = {}
    for eng in ("sweep", "kernel"):
        res[eng] = PTEQ_alpha_with_shortest(
            spec, states, 0.15, 2.0,
            PTEQConfig(max_steps=4000, window=200, TOPS=10, SEQ=2,
                       engine=eng, energy_chunk=4), seed=1,
        )
    for k in ("shortest_boltzmann", "shortest_counts"):
        a = getattr(res["sweep"], k).mean(0)
        b = getattr(res["kernel"], k).mean(0)
        assert 0.5 * np.abs(a - b).sum() / 100 < 0.1, (k, a, b)


def test_pteq_with_shortest_checkpoint_roundtrip(tmp_path):
    """ckpt_dir now composes with track_shortest: a run checkpointed every
    window and resumed from its own snapshots must equal the plain run."""
    from mcmc_qec_tpu.decoders import PTEQ_alpha_with_shortest
    from mcmc_qec_tpu.models import get_spec
    from mcmc_qec_tpu.models.noise import sample_depolarizing

    spec = get_spec("toric", 3)
    states = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(9), spec, 0.1, (4,))
    )

    def run(ckpt_dir):
        return PTEQ_alpha_with_shortest(
            spec, states, 0.15, 2.0,
            PTEQConfig(max_steps=800, window=100, TOPS=5, SEQ=2, iters=2,
                       engine="sweep", energy_chunk=4,
                       ckpt_dir=ckpt_dir, ckpt_every=1), seed=4,
        )

    base = run(None)
    with_ckpt = run(str(tmp_path / "ck"))  # observer only, never killed
    np.testing.assert_array_equal(
        with_ckpt.distribution, base.distribution
    )
    np.testing.assert_array_equal(
        with_ckpt.shortest_boltzmann, base.shortest_boltzmann
    )
    np.testing.assert_array_equal(
        with_ckpt.shortest_counts, base.shortest_counts
    )
