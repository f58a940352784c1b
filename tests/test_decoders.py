"""Decoder correctness against exact posteriors.

At d=3 every sector orbit is exactly enumerable, so the true per-class
posterior is known in closed form for every noise model (it's the
Boltzmann sum with vector betas).  Every decoder estimate must agree within
sampling tolerance — the strongest end-to-end check available without
reference hardware (the reference itself relies on cross-decoder agreement,
decoders.py:991-1006)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mcmc_qec_tpu.models import get_spec, np_eq_class, np_to_class
from mcmc_qec_tpu.models.noise import sample_depolarizing, sample_xyz
from mcmc_qec_tpu.mcmc.ladder import betas_depolarizing, betas_xyz
from mcmc_qec_tpu.decoders import (
    PTDC,
    PTEQ,
    PTEQConfig,
    PTEQ_alpha,
    PTRC,
    STDC,
    STDC_Nall_n_alpha,
    STDC_general_noise,
    STRC,
    single_temp,
)

from reference_oracles import exact_class_posterior


def _syndrome_state(family, d, p=0.1, seed=5):
    spec = get_spec(family, d)
    s = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(seed), spec, p, (1,))
    )[0]
    return spec, s


def tv(a, b):
    return 0.5 * np.abs(np.asarray(a, float) - np.asarray(b, float)).sum()


@pytest.mark.parametrize("family", ["toric", "planar", "rotated", "xzzx"])
def test_stdc_matches_exact_posterior(family):
    spec, s0 = _syndrome_state(family, 3)
    exact = exact_class_posterior(spec, s0, betas_depolarizing(0.1), np_to_class)
    distr = STDC(spec, s0[None], 0.1, p_sampling=0.25, droplets=4, steps=4000)
    assert tv(exact, distr[0] / 100.0) < 0.03, (exact, distr[0])


def test_stdc_batched_multiple_syndromes():
    spec = get_spec("planar", 3)
    B = 4
    states = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(1), spec, 0.12, (B,))
    )
    distr = STDC(spec, states, 0.12, p_sampling=0.3, droplets=4, steps=4000)
    for b in range(B):
        exact = exact_class_posterior(
            spec, states[b], betas_depolarizing(0.12), np_to_class
        )
        assert tv(exact, distr[b] / 100.0) < 0.03


def test_stdc_general_noise_matches_exact():
    spec, s0 = _syndrome_state("xzzx", 3, p=0.15, seed=7)
    p_xyz = np.array([0.02, 0.01, 0.12])
    # exact posterior with beta_i = -ln((p_i/3)/(1-p_i)) (decoders.py:389)
    be = -np.log((p_xyz / 3.0) / (1.0 - p_xyz))
    exact = exact_class_posterior(spec, s0, be, np_to_class)
    distr = STDC_general_noise(
        spec, s0[None], p_xyz, p_sampling=np.array([0.1, 0.05, 0.2]),
        droplets=4, steps=4000,
    )
    assert tv(exact, distr[0] / 100.0) < 0.04


def test_stdc_alpha_matches_exact():
    spec, s0 = _syndrome_state("xzzx", 3, p=0.1, seed=3)
    alpha, pz_tilde = 2.0, 0.15
    b = -np.log(pz_tilde)
    be = np.array([alpha * b, alpha * b, b])
    exact = exact_class_posterior(spec, s0, be, np_to_class)
    distr = STDC_Nall_n_alpha(
        spec, s0[None], pz_tilde_sampling=0.3, alpha=alpha, pz_tilde=pz_tilde,
        droplets=2, steps=6000,
    )
    assert tv(exact, distr[0] / 100.0) < 0.05


def test_strc_matches_exact_posterior():
    spec, s0 = _syndrome_state("planar", 3)
    exact = exact_class_posterior(spec, s0, betas_depolarizing(0.1), np_to_class)
    distr = STRC(spec, s0[None], 0.1, p_sampling=0.25, droplets=4, steps=6000)
    assert np.argmax(distr[0]) == np.argmax(exact)
    assert tv(exact, distr[0] / 100.0) < 0.12


def test_pteq_matches_exact_posterior():
    spec, s0 = _syndrome_state("toric", 3)
    exact = exact_class_posterior(spec, s0, betas_depolarizing(0.1), np_to_class)
    # decode 8 replicas, average — tightens per-replica MC error
    B = 8
    res = PTEQ(
        spec, np.tile(s0[None], (B, 1)), 0.1,
        PTEQConfig(max_steps=10000, window=200, TOPS=30, SEQ=4),
        seed=2,
    )
    mean_distr = res.distribution.mean(axis=0) / 100.0
    assert np.argmax(mean_distr) in np.argsort(exact)[-2:]
    # PTEQ's occupation estimate carries heavy autocorrelation (it is the
    # reference's estimator, decoders.py:66-68) — tolerance reflects that
    assert tv(exact, mean_distr) < 0.2


@pytest.mark.slow
def test_pteq_matches_exact_posterior_tight():
    """Long-statistics pin of PTEQ quality: TV < 0.05 vs the exact d=3
    posterior (VERDICT r3 weak #5 — the fast test's TV < 0.2 tolerance
    could hide a regression halving estimator quality).  64 replicas x
    24k steps averages down the occupation estimator's autocorrelation."""
    spec, s0 = _syndrome_state("toric", 3)
    exact = exact_class_posterior(spec, s0, betas_depolarizing(0.1), np_to_class)
    B = 64
    res = PTEQ(
        spec, np.tile(s0[None], (B, 1)), 0.1,
        PTEQConfig(max_steps=24000, window=400, TOPS=30, SEQ=4),
        seed=2,
    )
    assert res.converged.all()
    mean_distr = res.distribution.mean(axis=0) / 100.0
    assert np.argmax(mean_distr) == np.argmax(exact)
    assert tv(exact, mean_distr) < 0.05, (exact, mean_distr)


@pytest.mark.slow
def test_pteq_alpha_matches_exact_posterior_tight():
    """Same long-statistics bar for the alpha-noise PTEQ variant
    (decoders_biasednoise.py:175-222): TV < 0.05 vs the exact posterior
    under the alpha weighting."""
    spec, s0 = _syndrome_state("xzzx", 3, p=0.1, seed=3)
    alpha, pz_tilde = 2.0, 0.15
    b = -np.log(pz_tilde)
    be = np.array([alpha * b, alpha * b, b])
    exact = exact_class_posterior(spec, s0, be, np_to_class)
    B = 64
    res = PTEQ_alpha(
        spec, np.tile(s0[None], (B, 1)), pz_tilde, alpha,
        PTEQConfig(max_steps=24000, window=400, TOPS=30, SEQ=4), seed=4,
    )
    mean_distr = res.distribution.mean(axis=0) / 100.0
    assert np.argmax(mean_distr) == np.argmax(exact)
    assert tv(exact, mean_distr) < 0.05, (exact, mean_distr)


def test_pteq_alpha_runs_and_is_sane():
    spec, s0 = _syndrome_state("xzzx", 3, p=0.1, seed=3)
    alpha, pz_tilde = 2.0, 0.15
    b = -np.log(pz_tilde)
    be = np.array([alpha * b, alpha * b, b])
    exact = exact_class_posterior(spec, s0, be, np_to_class)
    B = 8
    res = PTEQ_alpha(
        spec, np.tile(s0[None], (B, 1)), pz_tilde, alpha,
        PTEQConfig(max_steps=6000, window=200, TOPS=20, SEQ=4), seed=4,
    )
    mean_distr = res.distribution.mean(axis=0) / 100.0
    assert np.argmax(mean_distr) == np.argmax(exact)


def test_ptdc_matches_exact_posterior():
    spec, s0 = _syndrome_state("planar", 3)
    exact = exact_class_posterior(spec, s0, betas_depolarizing(0.1), np_to_class)
    distr = PTDC(spec, s0[None], 0.1, p_sampling=0.25, droplets=2, steps=8000)
    assert np.argmax(distr[0]) == np.argmax(exact)
    assert tv(exact, distr[0] / 100.0) < 0.05


def test_ptrc_agrees_on_argmax():
    spec, s0 = _syndrome_state("planar", 3)
    exact = exact_class_posterior(spec, s0, betas_depolarizing(0.1), np_to_class)
    distr = PTRC(spec, s0[None], 0.1, p_sampling=0.25, droplets=2, steps=8000)
    assert np.argmax(distr[0]) == np.argmax(exact)


def test_single_temp_prefers_true_class():
    spec, s0 = _syndrome_state("planar", 3, p=0.08, seed=11)
    exact = exact_class_posterior(spec, s0, betas_depolarizing(0.08), np_to_class)
    means = single_temp(spec, s0[None], 0.08, max_iters=3000)
    # decision is argmin of mean energy (generate_data.py:199-203)
    assert np.argmin(means[0]) == np.argmax(exact)


def test_stdc_conv_mult_still_accurate():
    spec, s0 = _syndrome_state("planar", 3)
    exact = exact_class_posterior(spec, s0, betas_depolarizing(0.1), np_to_class)
    distr = STDC(spec, s0[None], 0.1, p_sampling=0.25, droplets=4, steps=4000,
                 conv_mult=2.0)
    assert tv(exact, distr[0] / 100.0) < 0.05


def test_pteq_alpha_with_shortest_returns_three_distributions():
    from mcmc_qec_tpu.decoders import PTEQ_alpha_with_shortest

    spec, s0 = _syndrome_state("xzzx", 3, p=0.1, seed=3)
    res = PTEQ_alpha_with_shortest(
        spec, s0[None], 0.15, 2.0,
        PTEQConfig(max_steps=3000, window=200, TOPS=10, SEQ=2), seed=1,
    )
    assert res.shortest_boltzmann.shape == (1, 4)
    assert res.shortest_counts.shape == (1, 4)
    assert abs(res.shortest_boltzmann.sum() - 100) < 1.0
    assert abs(res.shortest_counts.sum() - 100) < 1.0
    # shortest-chain argmax should match the exact posterior argmax here
    alpha, pz_tilde = 2.0, 0.15
    b = -np.log(pz_tilde)
    be = np.array([alpha * b, alpha * b, b])
    exact = exact_class_posterior(spec, s0, be, np_to_class)
    assert np.argmax(res.shortest_boltzmann[0]) == np.argmax(exact)


def test_stdc_sweep_engine_matches_exact_posterior():
    spec, s0 = _syndrome_state("planar", 3)
    exact = exact_class_posterior(spec, s0, betas_depolarizing(0.1), np_to_class)
    distr = STDC(spec, s0[None], 0.1, p_sampling=0.25, droplets=4, steps=1500,
                 engine="sweep")
    assert tv(exact, distr[0] / 100.0) < 0.03, (exact, distr[0])


def test_pteq_sweep_engine_matches_exact_posterior():
    spec, s0 = _syndrome_state("toric", 3)
    exact = exact_class_posterior(spec, s0, betas_depolarizing(0.1), np_to_class)
    B = 8
    res = PTEQ(
        spec, np.tile(s0[None], (B, 1)), 0.1,
        PTEQConfig(max_steps=8000, window=200, TOPS=30, SEQ=4, iters=2,
                   engine="sweep"),
        seed=3,
    )
    mean_distr = res.distribution.mean(axis=0) / 100.0
    assert np.argmax(mean_distr) in np.argsort(exact)[-2:]
    assert tv(exact, mean_distr) < 0.2


def test_stdc_pallas_engine_matches_exact_posterior():
    """STDC's counting path with the Pallas sweep kernel (interpret mode
    on the CPU): droplets sampled by the kernel, deduped and Boltzmann-
    summed on device, must match the exact class posterior."""
    from mcmc_qec_tpu.decoders.counting import make_sampler, z_direct_count
    from mcmc_qec_tpu.decoders.counting import SampleStream
    from mcmc_qec_tpu.ops.pauli import all_class_states, apply_stabilizers_uniform

    spec, s0 = _syndrome_state("planar", 3)
    exact = exact_class_posterior(spec, s0, betas_depolarizing(0.1), np_to_class)
    droplets, steps = 4, 1500
    sampler = make_sampler(spec, steps, iters_per_step=1, engine="kernel",
                           interpret=True)

    @jax.jit
    def run(s0, key):
        seeds = all_class_states(spec, s0)  # (K, nq)
        K = seeds.shape[0]
        states = jnp.broadcast_to(seeds[:, None], (K, droplets, spec.nq))
        k_rain, k_samp = jax.random.split(key)
        states = apply_stabilizers_uniform(spec, states, k_rain, 0.5)
        _, stream = sampler(states, k_samp,
                            jnp.asarray(betas_depolarizing(0.25), jnp.float32))
        merged = SampleStream(stream.keys.reshape(K, droplets * steps, 2),
                              stream.n_xyz.reshape(K, droplets * steps, 3))
        logz = z_direct_count(merged, jnp.asarray(betas_depolarizing(0.1),
                                                  jnp.float32))
        return jax.nn.softmax(logz)

    distr = np.asarray(run(jnp.asarray(s0), jax.random.PRNGKey(0)))
    assert tv(exact, distr) < 0.04, (exact, distr)


def test_trivial_syndrome_decodes_to_identity_class():
    """A zero-error state must decode to class 0 with high confidence."""
    spec = get_spec("planar", 5)
    s0 = np.zeros((1, spec.nq), dtype=np.uint8)
    distr = STDC(spec, s0, 0.05, p_sampling=0.25, droplets=2, steps=2000)
    assert np.argmax(distr[0]) == 0
    assert distr[0, 0] > 60


def test_stdc_handles_zero_probability_pauli():
    """p_y = 0 must not produce NaNs (infinite beta handling,
    decoders.py:385-389)."""
    spec, s0 = _syndrome_state("planar", 3, p=0.08, seed=2)
    p_xyz = np.array([0.05, 0.0, 0.05])
    distr = STDC_general_noise(spec, s0[None], p_xyz,
                               p_sampling=0.2, droplets=2, steps=1500)
    assert np.all(np.isfinite(distr))
    assert abs(distr.sum() - 100) < 1.0


def test_stdc_shortest_single_stream_matches_two_pass():
    """STDC_general_noise_shortest reduces BOTH distributions from one
    sampled stream (decoders.py:490-505); with the same seed it must equal
    the two independent shortest_only=False/True reductions exactly."""
    from mcmc_qec_tpu.decoders import STDC_general_noise_shortest

    spec, s0 = _syndrome_state("planar", 3, p=0.08, seed=3)
    p_xyz = np.array([0.04, 0.02, 0.06])
    kw = dict(p_sampling=0.25, droplets=2, steps=1200, seed=7)
    full, short = STDC_general_noise_shortest(spec, s0[None], p_xyz, **kw)
    full_ref = STDC_general_noise(spec, s0[None], p_xyz,
                                  shortest_only=False, **kw)
    short_ref = STDC_general_noise(spec, s0[None], p_xyz,
                                   shortest_only=True, **kw)
    assert np.allclose(full, full_ref, atol=1e-4)
    assert np.allclose(short, short_ref, atol=1e-4)
    assert abs(full.sum() - 100) < 1.0 and abs(short.sum() - 100) < 1.0


def test_exact_mld_matches_test_oracle():
    from mcmc_qec_tpu.decoders import exact_mld

    spec, s0 = _syndrome_state("planar", 3)
    betas = betas_depolarizing(0.1)
    ours = exact_mld(spec, s0[None], betas)[0]
    oracle = exact_class_posterior(spec, s0, betas, np_to_class)
    assert np.allclose(ours, oracle, atol=1e-10)
    # and STDC agrees with the library decoder end to end
    distr = STDC(spec, s0[None], 0.1, p_sampling=0.25, droplets=4, steps=3000)
    assert tv(ours, distr[0] / 100.0) < 0.03


def test_pteq_biased_matches_exact_posterior():
    from mcmc_qec_tpu.decoders import PTEQ_biased
    from mcmc_qec_tpu.models.noise import xyz_probs_from_biased

    spec, _ = _syndrome_state("xzzx", 3)
    p, eta = 0.12, 4.0
    px, py, pz = xyz_probs_from_biased(p, eta)
    s0 = np.asarray(sample_xyz(jax.random.PRNGKey(9), spec, px, py, pz, (1,)))[0]
    be = betas_xyz(px, py, pz)
    exact = exact_class_posterior(spec, s0, be, np_to_class)
    B = 8
    res = PTEQ_biased(
        spec, np.tile(s0[None], (B, 1)), p, eta,
        PTEQConfig(max_steps=6000, window=200, TOPS=20, SEQ=4), seed=6,
    )
    mean_distr = res.distribution.mean(axis=0) / 100.0
    assert np.argmax(mean_distr) == np.argmax(exact), (mean_distr, exact)


def test_pteq_batch_compaction_preserves_results():
    """Compaction repacks unconverged stragglers into smaller buckets;
    decode quality and result bookkeeping must be unaffected."""
    spec = get_spec("toric", 3)
    B = 64
    key = jax.random.PRNGKey(9)
    states = np.asarray(sample_depolarizing(key, spec, 0.05, (B,)))
    true = np_eq_class(spec, states)
    base = dict(engine="sweep", max_steps=8000, window=100, iters=4,
                TOPS=3, SEQ=1, eps=0.5)
    res_c = PTEQ(spec, states, 0.05,
                 PTEQConfig(**base, compact=True, min_compact=8), seed=5)
    res_n = PTEQ(spec, states, 0.05,
                 PTEQConfig(**base, compact=False), seed=5)
    assert len(res_c.buckets) >= 1, "compaction never triggered"
    assert res_n.buckets == ()
    for res in (res_c, res_n):
        assert res.distribution.shape == (B, spec.n_classes)
        # converged rows carry full (quantized) distributions
        assert (res.distribution[res.converged].sum(axis=1) > 80).all()
        assert np.mean(res.distribution.argmax(axis=1) == true) > 0.9
        assert res.converged.mean() > 0.7


def test_pteq_fetch_batching_is_bitwise_invariant():
    """pipeline_depth batches the device->host fetches of several windows
    into one round trip; convergence labels and snapshots use each
    window's own data, so without compaction (whose *timing* legitimately
    shifts with the deeper pipeline) results must be bit-identical to the
    depth-1 loop."""
    spec = get_spec("toric", 3)
    B = 24
    states = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(3), spec, 0.08, (B,))
    )
    base = dict(engine="sweep", max_steps=4000, window=100, iters=4,
                TOPS=3, SEQ=1, eps=0.5, compact=False)
    r1 = PTEQ(spec, states, 0.08,
              PTEQConfig(**base, pipeline_depth=1), seed=11)
    r8 = PTEQ(spec, states, 0.08,
              PTEQConfig(**base, pipeline_depth=8), seed=11)
    np.testing.assert_array_equal(r1.distribution, r8.distribution)
    np.testing.assert_array_equal(r1.converged, r8.converged)
    np.testing.assert_array_equal(r1.steps, r8.steps)
    np.testing.assert_array_equal(r1.tops0, r8.tops0)


def test_pteq_window_scaling_still_decodes():
    """window_scale_cap > 1 grows the window after compaction (coarser
    convergence cadence, same sampler); quality must be unaffected."""
    spec = get_spec("toric", 3)
    B = 64
    states = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(9), spec, 0.05, (B,))
    )
    true = np_eq_class(spec, states)
    res = PTEQ(
        spec, states, 0.05,
        PTEQConfig(engine="sweep", max_steps=8000, window=100, iters=4,
                   TOPS=3, SEQ=1, eps=0.5, min_compact=8,
                   window_scale_cap=4),
        seed=5,
    )
    assert len(res.buckets) >= 1, "compaction never triggered"
    assert np.mean(res.distribution.argmax(axis=1) == true) > 0.9
    assert res.converged.mean() > 0.7
