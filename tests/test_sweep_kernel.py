"""The Pallas sweep kernel (ops/sweep_kernel.py) against its plain XLA
reference (ops/dense_sweep.py) and exact enumeration.

On the CPU the kernel runs through the Pallas interpreter; the compiled
kernel is checked on the card by ``python chip_smoke.py`` and by the
``gpu``-marked test below."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mcmc_qec_tpu.models import get_spec, np_syndrome
from mcmc_qec_tpu.models.noise import sample_depolarizing
from mcmc_qec_tpu.mcmc.ladder import (
    beta_ladder_depolarizing,
    betas_xyz,
    make_ladder_step,
)
from mcmc_qec_tpu.ops import count_errors
from mcmc_qec_tpu.ops.dense_sweep import make_dense_sweep, sweep_logu
from mcmc_qec_tpu.ops.engines import VALID_ENGINES, resolve_engine
from mcmc_qec_tpu.ops.sweep_kernel import make_kernel_sweep

from test_metropolis import empirical_length_distribution, exact_length_distribution

BETAS = betas_xyz(0.05, 0.02, 0.09)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dense_reference(spec, states, betas, n_sweeps, key):
    """``n_sweeps`` dense sweeps and the log-uniforms they drew, stacked in
    the kernel's injected-``logu`` layout."""
    dense = make_dense_sweep(spec)
    keys = jax.random.split(key, n_sweeps)
    ref = states
    for k in keys:
        ref = dense(ref, k, betas)
    logu = jnp.stack([sweep_logu(spec, k, states.shape[:-1]) for k in keys])
    return ref, logu


def _random_states(spec, shape, seed=1, p=0.3):
    return sample_depolarizing(jax.random.PRNGKey(seed), spec, p, shape)


@pytest.mark.parametrize("family", ["toric", "planar", "rotated", "xzzx"])
@pytest.mark.parametrize("d", [3, 5])
def test_kernel_matches_dense_sweep_bit_for_bit(family, d):
    spec = get_spec(family, d)
    states = _random_states(spec, (37,))
    betas = jnp.asarray(BETAS, jnp.float32)
    ref, logu = _dense_reference(spec, states, betas, 2, jax.random.PRNGKey(5))
    out = make_kernel_sweep(spec, 2, interpret=True)(
        states, jax.random.PRNGKey(0), betas, logu=logu)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    assert (np.asarray(ref) != np.asarray(states)).any()


@pytest.mark.parametrize("B", [1, 7, 130])
def test_kernel_pads_any_batch(B):
    """Batches that are no multiple of the chain tile: padding chains are
    dropped and every real chain still equals the dense sweep's."""
    spec = get_spec("toric", 3)
    states = _random_states(spec, (B,), seed=B)
    betas = jnp.asarray(BETAS, jnp.float32)
    ref, logu = _dense_reference(spec, states, betas, 3, jax.random.PRNGKey(B))
    kern = make_kernel_sweep(spec, 3, interpret=True)
    out = kern(states, jax.random.PRNGKey(0), betas, logu=logu)
    assert out.shape == states.shape and out.dtype == jnp.uint8
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


@pytest.mark.parametrize("layout", ["rung_table", "per_chain"])
def test_kernel_batched_betas(layout):
    """PT rungs sweep at their own temperatures: a (1, Nc, 3) rung table
    broadcast over the ladder batch, or one beta row per chain."""
    spec = get_spec("toric", 5)
    B, Nc = 6, 5
    states = _random_states(spec, (B, Nc))
    ladder = jnp.asarray(beta_ladder_depolarizing(0.1, Nc), jnp.float32)
    if layout == "rung_table":
        betas = ladder[None]
    else:
        perm = jax.random.permutation(jax.random.PRNGKey(2), Nc)
        betas = jnp.broadcast_to(ladder[perm][None], (B, Nc, 3))
    ref, logu = _dense_reference(spec, states, betas, 2, jax.random.PRNGKey(9))
    out = make_kernel_sweep(spec, 2, interpret=True)(
        states, jax.random.PRNGKey(0), betas, logu=logu)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


@pytest.mark.parametrize("family", ["toric", "planar", "rotated", "xzzx"])
def test_kernel_generator_stationary(family):
    """With its own counter-based generator the kernel samples the exact
    Boltzmann length distribution and never changes a syndrome."""
    spec = get_spec(family, 3)
    rng = np.random.RandomState(5)
    state0 = ((rng.randint(0, 4, spec.nq) * (rng.rand(spec.nq) < 0.2))
              .astype(np.uint8) * spec.valid_mask)
    exact = exact_length_distribution(spec, state0, BETAS)
    kern = make_kernel_sweep(spec, 2, interpret=True)
    betas = jnp.asarray(BETAS, jnp.float32)

    @jax.jit
    def run(states, key):
        def body(s, k):
            s = kern(s, k, betas)
            return s, count_errors(s)

        return jax.lax.scan(body, states, jax.random.split(key, 120))

    states = jnp.broadcast_to(jnp.asarray(state0), (64, spec.nq))
    final, lengths = run(states, jax.random.PRNGKey(3))
    emp = empirical_length_distribution(np.asarray(lengths[40:]).ravel(),
                                        spec.nq)
    tv = 0.5 * np.abs(exact - emp).sum()
    assert tv < 0.08, f"TV distance {tv:.3f} too large"
    final = np.asarray(final)
    np.testing.assert_array_equal(
        np_syndrome(spec, final),
        np.tile(np_syndrome(spec, state0), (len(final), 1)),
    )


def test_kernel_ladder_step_moves_every_rung():
    """engine="kernel" inside the PT ladder step (interpret mode): state
    shape and syndromes preserved on every rung."""
    spec = get_spec("toric", 3)
    B, Nc = 4, 3
    step = make_ladder_step(spec, Nc, iters=2, p_logical=0.5,
                            engine="kernel", interpret=True)
    from mcmc_qec_tpu.mcmc.ladder import init_ladder

    s0 = _random_states(spec, (B,), p=0.1)
    ls = init_ladder(spec, s0, Nc)
    betas = jnp.asarray(beta_ladder_depolarizing(0.1, Nc), jnp.float32)
    ls2, bottom_eq, _, swap_acc = jax.jit(step)(ls, jax.random.PRNGKey(1),
                                                betas)
    assert ls2.state.shape == ls.state.shape
    assert bottom_eq.shape == (B,) and swap_acc.shape == (B, Nc - 1)
    syn0 = np_syndrome(spec, np.asarray(s0))
    for r in range(Nc):
        np.testing.assert_array_equal(
            np_syndrome(spec, np.asarray(ls2.state[:, r])), syn0)


def test_kernel_perm_ladder_step_keeps_syndromes():
    """engine="kernel" inside the position-carrying PT ladder step of
    PTDC/PTRC (interpret mode): every chain keeps its syndrome, ``pos``
    stays a permutation of the rungs and the keys come out in rung order."""
    from mcmc_qec_tpu.mcmc.ladder import (
        init_ladder, make_perm_ladder_step, perm_enter)
    from mcmc_qec_tpu.ops.pauli import make_hash_mults, pack_key

    spec = get_spec("toric", 3)
    B, Nc = 4, 3
    step = make_perm_ladder_step(spec, Nc, iters=1, engine="kernel",
                                 interpret=True)
    s0 = _random_states(spec, (B,), p=0.1)
    pls = perm_enter(init_ladder(spec, s0, Nc))
    betas = jnp.asarray(beta_ladder_depolarizing(0.1, Nc), jnp.float32)
    pls2, keys_pos, n_xyz, swap_acc = jax.jit(step)(
        pls, jax.random.PRNGKey(1), betas)
    assert keys_pos.shape == (B, Nc, 2) and n_xyz.shape == (B, Nc, 3)
    assert swap_acc.shape == (B, Nc - 1)
    np.testing.assert_array_equal(np.sort(np.asarray(pls2.pos), axis=1),
                                  np.tile(np.arange(Nc), (B, 1)))
    syn0 = np_syndrome(spec, np.asarray(s0))
    for j in range(Nc):
        np.testing.assert_array_equal(
            np_syndrome(spec, np.asarray(pls2.state[:, j])), syn0)
    keys_phys = np.asarray(pack_key(spec, pls2.state,
                                    jnp.asarray(make_hash_mults(spec))))
    order = np.argsort(np.asarray(pls2.pos), axis=1)
    np.testing.assert_array_equal(
        np.take_along_axis(keys_phys, order[:, :, None], axis=1),
        np.asarray(keys_pos))


# --- engine resolution -----------------------------------------------------


@pytest.mark.parametrize("kind", ["pteq", "counting", "chain"])
def test_auto_resolves_to_sweep_off_gpu(kind):
    assert resolve_engine("auto", kind, get_spec("toric", 5)) == "sweep"


@pytest.mark.parametrize("kind,d,expected", [
    ("pteq", 5, "kernel"), ("pteq", 13, "kernel"), ("pteq", 17, "sweep"),
    ("counting", 9, "kernel"), ("counting", 13, "sweep"),
    ("chain", 5, "sweep"),
])
def test_auto_resolves_per_family_and_width_on_gpu(kind, d, expected,
                                                   monkeypatch):
    """On a GPU "auto" picks the kernel for the PT window and counting
    families up to the widest code it was measured faster on."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert resolve_engine("auto", kind, get_spec("toric", d)) == expected


def test_kernel_refuses_codes_wider_than_its_tile():
    with pytest.raises(ValueError, match="up to 512 qubits"):
        make_kernel_sweep(get_spec("toric", 17), 1, interpret=True)


@pytest.mark.parametrize("builder", ["kernel", "sampler", "ladder",
                                     "perm_ladder"])
def test_kernel_engine_raises_off_gpu_without_interpret(builder):
    """No silent fallback: asking for the kernel on the CPU is an error
    unless the Pallas interpreter is requested explicitly."""
    from mcmc_qec_tpu.decoders.counting import make_sampler
    from mcmc_qec_tpu.mcmc.ladder import make_perm_ladder_step

    spec = get_spec("toric", 3)
    build = {
        "kernel": lambda **kw: make_kernel_sweep(spec, 1, **kw),
        "sampler": lambda **kw: make_sampler(spec, 4, 1, engine="kernel", **kw),
        "ladder": lambda **kw: make_ladder_step(spec, 3, 2, engine="kernel",
                                                **kw),
        "perm_ladder": lambda **kw: make_perm_ladder_step(
            spec, 3, 1, engine="kernel", **kw),
    }[builder]
    with pytest.raises(ValueError, match="interpret=True"):
        build()
    build(interpret=True)  # explicit interpreter request is accepted


@pytest.mark.parametrize("engine", ["pallas", "fused"])
def test_removed_engines_rejected(engine):
    assert engine not in VALID_ENGINES
    with pytest.raises(ValueError, match="unknown engine"):
        resolve_engine(engine, "pteq", get_spec("toric", 5))


# --- compile cache ----------------------------------------------------------


def _cache_dir_in_fresh_process(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c",
         "import mcmc_qec_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_env_var_wins(tmp_path):
    d = str(tmp_path / "cache")
    assert _cache_dir_in_fresh_process({"JAX_COMPILATION_CACHE_DIR": d}) == d


def test_compile_cache_default_is_inside_checkout():
    import mcmc_qec_tpu

    got = _cache_dir_in_fresh_process({})
    assert got == mcmc_qec_tpu.DEFAULT_CACHE_DIR == os.path.join(
        REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# --- on the card ------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("family,d", [("toric", 9), ("planar", 9)])
def test_compiled_kernel_matches_dense_sweep(family, d):
    """The compiled kernel against the XLA sweep with shared uniforms.  A
    fused multiply-add may move logr's last bit, so the only tolerated
    disagreements are chains whose uniform sits within 1e-5 of logr."""
    spec = get_spec(family, d)
    states = _random_states(spec, (4096,))
    betas = jnp.asarray(BETAS, jnp.float32)
    ref, logu = _dense_reference(spec, states, betas, 1, jax.random.PRNGKey(5))
    out = jax.jit(make_kernel_sweep(spec, 1))(
        states, jax.random.PRNGKey(0), betas, logu=logu)
    n_diff = int(jnp.sum(jnp.any(out != ref, axis=-1)))
    assert n_diff <= 2, n_diff
