"""Multi-device sharding: decoders run SPMD over an 8-device CPU mesh and
agree with single-device execution; the driver dry-run entry points work."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mcmc_qec_tpu.models import get_spec
from mcmc_qec_tpu.models.noise import sample_depolarizing
from mcmc_qec_tpu.decoders import STDC
from mcmc_qec_tpu.parallel import make_mesh, shard_batch


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_stdc_matches_unsharded():
    spec = get_spec("planar", 3)
    B = 8
    states = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(0), spec, 0.1, (B,))
    )
    # unsharded
    d_ref = STDC(spec, states, 0.1, p_sampling=0.25, droplets=2, steps=800)
    # sharded: same computation with the batch partitioned over the mesh.
    from mcmc_qec_tpu.decoders.stdc import _class_seeds, _get_stdc_fn
    from mcmc_qec_tpu.mcmc.ladder import betas_depolarizing

    mesh = make_mesh()
    seeds = _class_seeds(spec, states)
    # same engine as the STDC default ("auto") so the per-element PRNG
    # streams are identical between the sharded and unsharded runs
    fn = _get_stdc_fn(spec, 2, 800, True, False, 0.0, "auto")
    distr, _ = fn(
        shard_batch(seeds, mesh),
        jax.random.PRNGKey(0),
        jnp.asarray(betas_depolarizing(0.25), jnp.float32),
        jnp.asarray(betas_depolarizing(0.1), jnp.float32),
    )
    distr = np.asarray(distr)
    # identical PRNG streams per element -> near-identical results
    assert np.allclose(distr, d_ref, atol=1e-3), (distr, d_ref)


def test_sharded_streaming_stdc_matches_unsharded():
    """The bounded-memory streaming reduction (round 4) runs SPMD over the
    mesh too: the whole scan — sampling, per-window sort-merge, bounded
    buffers — partitions over the syndrome batch with no collectives in
    the hot loop."""
    spec = get_spec("planar", 3)
    B = 8
    states = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(2), spec, 0.1, (B,))
    )
    d_ref = STDC(spec, states, 0.1, p_sampling=0.25, droplets=2, steps=800,
                 stream=True, seed=5)
    from mcmc_qec_tpu.decoders.stdc import (
        _class_seeds,
        _get_stdc_stream_fn,
        _pick_stream_window,
    )
    from mcmc_qec_tpu.mcmc.ladder import betas_depolarizing

    mesh = make_mesh()
    seeds = _class_seeds(spec, states)
    fn = _get_stdc_stream_fn(
        spec, 2, 800, True, "off", 0.0, "auto", False, 4096,
        _pick_stream_window(2, 800),
    )
    distr = fn(
        shard_batch(seeds, mesh),
        jax.random.PRNGKey(5),
        jnp.asarray(betas_depolarizing(0.25), jnp.float32),
        jnp.asarray(betas_depolarizing(0.1), jnp.float32),
    )[0]
    assert np.allclose(np.asarray(distr), d_ref, atol=1e-3), (distr, d_ref)


def test_graft_entry_single_chip():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)


def test_graft_entry_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_pallas_sweep_under_shard_map():
    """The Pallas sweep kernel under the 8-device mesh via shard_map: each
    device runs the kernel (interpret mode on the CPU) on its local batch
    shard with its own key.  Syndromes must be invariant and states must
    move."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from mcmc_qec_tpu.models import np_syndrome
    from mcmc_qec_tpu.mcmc.ladder import betas_depolarizing
    from mcmc_qec_tpu.ops.sweep_kernel import make_kernel_sweep

    spec = get_spec("toric", 5)
    mesh = make_mesh()
    B = 64  # 8 per device
    states = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(3), spec, 0.15, (B,))
    )
    kern = make_kernel_sweep(spec, 3, interpret=True)
    # hot sampling temperature so acceptance is high and the movement check
    # below is meaningful (cold chains legitimately sit still for sweeps)
    betas = jnp.asarray(betas_depolarizing(0.5), jnp.float32)

    def local(states_shard, keys_shard):
        return kern(states_shard, keys_shard[0], betas)

    fn = jax.jit(
        shard_map(
            local, mesh=mesh,
            in_specs=(P("data"), P("data")),
            out_specs=P("data"), check_vma=False,
        )
    )
    keys = jax.random.split(jax.random.PRNGKey(17), 8)
    out = np.asarray(fn(shard_batch(states, mesh), shard_batch(keys, mesh)))
    assert out.shape == states.shape
    # every Metropolis move is a stabilizer application: syndromes invariant
    syn0 = np.stack([np_syndrome(spec, s) for s in states])
    syn1 = np.stack([np_syndrome(spec, s) for s in out])
    assert np.array_equal(syn0, syn1)
    assert (out != states).any(axis=-1).mean() > 0.9


def test_sharded_fused_ladder_under_shard_map():
    """A PT ladder step with the sweep kernel (interpret mode on the CPU)
    executing under the mesh with the batch sharded over ``data``: sweeps,
    logical mixing, replica exchange and class readout per shard."""
    from mcmc_qec_tpu.models import np_syndrome
    from mcmc_qec_tpu.mcmc.ladder import (
        LadderState,
        beta_ladder_depolarizing,
        init_ladder,
        make_ladder_step,
    )

    spec = get_spec("toric", 3)
    mesh = make_mesh()
    Nc, B = 3, 16  # 2 syndromes per device
    states = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(5), spec, 0.1, (B,))
    )
    step = make_ladder_step(spec, Nc, iters=2, p_logical=0.5,
                            engine="kernel", interpret=True)
    ls = init_ladder(spec, jnp.asarray(states), Nc)
    ls = LadderState(*(shard_batch(x, mesh) for x in ls))
    betas = jnp.asarray(beta_ladder_depolarizing(0.1, Nc), jnp.float32)
    ls, bottom_eq, n_xyz0, swap = jax.jit(step)(ls, jax.random.PRNGKey(1),
                                                betas)
    st = np.asarray(ls.state)
    assert st.shape == (B, Nc, spec.nq) and bottom_eq.shape == (B,)
    assert swap.shape == (B, Nc - 1)
    # stabilizer + logical moves preserve the syndrome on every rung
    syn0 = np.stack([np_syndrome(spec, s) for s in states])
    for r in range(Nc):
        synr = np.stack([np_syndrome(spec, st[b, r]) for b in range(B)])
        assert np.array_equal(synr, syn0), f"rung {r}"
    # exactly one top flag per ladder after the exchange sweep bookkeeping
    assert (np.asarray(ls.flag)[:, -1] == 1).all()


def test_multihost_degenerate_single_process(tmp_path):
    """Single-process path: shard covers everything, gathers are
    identities, distributed_generate == generate."""
    from mcmc_qec_tpu.parallel import (
        allgather_rows,
        distributed_generate,
        global_sum,
        host_shard,
    )
    from mcmc_qec_tpu.pipeline import RunConfig, evaluate_dataset

    assert host_shard(10) == slice(0, 10)
    assert np.array_equal(allgather_rows(np.arange(6).reshape(2, 3)),
                          np.arange(6).reshape(2, 3))
    assert global_sum(np.array([2, 3])).tolist() == [2, 3]
    cfg = RunConfig(code="planar", method="STDC", size=3, p_error=0.08,
                    p_sampling=0.25, droplets=2, steps=500, batch=4)
    ds = distributed_generate(str(tmp_path / "mh.npz"), cfg, 4, progress=None)
    assert len(ds) == 4
    assert (tmp_path / "mh.npz").exists()
    evaluate_dataset(ds)
