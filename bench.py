"""Benchmark: Metropolis sweep and decoder throughput on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"extra"}.

Primary metric: effective stabilizer-proposal throughput of the best sweep
engine at toric d=5 (1 sweep = n_stabs = 2d^2 proposals, the accounting of
BASELINE.md).  vs_baseline is against the reference's measured
interpreted-Python floor of 178k proposals/s (BASELINE.md, src/mcmc.py:152
path, single CPU core).

Every timing ends in ``jax.block_until_ready``; every recorded key is the
best of its timed repetitions.  The run fails when JAX finds no GPU, and
any key that fails fails the run.  The record stamps the device as JAX
reports it and the card's name and power limit as nvidia-smi reports them.
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


BASELINE_PROPOSALS_PER_S = 178_000.0  # BASELINE.md measured reference floor


def device_stamp() -> dict:
    """The device as JAX reports it plus nvidia-smi's name and power limit;
    raises when JAX's default device is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def bench_dense(family="toric", d=5, batch=32768, sweeps_per_call=200, calls=3):
    from mcmc_qec_tpu.models import get_spec
    from mcmc_qec_tpu.mcmc.ladder import betas_depolarizing
    from mcmc_qec_tpu.ops.dense_sweep import make_dense_sweep

    spec = get_spec(family, d)
    sweep = make_dense_sweep(spec)
    betas = jnp.asarray(betas_depolarizing(0.1), jnp.float32)

    @jax.jit
    def run(states, key):
        def body(s, k):
            return sweep(s, k, betas), None

        ks = jax.random.split(key, sweeps_per_call)
        states, _ = jax.lax.scan(body, states, ks)
        return states

    key = jax.random.PRNGKey(0)
    states = jax.block_until_ready(
        run(jnp.zeros((batch, spec.nq), jnp.uint8), key))
    best = 0.0
    for i in range(calls):
        t0 = time.perf_counter()
        states = jax.block_until_ready(run(states, jax.random.fold_in(key, i)))
        dt = time.perf_counter() - t0
        best = max(best, batch * spec.n_stabs * sweeps_per_call / dt)
    return best


def bench_kernel(family="toric", d=5, batch=32768, sweeps_per_call=200,
                 calls=3):
    """The Pallas sweep kernel (ops/sweep_kernel.py) at the shape of
    ``bench_dense``: one kernel call runs all ``sweeps_per_call`` sweeps."""
    from mcmc_qec_tpu.models import get_spec
    from mcmc_qec_tpu.mcmc.ladder import betas_depolarizing
    from mcmc_qec_tpu.ops.sweep_kernel import make_kernel_sweep

    spec = get_spec(family, d)
    run = jax.jit(make_kernel_sweep(spec, sweeps_per_call))
    betas = jnp.asarray(betas_depolarizing(0.1), jnp.float32)
    key = jax.random.PRNGKey(0)
    states = jax.block_until_ready(
        run(jnp.zeros((batch, spec.nq), jnp.uint8), key, betas))
    best = 0.0
    for i in range(calls):
        t0 = time.perf_counter()
        states = jax.block_until_ready(
            run(states, jax.random.fold_in(key, i), betas))
        dt = time.perf_counter() - t0
        best = max(best, batch * spec.n_stabs * sweeps_per_call / dt)
    return best


def bench_stdc_decoder(d=5, B=1024, steps=450, droplets=4):
    """Decoder-level throughput: full STDC (sweep engine) on a syndrome
    batch — sampling + on-device dedup + Z reduction."""
    from mcmc_qec_tpu.models import get_spec
    from mcmc_qec_tpu.models.noise import sample_depolarizing
    from mcmc_qec_tpu.decoders import STDC

    spec = get_spec("toric", d)
    states = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(0), spec, 0.1, (B,))
    )
    STDC(spec, states, 0.1, 0.25, droplets=droplets, steps=steps,
         engine="sweep")  # compile
    best = 0.0
    syn_rate = 0.0
    for rep in range(3):
        t0 = time.perf_counter()
        STDC(spec, states, 0.1, 0.25, droplets=droplets, steps=steps,
             engine="sweep", seed=rep + 1)
        dt = time.perf_counter() - t0
        props = B * spec.n_classes * droplets * steps * spec.n_stabs
        best = max(best, props / dt)
        syn_rate = max(syn_rate, B / dt)
    return best, syn_rate


def bench_stdc_stream(d=9, B=512, steps=20000, droplets=10):
    """STDC at the reference's own default budget (droplets=10 x
    steps=20000, /root/reference/decoders.py:268) via the bounded-memory
    streaming reduction — the materialized path would need ~33 GB HBM at
    this shape (decoders/streaming.py)."""
    from mcmc_qec_tpu.models import get_spec
    from mcmc_qec_tpu.models.noise import sample_depolarizing
    from mcmc_qec_tpu.decoders import STDC

    spec = get_spec("toric", d)
    states = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(0), spec, 0.1, (B,))
    )
    STDC(spec, states, 0.1, 0.25, droplets=droplets, steps=steps, seed=1)
    best = 0.0
    for rep in range(1):  # one timed run after the compiling one
        t0 = time.perf_counter()
        STDC(spec, states, 0.1, 0.25, droplets=droplets, steps=steps,
             seed=rep + 2)
        best = max(best, B / (time.perf_counter() - t0))
    return best


def bench_strc_stream(d=9, B=256, steps=20000, droplets=10):
    """STRC at the reference's own default budget (droplets=10 x
    steps=20000, decoders.py:835) through the bounded-memory streaming
    occupancy path (VERDICT r4 task 5)."""
    import warnings

    from mcmc_qec_tpu.models import get_spec
    from mcmc_qec_tpu.models.noise import sample_depolarizing
    from mcmc_qec_tpu.decoders import STRC

    spec = get_spec("toric", d)
    states = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(0), spec, 0.1, (B,))
    )
    truncated = False
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        STRC(spec, states, 0.1, 0.3, droplets=droplets, steps=steps, seed=1)
        truncated = any("truncated" in str(x.message) for x in w)
    best = 0.0
    for rep in range(1):  # one timed run after the compiling one
        t0 = time.perf_counter()
        STRC(spec, states, 0.1, 0.3, droplets=droplets, steps=steps,
             seed=rep + 2)
        best = max(best, B / (time.perf_counter() - t0))
    return best, truncated


def bench_ptrc_stream(d=9, B=256, steps=20000, droplets=4):
    """PTRC at the reference defaults (droplets=4, steps=20000, Nc=d,
    decoders.py:638) through the per-rung streaming occupancy path."""
    import warnings

    from mcmc_qec_tpu.models import get_spec
    from mcmc_qec_tpu.models.noise import sample_depolarizing
    from mcmc_qec_tpu.decoders import PTRC

    spec = get_spec("toric", d)
    states = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(0), spec, 0.1, (B,))
    )
    truncated = False
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        PTRC(spec, states, 0.1, droplets=droplets, steps=steps, stream=True,
             seed=1)
        truncated = any("truncated" in str(x.message) for x in w)
    best = 0.0
    for rep in range(1):  # one timed run after the compiling one
        t0 = time.perf_counter()
        PTRC(spec, states, 0.1, droplets=droplets, steps=steps, stream=True,
             seed=rep + 2)
        best = max(best, B / (time.perf_counter() - t0))
    return best, truncated


def bench_pteq(B=2048, max_steps=8000, d=5, p=0.15):
    """PTEQ decoder throughput (d=5: hard syndromes from the golden corpus
    when readable, synthetic p errors otherwise): full parallel-tempering
    decode — ladder sweeps, replica exchange, burn-in, windowed
    convergence, compaction, batched fetches — per wall second.  B=2048 is
    the d=5 production shape (the decoder is batched by design; most of
    the 2603-syndrome corpus decodes in one device batch)."""
    import os
    from mcmc_qec_tpu.models import get_spec
    from mcmc_qec_tpu.decoders.pteq import PTEQ, PTEQConfig

    spec = get_spec("toric", d)
    golden = "/root/reference/data/drl_failures_p_0.15.xz"
    if d == 5 and os.path.exists(golden):
        from mcmc_qec_tpu.pipeline.evaluate import load_golden_corpus

        _, flat, _ = load_golden_corpus(golden)
        states = np.concatenate([flat] * (B // len(flat) + 1))[:B] \
            if B > len(flat) else flat[:B]
    else:
        from mcmc_qec_tpu.models.noise import sample_depolarizing

        states = np.asarray(
            sample_depolarizing(jax.random.PRNGKey(0), spec, p, (B,))
        )
    cfg = PTEQConfig(max_steps=3 * max_steps, window=600, iters=2,
                     energy_chunk=12)
    PTEQ(spec, states, p, cfg)  # compile
    # the per-rep rates go into the record: the host loop syncs every
    # window, so the spread shows how much the host moved the number
    rates = []
    for rep in range(3):
        t0 = time.perf_counter()
        PTEQ(spec, states, p, cfg, seed=rep % 3 + 1)
        rates.append(round(B / (time.perf_counter() - t0), 1))
    return max(rates), rates


def main():
    device = device_stamp()
    print(device["nvidia_smi"], file=sys.stderr)
    extra = {}
    dense = bench_dense()
    extra["dense_xla_d5"] = round(dense, 1)
    kernel = bench_kernel()
    extra["kernel_d5"] = round(kernel, 1)
    value = max(dense, kernel)
    stdc_pps, stdc_syn = bench_stdc_decoder()
    extra["stdc_decoder_proposals_per_sec_d5"] = round(stdc_pps, 1)
    extra["stdc_decoder_syndromes_per_sec_d5"] = round(stdc_syn, 1)
    pteq_best, pteq_rates = bench_pteq()
    extra["pteq_hard_syndromes_per_sec_d5"] = round(pteq_best, 1)
    extra["pteq_hard_d5_rep_rates"] = pteq_rates
    # production-size end-to-end PTEQ (the reference grid reaches d=19)
    extra["pteq_syndromes_per_sec_d9"] = round(
        bench_pteq(B=512, d=9, p=0.10)[0], 1)
    # STDC / STRC / PTRC at the reference's default budgets through the
    # bounded-memory streaming reduction; the *_truncated flags report
    # whether the bounded N(n) buffers clipped at the lengths the Z
    # estimate reads (they warn in-API too)
    extra["stdc_stream_ref_budget_syn_per_sec_d9"] = round(
        bench_stdc_stream(), 1)
    strc_rate, strc_trunc = bench_strc_stream()
    extra["strc_stream_ref_budget_syn_per_sec_d9"] = round(strc_rate, 1)
    extra["strc_stream_truncated"] = strc_trunc
    ptrc_rate, ptrc_trunc = bench_ptrc_stream()
    extra["ptrc_stream_ref_budget_syn_per_sec_d9"] = round(ptrc_rate, 1)
    extra["ptrc_stream_truncated"] = ptrc_trunc
    # production-size PTEQ with the d-scaled step cap (96k = 3 * 32000)
    extra["pteq_syndromes_per_sec_d13"] = round(
        bench_pteq(B=256, d=13, p=0.10, max_steps=32000)[0], 1)
    result = {
        "metric": "metropolis_proposals_per_sec_toric_d5",
        "value": round(value, 1),
        "unit": "proposals/s",
        "vs_baseline": round(value / BASELINE_PROPOSALS_PER_S, 2),
        "device": device,
        "extra": extra,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
