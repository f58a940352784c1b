"""Smoke test of the decoder pipeline on NVIDIA GPUs.

    python chip_smoke.py           # one card: the five phases below
    python chip_smoke.py --multi   # four cards: generate --distributed only

One card, all phases in this one process (a second JAX process on the card
would fail for want of the memory this one reserves):

1. Kernel check: the compiled sweep kernel against the XLA sweep
   (``make_dense_sweep``) with shared uniforms at real widths, then its own
   generator (syndromes invariant, exact class posterior at d=3).
2. Counting path: ``generate`` STDC at toric d=9 with the reference's
   default budget (10 droplets x 20,000 steps, 512 syndromes), then
   ``evaluate``; compared with the XLA sweep engine on the same syndromes.
3. PT path: ``generate`` PTEQ at toric d=5, p=0.15, 2048 syndromes with a
   step cap; converged share and failure rate, for both engines.
4. Exact anchor at d=3 (``decoders/exact.py``) for STDC and PTEQ.
5. Timing: syndromes per second of phases 2 and 3 for both engines
   (information only; wall clock, compilation included).

``--multi`` launches four ranks of ``python -m mcmc_qec_tpu generate
--distributed``, each pinned to its own card, and compares the gathered
dataset with four one-card runs at the ranks' seeds.

Exits non-zero, printing no result, when JAX's default device is not a GPU
or any check fails.  The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")

# phase 1 widths: every family at a width users decode, 32,768 chains each
KERNEL_CHECKS = [("toric", 5), ("toric", 9), ("toric", 13), ("planar", 9),
                 ("rotated", 9), ("xzzx", 9)]
KERNEL_CHAINS = 32768
# the compiled kernel may move logr's last bit with a fused multiply-add;
# a chain may then disagree only where a uniform sits this close to logr
TIE_TOL = 1e-5
# phase 2: STDC at the reference's default counting budget
STDC_N = 512
STDC_ARGS = ["--code", "toric", "--method", "STDC", "--size", "9",
             "--p-error", "0.10", "--droplets", "10", "--steps", "20000"]
# --multi: PTEQ per rank, one rank per card
MULTI_N = 256
MULTI_ARGS = ["--method", "PTEQ", "--code", "toric", "--size", "5",
              "--p-error", "0.15", "--max-steps", "4000"]
# phase 3: PTEQ at the d=5 production batch, with a step cap
PTEQ_N = 2048
PTEQ_ARGS = ["--method", "PTEQ", "--code", "toric", "--size", "5",
             "--p-error", "0.15", "--max-steps", "20000"]


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def result_line(count: int) -> str:
    import jax

    dev = jax.devices()[0]
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}})


def tv(a, b) -> float:
    import numpy as np

    return float(0.5 * np.abs(np.asarray(a, float) - np.asarray(b, float)).sum())


# --- phase 1 -----------------------------------------------------------------


def dense_with_margins(spec, states, logu, betas):
    """The XLA sweep's chains after ``len(logu)`` sweeps, and per chain the
    smallest |logu - logr| over its real proposals along that trajectory
    (the same arithmetic as ``make_dense_sweep``)."""
    import jax
    import jax.numpy as jnp

    from mcmc_qec_tpu.ops.dense_sweep import _color_tables

    tables = _color_tables(spec)

    @jax.jit
    def run(state, logu, betas):
        b0 = (state & 1) ^ ((state >> 1) & 1)
        b1 = (state >> 1) & 1
        margin = jnp.full(state.shape[:-1], jnp.inf, jnp.float32)
        for s in range(logu.shape[0]):
            for c, (sel, xop, zop) in enumerate(tables):
                sel = jnp.asarray(sel, jnp.bfloat16)
                nb0, nb1 = b0 ^ xop, b1 ^ zop
                d1 = (nb0 & (1 - nb1)).astype(jnp.int8) - (b0 & (1 - b1)).astype(jnp.int8)
                d2 = (nb0 & nb1).astype(jnp.int8) - (b0 & b1).astype(jnp.int8)
                d3 = ((1 - nb0) & nb1).astype(jnp.int8) - ((1 - b0) & b1).astype(jnp.int8)
                dn = [jax.lax.dot_general(
                    d.astype(jnp.bfloat16), sel.T, (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32)
                    for d in (d1, d2, d3)]
                logr = -(betas[0] * dn[0] + betas[1] * dn[1] + betas[2] * dn[2])
                lu = logu[s, c][:, : sel.shape[0]]
                margin = jnp.minimum(margin, jnp.min(jnp.abs(lu - logr), -1))
                accept = (lu < logr).astype(jnp.bfloat16)
                acc_q = jax.lax.dot_general(
                    accept, sel, (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32).astype(jnp.uint8)
                b0 = b0 ^ (xop * acc_q)
                b1 = b1 ^ (zop * acc_q)
        return ((b0 * 1) ^ (b1 * 3)).astype(jnp.uint8), margin

    return run(states, logu, betas)


def phase_kernel():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcmc_qec_tpu.decoders import STDC
    from mcmc_qec_tpu.decoders.exact import exact_mld
    from mcmc_qec_tpu.models import get_spec
    from mcmc_qec_tpu.models.noise import sample_depolarizing
    from mcmc_qec_tpu.mcmc.ladder import betas_depolarizing, betas_xyz
    from mcmc_qec_tpu.ops.dense_sweep import make_dense_sweep, sweep_logu
    from mcmc_qec_tpu.ops.pauli import syndrome
    from mcmc_qec_tpu.ops.sweep_kernel import make_kernel_sweep

    # dot operands are integers |x| <= 81 in bf16 with f32 accumulation:
    # exact, so no matmul precision setting can change them
    print("[phase 1] kernel dots: bf16 operands, f32 accumulation (exact)")
    betas = jnp.asarray(betas_xyz(0.05, 0.02, 0.09), jnp.float32)
    for family, d in KERNEL_CHECKS:
        spec = get_spec(family, d)
        states = sample_depolarizing(jax.random.PRNGKey(d), spec, 0.3,
                                     (KERNEL_CHAINS,))
        for n_sweeps in (1, 5):
            keys = jax.random.split(jax.random.PRNGKey(100 + d), n_sweeps)
            logu = jnp.stack([sweep_logu(spec, k, (KERNEL_CHAINS,))
                              for k in keys])
            dense = jax.jit(make_dense_sweep(spec))
            ref = states
            for k in keys:
                ref = dense(ref, k, betas)
            # the replay may itself differ from ``ref`` only at ties
            replay, margin = dense_with_margins(spec, states, logu, betas)
            kern = jax.jit(make_kernel_sweep(spec, n_sweeps))
            out = kern(states, jax.random.PRNGKey(0), betas, logu=logu)
            diff = np.asarray(jnp.any(out != ref, axis=-1))
            diff_replay = np.asarray(jnp.any(replay != ref, axis=-1))
            ties = np.asarray(margin) <= TIE_TOL
            n_diff = int(diff.sum())
            n_bad = int(((diff | diff_replay) & ~ties).sum())
            print(f"[phase 1] {family} d={d} sweeps={n_sweeps} "
                  f"chains={KERNEL_CHAINS}: {n_diff} chains differ, all "
                  f"within |logu-logr|<={TIE_TOL}: {n_bad == 0}", flush=True)
            assert n_bad == 0, (family, d, n_sweeps, n_diff, n_bad)
        # the kernel's own generator: every move is a stabilizer move
        out = jax.jit(make_kernel_sweep(spec, 5))(
            states, jax.random.PRNGKey(1), betas)
        syn = jax.jit(lambda s: syndrome(spec, s))
        assert bool(jnp.all(syn(out) == syn(states))), (family, d)
        moved = float(jnp.mean(jnp.any(out != states, axis=-1)))
        assert moved > 0.5, moved
        print(f"[phase 1] {family} d={d} generator: syndromes invariant, "
              f"{moved:.3f} of chains moved", flush=True)
    spec = get_spec("planar", 3)
    s0 = np.asarray(sample_depolarizing(jax.random.PRNGKey(5), spec, 0.1,
                                        (1,)))
    exact = exact_mld(spec, s0, betas_depolarizing(0.1))[0]
    distr = STDC(spec, s0, 0.1, p_sampling=0.25, droplets=4, steps=1500,
                 engine="kernel")[0] / 100.0
    t = tv(exact, distr)
    print(f"[phase 1] STDC kernel planar d=3 vs exact: TV={t:.4f}", flush=True)
    assert t < 0.03, (exact, distr)


# --- phases 2, 3, 5 ------------------------------------------------------------


def generate(name, args):
    """``generate`` then ``evaluate`` through the CLI; (dataset, wall s)."""
    from mcmc_qec_tpu import cli
    from mcmc_qec_tpu.pipeline import Dataset

    path = os.path.join(OUT, f"{name}.npz")
    t0 = time.perf_counter()
    assert cli.main(["generate", *args, "--out", path]) == 0
    wall = time.perf_counter() - t0
    assert cli.main(["evaluate", path]) == 0
    return Dataset.load(path), wall


def failure_rate(ds):
    from mcmc_qec_tpu.pipeline import evaluate_dataset

    res = evaluate_dataset(ds)
    return res.n_failures / res.n_points


def rates_agree(f1, f2, n):
    sigma = ((f1 * (1 - f1) + f2 * (1 - f2)) / n) ** 0.5
    return abs(f1 - f2) <= 3 * max(sigma, 1.0 / n)


def phase_counting(timings):
    import numpy as np

    n = STDC_N
    args = STDC_ARGS + ["-n", str(n), "--batch", str(n)]
    ds_k, wall_k = generate("stdc_default", args)
    ds_s, wall_s = generate("stdc_sweep", args + ["--engine", "sweep"])
    timings["STDC toric d=9 ref budget"] = (n / wall_k, n / wall_s)
    assert np.array_equal(ds_k.qubit_matrices, ds_s.qubit_matrices)
    for ds in (ds_k, ds_s):
        assert ds.distributions.shape == (n, 16)
        assert np.all(np.isfinite(ds.distributions))
    tvs = 0.5 * np.abs(ds_k.distributions - ds_s.distributions).sum(-1) / 100
    f_k, f_s = failure_rate(ds_k), failure_rate(ds_s)
    print(f"[phase 2] STDC d=9: mean TV(kernel, sweep)={tvs.mean():.4f}, "
          f"failure rate kernel={f_k:.4f} sweep={f_s:.4f}", flush=True)
    assert tvs.mean() <= 0.05, tvs.mean()
    assert rates_agree(f_k, f_s, n), (f_k, f_s)


def phase_pt(timings):
    import numpy as np

    n = PTEQ_N
    args = PTEQ_ARGS + ["-n", str(n), "--batch", str(n)]
    out = {}
    for engine in ("auto", "sweep"):
        metrics = os.path.join(OUT, f"pteq_{engine}.jsonl")
        if os.path.exists(metrics):
            os.remove(metrics)
        ds, wall = generate(f"pteq_{engine}", args + [
            "--engine", engine, "--metrics-path", metrics])
        with open(metrics) as f:
            done = [json.loads(line) for line in f
                    if '"pteq_done"' in line][-1]
        conv = done["converged"] / done["batch"]
        fr = failure_rate(ds)
        assert ds.distributions.shape == (n, 16)
        assert np.all(np.isfinite(ds.distributions))
        print(f"[phase 3] PTEQ d=5 engine={engine}: converged share "
              f"{conv:.4f}, failure rate {fr:.4f}, steps {done['steps_done']}",
              flush=True)
        out[engine] = (ds, wall, conv, fr)
    timings["PTEQ toric d=5 B=2048"] = (n / out["auto"][1], n / out["sweep"][1])
    assert rates_agree(out["auto"][3], out["sweep"][3], n)


def phase_exact():
    import jax
    import numpy as np

    from mcmc_qec_tpu.decoders import PTEQ, PTEQConfig, STDC
    from mcmc_qec_tpu.decoders.exact import exact_mld
    from mcmc_qec_tpu.models import get_spec
    from mcmc_qec_tpu.models.noise import sample_depolarizing
    from mcmc_qec_tpu.mcmc.ladder import betas_depolarizing

    def syndrome_state(family):
        spec = get_spec(family, 3)
        return spec, np.asarray(
            sample_depolarizing(jax.random.PRNGKey(5), spec, 0.1, (1,)))[0]

    spec, s0 = syndrome_state("planar")
    exact = exact_mld(spec, s0, betas_depolarizing(0.1))[0]
    distr = STDC(spec, s0[None], 0.1, p_sampling=0.25, droplets=4,
                 steps=1500)[0] / 100.0
    t = tv(exact, distr)
    print(f"[phase 4] STDC planar d=3 vs exact: TV={t:.4f}", flush=True)
    assert t < 0.03, (exact, distr)
    spec, s0 = syndrome_state("toric")
    exact = exact_mld(spec, s0, betas_depolarizing(0.1))[0]
    res = PTEQ(spec, np.tile(s0[None], (8, 1)), 0.1,
               PTEQConfig(max_steps=8000, window=200, TOPS=30, SEQ=4,
                          iters=2), seed=3)
    mean = res.distribution.mean(axis=0) / 100.0
    t = tv(exact, mean)
    print(f"[phase 4] PTEQ toric d=3 mean vs exact: TV={t:.4f}", flush=True)
    assert t < 0.2, (exact, mean)
    assert np.argmax(mean) in np.argsort(exact)[-2:]


def run_one_card() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    print(nvidia_smi(), flush=True)
    import mcmc_qec_tpu  # noqa: F401  (fails outside a checkout)

    os.makedirs(OUT, exist_ok=True)
    timings = {}
    phase_kernel()
    phase_counting(timings)
    phase_pt(timings)
    phase_exact()
    for name, (k, s) in timings.items():
        print(f"[phase 5] {name}: kernel {k:.1f} syn/s, sweep {s:.1f} syn/s "
              "(wall clock, compilation included)", flush=True)
    print(nvidia_smi())
    print(result_line(1))
    return 0


# --- four cards ----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_all(cmds, timeout):
    """Start one process per card, wait for all; kill the rest on failure."""
    procs = []
    try:
        for card, cmd in enumerate(cmds):
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(card),
                       PYTHONPATH=REPO)
            procs.append(subprocess.Popen(cmd, cwd=REPO, env=env))
        for p in procs:
            assert p.wait(timeout=timeout) == 0, p.args
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_multi(n_cards: int = 4) -> int:
    import numpy as np

    smi = nvidia_smi().splitlines()
    print("\n".join(smi), flush=True)
    if len(smi) < n_cards:
        print(f"chip_smoke --multi: needs {n_cards} GPUs, found {len(smi)}",
              file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    n_rank, seed = MULTI_N, 7
    base = [sys.executable, "-m", "mcmc_qec_tpu", "generate", *MULTI_ARGS,
            "--batch", str(n_rank)]
    dist = os.path.join(OUT, "multi_dist.npz")
    port = _free_port()
    t0 = time.perf_counter()
    _run_all([base + ["-n", str(n_cards * n_rank), "--seed", str(seed),
                      "--out", dist, "--distributed",
                      "--coordinator", f"localhost:{port}",
                      "--num-processes", str(n_cards),
                      "--process-id", str(r)] for r in range(n_cards)], 900)
    wall_dist = time.perf_counter() - t0
    singles = [os.path.join(OUT, f"multi_single{r}.npz")
               for r in range(n_cards)]
    t0 = time.perf_counter()
    _run_all([base + ["-n", str(n_rank), "--seed", str(seed + r),
                      "--out", singles[r]] for r in range(n_cards)], 900)
    wall_single = time.perf_counter() - t0
    with np.load(dist) as z:
        got = {k: z[k] for k in ("qubit_matrices", "distributions",
                                 "true_classes")}
    for r, path in enumerate(singles):
        rows = slice(r * n_rank, (r + 1) * n_rank)
        with np.load(path) as z:
            assert np.array_equal(z["qubit_matrices"],
                                  got["qubit_matrices"][rows]), r
            assert np.array_equal(z["true_classes"],
                                  got["true_classes"][rows]), r
            gap = float(np.abs(z["distributions"]
                               - got["distributions"][rows]).max())
        print(f"[multi] rank {r}: syndromes and true classes identical, "
              f"max distribution gap {gap:.2f} pp", flush=True)
        assert gap <= 1.0, (r, gap)
    print(f"[multi] {n_cards} ranks x {n_rank} PTEQ d=5 syndromes: "
          f"distributed {wall_dist:.1f} s, four one-card runs "
          f"{wall_single:.1f} s (wall, compilation included)", flush=True)
    # the ranks have exited, so this process may now open the cards
    import jax

    assert jax.devices()[0].platform == "gpu"
    assert len(jax.devices()) == n_cards
    print(result_line(n_cards))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run generate --distributed on four cards, one "
                         "process per card, and nothing else")
    args = ap.parse_args(argv)
    return run_multi() if args.multi else run_one_card()


if __name__ == "__main__":
    sys.exit(main())
