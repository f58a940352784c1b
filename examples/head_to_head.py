"""Head-to-head: this framework vs the EXECUTING reference implementation.

Runs the reference's own ``PTEQ`` and ``STDC`` (/root/reference/decoders.py:
25, 268) — interpreted, with numba stubbed out exactly as in the SURVEY
baseline measurements — on a fixed set of d=5 toric syndromes, and compares
their per-class distributions and argmax decisions against this framework's
decoders (production engines and, optionally, the literal parity engine).

Because the reference uses unseeded global RNG (SURVEY §2.4), agreement is
measured at the distribution level: per-syndrome total variation between
estimators, calibrated against the reference's own run-to-run TV (two
independent reference runs on the same syndromes).

Run:  python examples/head_to_head.py -n 12 --out /tmp/h2h.json

Phases (round 5, n=64 runs): ``--phase ref`` runs only the interpreted
reference side (hours of pure CPU; pair with JAX_PLATFORMS=cpu so the GPU
stays free) and dumps its distributions to --ref-cache; ``--phase ours``
loads that cache, runs our decoders on the GPU, and writes the final
comparison.  ``--phase all`` (default) does both in one process.
"""

import argparse
import json
import os
import sys
import time
import types

sys.path.insert(0, ".")
os.environ.setdefault("MPLBACKEND", "Agg")

import numpy as np


def _stub_numba():
    """Install a no-op numba so the reference's @njit functions run
    interpreted (numba is unavailable in this container; same setup as the
    SURVEY §6 baseline measurements)."""
    numba = types.ModuleType("numba")

    def njit(*args, **kwargs):
        if len(args) == 1 and callable(args[0]) and not kwargs:
            return args[0]
        return lambda f: f

    numba.njit = njit
    numba.jit = njit
    sys.modules["numba"] = numba


def load_reference():
    _stub_numba()
    sys.path.insert(0, "/root/reference")
    import decoders as ref_decoders  # noqa: E402
    from src.toric_model import Toric_code  # noqa: E402

    return ref_decoders, Toric_code


def make_ref_code(Toric_code, flat_state, d=5):
    """Wrap one of our flat uint8 states as a reference Toric_code (the
    flat layout IS qubit_matrix.reshape(-1), models/toric.py)."""
    code = Toric_code(d)
    code.qubit_matrix = np.asarray(flat_state, np.uint8).reshape(2, d, d).copy()
    code.syndrom()
    return code


def tv(a, b):
    return 0.5 * float(np.abs(np.asarray(a, float) - np.asarray(b, float)).sum())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=12, help="syndromes per source")
    ap.add_argument("--d", type=int, default=5)
    ap.add_argument("--p", type=float, default=0.15)
    ap.add_argument("--stdc-steps", type=int, default=10000)
    ap.add_argument("--stdc-droplets", type=int, default=2)
    ap.add_argument("--skip-literal", action="store_true")
    ap.add_argument("--strc-steps", type=int, default=10000,
                    help="also compare STRC (0 disables)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--phase", choices=["all", "ref", "ours"], default="all")
    ap.add_argument("--ref-cache", default="/tmp/h2h_ref_cache.npz")
    args = ap.parse_args()

    if args.phase == "ref":
        # interpreted-reference phase is pure CPU — leave the GPU free for
        # concurrent science runs (state sampling/warm starts don't need it)
        import jax

        jax.config.update("jax_platforms", "cpu")

    from mcmc_qec_tpu.models import get_spec, np_eq_class
    from mcmc_qec_tpu.models.noise import sample_depolarizing
    from mcmc_qec_tpu.decoders import STDC, PTEQ
    from mcmc_qec_tpu.decoders.pteq import PTEQConfig
    import jax

    spec = get_spec("toric", args.d)
    # a quarter golden hard syndromes (multimodal posteriors — these bound
    # the reference's own run-to-run reproducibility), the rest typical
    # p=0.10 samples where converged estimators must agree tightly
    states = []
    golden = "/root/reference/data/drl_failures_p_0.15.xz"
    n_half = args.n // 4
    if os.path.exists(golden) and args.d == 5:
        from mcmc_qec_tpu.pipeline.evaluate import load_golden_corpus

        _, flat, _ = load_golden_corpus(golden)
        states.append(flat[:n_half])
    states.append(
        np.asarray(
            sample_depolarizing(
                jax.random.PRNGKey(42), spec, 0.10, (args.n - sum(len(s) for s in states),)
            )
        )
    )
    states = np.concatenate(states)
    n = len(states)
    truth = np_eq_class(spec, states)

    ref_decoders = Toric_code = None
    if args.phase != "ours":
        ref_decoders, Toric_code = load_reference()

    def run_ref_pteq(tag):
        out = np.zeros((n, spec.n_classes))
        t0 = time.perf_counter()
        for i, s in enumerate(states):
            code = make_ref_code(Toric_code, s, args.d)
            out[i] = np.asarray(
                ref_decoders.PTEQ(code, args.p), float
            )
            print(f"  ref PTEQ {tag} {i + 1}/{n} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
        return out

    # MWPM warm starts from OUR native blossom, shared by BOTH frameworks:
    # without them the reference's interpreted STDC never mixes from the
    # rained start (measured chance-level 1/16 accuracy — the reference's
    # production runs rely on mwpm_init, generate_data.py:126-129, whose
    # blossom5 binary lives on their cluster).  Toric class seeds =
    # the MWPM correction moved to each class (all_class_states).
    from mcmc_qec_tpu.matching import mwpm_correction
    from mcmc_qec_tpu.ops.pauli import all_class_states
    import jax.numpy as jnp

    warm = np.stack([
        np.asarray(
            all_class_states(spec, jnp.asarray(
                np.asarray(mwpm_correction(spec, s), np.uint8).reshape(-1)
            ))
        )
        for s in states
    ])  # (n, K, nq)

    def run_ref_counting(fn_name, steps, droplets):
        fn = getattr(ref_decoders, fn_name)
        out = np.zeros((n, spec.n_classes))
        t0 = time.perf_counter()
        for i in range(n):
            init_list = [
                make_ref_code(Toric_code, warm[i, eq], args.d)
                for eq in range(spec.n_classes)
            ]
            out[i] = np.asarray(
                fn(init_list, args.p, p_sampling=0.25,
                   droplets=droplets, steps=steps),
                float,
            )
            print(f"  ref {fn_name} {i + 1}/{n} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
        return out

    if args.phase == "ours":
        cache = np.load(args.ref_cache)
        assert np.array_equal(cache["states"], states), \
            "ref cache was collected on different syndromes"
        assert np.array_equal(cache["warm"], warm), \
            "ref cache was collected with different warm starts"
        if "budgets" in cache:  # caches from before round-5 lack the field
            budgets = tuple(int(x) for x in cache["budgets"])
            assert budgets == (args.stdc_steps, args.stdc_droplets,
                               args.strc_steps), (
                f"ref cache budgets {budgets} != this run's "
                f"({args.stdc_steps}, {args.stdc_droplets}, "
                f"{args.strc_steps})"
            )
        ref_pteq_a = cache["ref_pteq_a"]
        ref_pteq_b = cache["ref_pteq_b"]
        ref_stdc = cache["ref_stdc"]
        ref_strc = cache["ref_strc"] if "ref_strc" in cache else None
    else:
        print(f"reference PTEQ run A ({n} syndromes)...", flush=True)
        ref_pteq_a = run_ref_pteq("A")
        print("reference PTEQ run B (self-TV calibration)...", flush=True)
        ref_pteq_b = run_ref_pteq("B")
        print("reference STDC...", flush=True)
        ref_stdc = run_ref_counting("STDC", args.stdc_steps,
                                    args.stdc_droplets)
        ref_strc = None
        if args.strc_steps:
            print("reference STRC...", flush=True)
            ref_strc = run_ref_counting("STRC", args.strc_steps,
                                        args.stdc_droplets)
        np.savez_compressed(
            args.ref_cache, states=states, warm=warm,
            ref_pteq_a=ref_pteq_a, ref_pteq_b=ref_pteq_b,
            ref_stdc=ref_stdc,
            budgets=np.array([args.stdc_steps, args.stdc_droplets,
                              args.strc_steps]),
            **({"ref_strc": ref_strc} if ref_strc is not None else {}),
        )
        if args.phase == "ref":
            print(f"ref phase done -> {args.ref_cache}", flush=True)
            return

    print("this framework: PTEQ (default engine)...", flush=True)
    cfg = PTEQConfig(engine="auto", max_steps=48000, window=600, iters=2,
                     energy_chunk=12)
    ours_pteq = PTEQ(spec, states, args.p, cfg, seed=1).distribution.astype(float)

    print("this framework: STDC (production engine, same warm starts)...",
          flush=True)
    ours_stdc = STDC(spec, warm, args.p, 0.25,
                     droplets=args.stdc_droplets, steps=args.stdc_steps,
                     seed=1).astype(float)

    ours_strc = None
    if ref_strc is not None:
        from mcmc_qec_tpu.decoders import STRC

        print("this framework: STRC (same warm starts)...", flush=True)
        ours_strc = STRC(spec, warm, args.p, 0.25,
                         droplets=args.stdc_droplets,
                         steps=args.strc_steps, seed=1).astype(float)

    ours_lit = None
    if not args.skip_literal:
        print("this framework: STDC (literal parity engine)...", flush=True)
        ours_lit = STDC(spec, warm, args.p, 0.25,
                        droplets=args.stdc_droplets,
                        steps=min(args.stdc_steps, 4000),
                        engine="literal", seed=1).astype(float)

    def wilson_ci(k, m, z=1.96):
        ph = k / m
        den = 1 + z * z / m
        ctr = (ph + z * z / (2 * m)) / den
        hw = z * np.sqrt(ph * (1 - ph) / m + z * z / (4 * m * m)) / den
        return round(float(ctr - hw), 3), round(float(ctr + hw), 3)

    def compare(name, a, b):
        tvs = [tv(a[i] / 100.0, b[i] / 100.0) for i in range(n)]
        agree = int((np.argmax(a, -1) == np.argmax(b, -1)).sum())
        rec = {
            "pair": name,
            "argmax_agree": f"{agree}/{n}",
            "agree_ci95": wilson_ci(agree, n),
            "tv_mean": round(float(np.mean(tvs)), 4),
            "tv_max": round(float(np.max(tvs)), 4),
        }
        print(json.dumps(rec), flush=True)
        return rec

    results = {
        "n": n, "d": args.d, "p": args.p,
        "stdc_steps": args.stdc_steps, "stdc_droplets": args.stdc_droplets,
        "comparisons": [
            compare("ref_PTEQ_A vs ref_PTEQ_B (self)", ref_pteq_a, ref_pteq_b),
            compare("ref_PTEQ vs ours_PTEQ", ref_pteq_a, ours_pteq),
            compare("ref_STDC vs ours_STDC", ref_stdc, ours_stdc),
            compare("ref_PTEQ vs ref_STDC (cross-alg)", ref_pteq_a, ref_stdc),
            compare("ours_PTEQ vs ours_STDC (cross-alg)", ours_pteq, ours_stdc),
        ],
    }
    if ours_strc is not None:
        results["comparisons"].append(
            compare("ref_STRC vs ours_STRC", ref_strc, ours_strc)
        )
        results["comparisons"].append(
            compare("ref_STRC vs ref_STDC (cross-alg)", ref_strc, ref_stdc)
        )
    if ours_lit is not None:
        results["comparisons"].append(
            compare("ref_STDC vs ours_STDC_literal", ref_stdc, ours_lit)
        )
    # ground-truth recovery per estimator (hard syndromes: not all recoverable)
    for nm, d_ in [("ref_PTEQ", ref_pteq_a), ("ours_PTEQ", ours_pteq),
                   ("ref_STDC", ref_stdc), ("ours_STDC", ours_stdc)] + (
                   [("ref_STRC", ref_strc), ("ours_STRC", ours_strc)]
                   if ours_strc is not None else []):
        results[f"correct_{nm}"] = int(
            (np.argmax(d_, -1) == truth).sum()
        )
    print(json.dumps({k: v for k, v in results.items()
                      if k != "comparisons"}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
