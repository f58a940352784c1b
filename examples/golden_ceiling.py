"""Golden-corpus recovery CEILING: what fraction of the DRL failure set is
recoverable at a near-reference step budget?

Production replays cap PTEQ at 8k steps (RESULTS.md); the reference's own
budget is 5e7 ladder steps of 10 proposals (decoders.py:25).  This script
runs ONE high-budget PTEQ pass over all 2603 hard d=5 toric syndromes
(default cap 320k steps = 40x production; the sweep/kernel engines do
iters full lattice sweeps per step, so the proposal budget is within ~2x
of the reference's) and prints recovery %, convergence %, and wall time,
plus MWPM / eMWPM context rows.

Run:  python examples/golden_ceiling.py            # full corpus, 40x cap
      python examples/golden_ceiling.py --limit 256 --cap 32000
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np

CORPUS = "/root/reference/data/drl_failures_p_0.15.xz"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default=CORPUS)
    ap.add_argument("--cap", type=int, default=320_000)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--window", type=int, default=200)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--skip-mwpm", action="store_true")
    args = ap.parse_args()

    from mcmc_qec_tpu.decoders import PTEQ, PTEQConfig
    from mcmc_qec_tpu.pipeline import load_golden_corpus

    spec, flat, trues = load_golden_corpus(args.corpus)
    if args.limit:
        flat, trues = flat[: args.limit], trues[: args.limit]
    N = len(flat)
    print(f"{N} syndromes, {spec.family} d={spec.size}")

    if not args.skip_mwpm:
        from mcmc_qec_tpu.matching.graph import (  # noqa: F401
            class_sorted_mwpm_batch,
            regular_mwpm_batch,
        )

        t0 = time.perf_counter()
        mw = regular_mwpm_batch(spec, flat)
        t_mw = time.perf_counter() - t0
        print(f"MWPM : {100 * np.mean(mw == trues):.2f}% in {t_mw:.1f}s")

        if spec.family == "planar":
            # eMWPM: shortest total-length class (generate_data.py:210-220);
            # class-constrained solutions are planar-only, as in the
            # reference (mwpm.py:417-437)
            t0 = time.perf_counter()
            seeds = class_sorted_mwpm_batch(spec, flat)
            em = (seeds != 0).sum(axis=-1).argmin(axis=1)
            t_em = time.perf_counter() - t0
            print(f"eMWPM: {100 * np.mean(em == trues):.2f}% in {t_em:.1f}s")
        else:
            print("eMWPM: n/a (class-constrained MWPM is planar-only, "
                  "mwpm.py:417-437)")

    t0 = time.perf_counter()
    res = PTEQ(
        spec, flat, 0.15,
        PTEQConfig(max_steps=args.cap, window=args.window, iters=args.iters,
                   engine=args.engine),
        seed=1,
    )
    dt = time.perf_counter() - t0
    pred = res.distribution.argmax(axis=-1)
    ok = int((pred == trues).sum())
    print(
        f"PTEQ cap={args.cap} engine={args.engine}: recovered {ok}/{N} "
        f"({100 * ok / N:.2f}%), converged {100 * res.converged.mean():.1f}%, "
        f"{dt:.1f}s ({N / dt:.1f} syn/s), buckets={res.buckets}"
    )


if __name__ == "__main__":
    main()
