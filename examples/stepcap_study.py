"""Step-cap parity study: does PTEQ's step cap bias failure rates?

The reference caps PTEQ at 5e7 ladder steps (decoders.py:25); this
framework defaults to 1e6 (PTEQConfig) / 2e5 per batch in the pipeline
(RunConfig.max_steps).  Near threshold a fraction of syndromes hit the
cap before the error-based criterion fires; this script measures whether
that biases the logical failure rate by decoding the SAME syndromes with
the default cap and a k-times-larger cap (same decode seed) and
comparing failure rates, convergence fractions, and decision flips.

Run:  python examples/stepcap_study.py --sizes 7 --ps 0.15,0.19 -n 256 --mult 4
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np
import jax

from mcmc_qec_tpu.models import get_spec, np_eq_class
from mcmc_qec_tpu.models.noise import sample_depolarizing
from mcmc_qec_tpu.decoders import PTEQ, PTEQConfig


def run_point(family, d, p, n, cap, seed, engine, window, iters):
    spec = get_spec(family, d)
    states = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(seed), spec, p, (n,))
    )
    truth = np_eq_class(spec, states)
    cfg = PTEQConfig(engine=engine, max_steps=cap, window=window,
                     iters=iters, energy_chunk=12)
    t0 = time.perf_counter()
    res = PTEQ(spec, states, p, cfg, seed=seed + 1)
    dt = time.perf_counter() - t0
    pred = np.argmax(res.distribution, -1)
    return {
        "failure_rate": float((pred != truth).mean()),
        "converged_frac": float(res.converged.mean()),
        "mean_steps": float(res.steps.mean()),
        "seconds": round(dt, 1),
        "pred": pred,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="toric")
    ap.add_argument("--sizes", default="7")
    ap.add_argument("--ps", default="0.15,0.19")
    ap.add_argument("-n", type=int, default=256)
    ap.add_argument("--cap", type=int, default=24000)
    ap.add_argument("--mult", type=int, default=4)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--window", type=int, default=600)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    results = []
    for d in [int(s) for s in args.sizes.split(",")]:
        for p in [float(x) for x in args.ps.split(",")]:
            base = run_point(args.family, d, p, args.n, args.cap,
                             args.seed, args.engine, args.window, args.iters)
            big = run_point(args.family, d, p, args.n,
                            args.cap * args.mult, args.seed, args.engine,
                            args.window, args.iters)
            flips = int((base.pop("pred") != big.pop("pred")).sum())
            rate = base["failure_rate"]
            mc_err = float(np.sqrt(max(rate * (1 - rate), 1e-9) / args.n))
            rec = {
                "family": args.family, "d": d, "p": p, "n": args.n,
                "cap": args.cap, "mult": args.mult, "mc_err": round(mc_err, 4),
                "at_cap": base, "at_cap_x_mult": big,
                "decision_flips": flips,
            }
            results.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
