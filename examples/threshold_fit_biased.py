"""Biased-noise XZZX threshold estimate — the reference's *other*
scientific axis (decoders_biasednoise.py:240-277 scans the XZZX logical
failure rate under biased noise; it plots points but never fits).

For fixed bias eta, biased noise (p, eta) is converted to its
alpha-equivalent (pz_tilde, alpha) exactly as the reference's driver does
(generate_data.py:147-150; models/noise.biased_alpha_equivalent) and
decoded with PTEQ_alpha on the XZZX code.  Failure-rate rows are written
in the SAME JSON format as examples/threshold_fit.py, so its ``fit``
subcommand (finite-size-scaling ansatz + parametric bootstrap) applies
unchanged:

  # collect (GPU; resumable, appends):
  python examples/threshold_fit_biased.py collect --eta 10 \
      --sizes 5,7,9,11,13 --ps 0.28,0.30,... -n 2048 --data thr_eta10.json
  # fit (shared machinery):
  python examples/threshold_fit.py fit --data thr_eta10.json --p0 0.30

Context for the chosen eta=10 grid: the XZZX code under biased noise has
thresholds far above the depolarizing ~18.9% (Bonilla Ataides et al.,
"The XZZX surface code", Nat. Commun. 12, 2172 (2021) report ~38.7% at
infinite bias and >30% for eta >~ 10 with matching-free decoders); the
crossing located by the coarse scan here sits in that regime.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def collect(args):
    import jax

    from mcmc_qec_tpu.models import get_spec, np_eq_class
    from mcmc_qec_tpu.models.noise import (
        biased_alpha_equivalent,
        sample_xyz,
        xyz_probs_from_biased,
    )
    from mcmc_qec_tpu.decoders.pteq import PTEQ_alpha, PTEQConfig

    sizes = [int(s) for s in args.sizes.split(",")]
    ps = [float(x) for x in args.ps.split(",")]
    done = {}
    results = []
    if os.path.exists(args.data):
        results = json.load(open(args.data))
        done = {(r["d"], r["p"], r["n"]) for r in results}
    for d in sizes:
        spec = get_spec("xzzx", d)
        # d-scaled step cap, same convention as the depolarizing study
        # (threshold_fit.py; calibrated there for >=90% convergence near
        # threshold — converged_frac is recorded per point regardless)
        cap = args.cap or max(24000, int(args.cap_c * d**3))
        cfg = PTEQConfig(engine="auto", max_steps=cap, window=600, iters=2,
                         energy_chunk=12)
        for p in ps:
            B = min(args.batch, args.n)
            n_total = B * (-(-args.n // B))
            tag = (d, p, n_total)
            if tag in done:
                continue
            px, py, pz = xyz_probs_from_biased(p, args.eta)
            pz_tilde, alpha = biased_alpha_equivalent(p, args.eta)
            fails = conv = 0
            t0 = time.perf_counter()
            for rep in range(-(-args.n // B)):
                # key folds in p too: reusing one key across the p-grid
                # would sample common random numbers along p, correlating
                # the fit's points (bootstrap assumes independence)
                kp = jax.random.fold_in(
                    jax.random.PRNGKey(7000 * rep + 31 * d),
                    int(round(p * 100000)),
                )
                states = np.asarray(sample_xyz(kp, spec, px, py, pz, (B,)))
                truth = np_eq_class(spec, states)
                res = PTEQ_alpha(spec, states, pz_tilde, alpha, cfg,
                                 seed=rep + 1)
                fails += int(
                    (np.argmax(res.distribution, -1) != truth).sum()
                )
                conv += int(res.converged.sum())
            rec = {
                "d": d, "p": p, "n": n_total, "eta": args.eta,
                "pz_tilde": round(pz_tilde, 6), "alpha": round(alpha, 6),
                "fails": fails,
                "failure_rate": fails / n_total,
                "mc_err": float(np.sqrt(
                    max(fails / n_total * (1 - fails / n_total), 1e-9)
                    / n_total
                )),
                "converged_frac": conv / n_total,
                "cap": cap,
                "seconds": round(time.perf_counter() - t0, 1),
            }
            results.append(rec)
            print(json.dumps(rec), flush=True)
            with open(args.data, "w") as f:
                json.dump(results, f, indent=1)


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("collect")
    c.add_argument("--eta", type=float, default=10.0)
    c.add_argument("--sizes", default="5,7,9,11,13")
    c.add_argument("--ps", required=True)
    c.add_argument("-n", type=int, default=2048)
    c.add_argument("--batch", type=int, default=512)
    c.add_argument("--cap", type=int, default=0)
    c.add_argument("--cap-c", type=float, default=15.0)
    c.add_argument("--data", required=True)
    c.set_defaults(fn=collect)
    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
