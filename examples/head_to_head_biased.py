"""Head-to-head for the biased- and alpha-noise families: our
PTEQ_biased / PTEQ_alpha vs the reference's executing `PTEQ_biased` /
`PTEQ_alpha` (decoders_biasednoise.py:28-75, 175-222) on fixed XZZX
syndromes — the pairings the reference's own __main__ exercises
(decoders_biasednoise.py:240-277).

Same protocol as examples/head_to_head.py: the reference runs interpreted
with numba stubbed, its unseeded global RNG is calibrated by a second
reference run, and agreement is measured as per-syndrome total variation
plus argmax coincidence.

Run:  python examples/head_to_head_biased.py -n 8 --out /tmp/h2h_biased.json
      python examples/head_to_head_biased.py -n 8 --alpha 2.0 --pz-tilde 0.15
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")
os.environ.setdefault("MPLBACKEND", "Agg")

import numpy as np

from head_to_head import _stub_numba, tv  # noqa: E402 (same directory)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=8)
    ap.add_argument("--d", type=int, default=5)
    ap.add_argument("--p", type=float, default=0.15)
    ap.add_argument("--eta", type=float, default=0.5)
    ap.add_argument("--alpha", type=float, default=None,
                    help="run the alpha family instead (PTEQ_alpha)")
    ap.add_argument("--pz-tilde", type=float, default=0.15)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    from mcmc_qec_tpu.models import get_spec, np_eq_class
    from mcmc_qec_tpu.models.noise import sample_depolarizing
    from mcmc_qec_tpu.decoders import PTEQ_alpha, PTEQ_biased
    from mcmc_qec_tpu.decoders.pteq import PTEQConfig

    spec = get_spec("xzzx", args.d)
    states = np.asarray(
        sample_depolarizing(jax.random.PRNGKey(7), spec, 0.10, (args.n,))
    )
    truth = np_eq_class(spec, states)
    n = len(states)

    _stub_numba()
    sys.path.insert(0, "/root/reference")
    import decoders_biasednoise as ref_bias  # noqa: E402
    from src.xzzx_model import xzzx_code  # noqa: E402

    name = "PTEQ_alpha" if args.alpha is not None else "PTEQ_biased"

    def ref_run(tag):
        out = np.zeros((n, spec.n_classes))
        t0 = time.perf_counter()
        for i, s in enumerate(states):
            code = xzzx_code(args.d)
            code.qubit_matrix = np.asarray(s, np.uint8).reshape(
                args.d, args.d).copy()
            code.syndrome()
            if args.alpha is not None:
                out[i] = np.asarray(
                    ref_bias.PTEQ_alpha(code, args.pz_tilde, args.alpha),
                    float,
                )
            else:
                out[i] = np.asarray(
                    ref_bias.PTEQ_biased(code, args.p, eta=args.eta), float
                )
            print(f"  ref {name} {tag} {i + 1}/{n} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
        return out

    print(f"reference {name} run A...", flush=True)
    ref_a = ref_run("A")
    print(f"reference {name} run B (self-TV)...", flush=True)
    ref_b = ref_run("B")

    print(f"this framework: {name} (default engine)...", flush=True)
    cfg = PTEQConfig(engine="auto", max_steps=48000, window=600, iters=2,
                     energy_chunk=12)
    if args.alpha is not None:
        ours = PTEQ_alpha(spec, states, args.pz_tilde, args.alpha, cfg=cfg,
                          seed=1).distribution.astype(float)
    else:
        ours = PTEQ_biased(spec, states, args.p, eta=args.eta, cfg=cfg,
                           seed=1).distribution.astype(float)

    def compare(name, a, b):
        tvs = [tv(a[i] / 100.0, b[i] / 100.0) for i in range(n)]
        rec = {
            "pair": name,
            "argmax_agree": f"{int((np.argmax(a, -1) == np.argmax(b, -1)).sum())}/{n}",
            "tv_mean": round(float(np.mean(tvs)), 4),
            "tv_max": round(float(np.max(tvs)), 4),
        }
        print(json.dumps(rec), flush=True)
        return rec

    results = {
        "n": n, "d": args.d, "p": args.p, "eta": args.eta,
        "family": name, "alpha": args.alpha, "pz_tilde": args.pz_tilde,
        "comparisons": [
            compare("ref_A vs ref_B (self)", ref_a, ref_b),
            compare("ref vs ours", ref_a, ours),
        ],
        "correct_ref": int((np.argmax(ref_a, -1) == truth).sum()),
        "correct_ours": int((np.argmax(ours, -1) == truth).sum()),
    }
    print(json.dumps({k: v for k, v in results.items()
                      if k != "comparisons"}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
