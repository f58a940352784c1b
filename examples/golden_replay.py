"""Golden-corpus replay: decode the reference's hard-syndrome set.

data/drl_failures_p_0.15.xz holds 2603 d=5 toric syndromes on which a
trained deep-RL decoder failed at p=0.15.  Replaying them measures how much
of the DRL decoder's failure set the MCMC decoders recover.

Run:  python examples/golden_replay.py --decoder PTEQ --limit 256
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
    ap.add_argument("--decoder", default="PTEQ", choices=["PTEQ", "STDC"])
    ap.add_argument("--limit", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--droplets", type=int, default=8)
    ap.add_argument("--engine", default="auto")
    args = ap.parse_args()

    from mcmc_qec_tpu.pipeline import load_golden_corpus
    from mcmc_qec_tpu.decoders import PTEQ, PTEQConfig, STDC

    spec, flat, trues = load_golden_corpus(args.corpus)
    states, truth = flat[: args.limit], trues[: args.limit]
    N = len(states)
    t0 = time.perf_counter()
    if args.decoder == "STDC":
        distr = STDC(spec, states, 0.15, 0.40, droplets=args.droplets,
                     steps=args.steps, engine=args.engine)
    else:
        # the production-recorded configuration (RESULTS.md): window=600 /
        # energy_chunk=12 shapes are also what production runs compile, so
        # the persistent cache usually makes this start warm
        res = PTEQ(
            spec, states, 0.15,
            PTEQConfig(max_steps=args.steps, window=600, iters=2,
                       energy_chunk=12, engine=args.engine),
        )
        distr = res.distribution
        print(f"converged: {int(res.converged.sum())}/{N}")
    dt = time.perf_counter() - t0
    ok = int((np.argmax(distr, -1) == truth).sum())
    print(f"{args.decoder}: recovered {ok}/{N} ({100*ok/N:.1f}%) of the DRL "
          f"failure set in {dt:.1f}s")


if __name__ == "__main__":
    main()
