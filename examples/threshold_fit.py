"""Threshold estimate with uncertainties — finite-size-scaling fit of the
PTEQ failure-rate crossing (the reference project's headline scientific
deliverable, /root/reference/plot_uncorrelated.py:200-301, which plots the
curves but never fits the crossing).

Model: near threshold the logical failure rate obeys the standard
finite-size-scaling ansatz

    f(p, d) = A + B x + C x^2,     x = (p - p_th) d^(1/nu)

(quadratic expansion of the universal scaling function; e.g. Wang, Harrington
& Preskill 2003 for the toric-code random-bond mapping).  We fit
(p_th, nu, A, B, C) by weighted least squares over a (d, p) grid with
binomial errors, and report p_th +/- CI from a parametric bootstrap.

Usage:
  # collect (runs PTEQ on the GPU; resumable, appends to --data):
  python examples/threshold_fit.py collect --sizes 5,7,9,11,13 \
      --ps 0.175,0.1825,0.19,0.1975 -n 2048 --data /tmp/thr.json
  # fit:
  python examples/threshold_fit.py fit --data /tmp/thr.json
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
    from mcmc_qec_tpu.models.noise import sample_depolarizing
    from mcmc_qec_tpu.decoders.pteq import PTEQ, PTEQConfig

    sizes = [int(s) for s in args.sizes.split(",")]
    ps = [float(x) for x in args.ps.split(",")]
    done = {}
    results = []
    if os.path.exists(args.data):
        results = json.load(open(args.data))
        done = {(r["d"], r["p"], r["n"]) for r in results}
    for d in sizes:
        spec = get_spec("toric", d)
        # step cap: scaled with d for >= 90% convergence at threshold
        # (calibrated in RESULTS.md "Converged production PTEQ"; the
        # reference's convention is proposals ~ 5 d^5, generate_data.py:296)
        cap = args.cap or max(24000, int(args.cap_c * d**3))
        cfg = PTEQConfig(engine="auto", max_steps=cap, window=600, iters=2,
                         energy_chunk=12)
        for p in ps:
            B = min(args.batch, args.n)
            n_total = B * (-(-args.n // B))  # the n actually stored
            tag = (d, p, n_total)
            if tag in done:
                continue
            fails = conv = 0
            t0 = time.perf_counter()
            for rep in range(-(-args.n // B)):
                # fold p into the key: one key across the p-grid would
                # sample common random numbers along p (correlated points;
                # the bootstrap assumes independence).  Round-4's grid was
                # collected pre-fix — its CI is slightly understated.
                kp = jax.random.fold_in(
                    jax.random.PRNGKey(1000 * rep + d),
                    int(round(p * 100000)),
                )
                states = np.asarray(sample_depolarizing(kp, spec, p, (B,)))
                truth = np_eq_class(spec, states)
                res = PTEQ(spec, states, p, cfg, seed=rep + 1)
                fails += int(
                    (np.argmax(res.distribution, -1) != truth).sum()
                )
                conv += int(res.converged.sum())
            n = B * (-(-args.n // B))
            rec = {
                "d": d, "p": p, "n": n, "fails": fails,
                "failure_rate": fails / n,
                "mc_err": float(np.sqrt(max(fails / n * (1 - fails / n), 1e-9) / n)),
                "converged_frac": conv / n,
                "cap": cap,
                "seconds": round(time.perf_counter() - t0, 1),
            }
            results.append(rec)
            print(json.dumps(rec), flush=True)
            with open(args.data, "w") as f:
                json.dump(results, f, indent=1)


def _fit_once(ds, ps, fs, ws, correction=False, p0=0.189):
    """Weighted LS fit of (p_th, nu, A, B, C[, D]); with ``correction`` the
    model adds the leading non-universal finite-size term D d^-1 (cf. the
    correction-to-scaling treatment in Wang-Harrington-Preskill 2003)."""
    from scipy.optimize import least_squares

    def resid(theta):
        p_th, inv_nu, A, B, C = theta[:5]
        x = (ps - p_th) * ds**inv_nu
        model = A + B * x + C * x**2
        if correction:
            model = model + theta[5] / ds
        return (model - fs) * ws

    th0 = [p0, 1.0 / 1.5, np.mean(fs), 1.0, 0.0]
    if correction:
        th0.append(0.0)
    sol = least_squares(resid, np.array(th0), method="lm", max_nfev=20000)
    return sol.x


def fit(args):
    results = json.load(open(args.data))
    if args.min_converged:
        results = [r for r in results
                   if r.get("converged_frac", 1.0) >= args.min_converged]
    ds = np.array([r["d"] for r in results], float)
    ps = np.array([r["p"] for r in results], float)
    fs = np.array([r["failure_rate"] for r in results], float)
    ns = np.array([r["n"] for r in results], float)
    # variance floor ~ binomial zero-count scale 1/n (a fixed 1e-9 floor
    # would give zero-failure points ~10^4x the weight of typical ones)
    errs = np.sqrt(np.maximum(fs * (1 - fs), 1.0 / ns) / ns)
    ws = 1.0 / errs
    p0 = getattr(args, "p0", 0.189)
    theta = _fit_once(ds, ps, fs, ws, correction=args.correction, p0=p0)
    p_th, inv_nu = theta[0], theta[1]
    # parametric bootstrap: resample each point from Binomial(n, f_fit-ish)
    rng = np.random.RandomState(0)
    boots = []
    for _ in range(args.boot):
        fb = rng.binomial(ns.astype(int), np.clip(fs, 1e-6, 1 - 1e-6)) / ns
        try:
            tb = _fit_once(ds, ps, fb, ws, correction=args.correction, p0=p0)
            if abs(tb[0] - theta[0]) < 0.1:
                boots.append(tb[:2])
        except Exception:
            pass
    boots = np.array(boots)
    nu = 1.0 / inv_nu
    if len(boots):
        lo, hi = np.percentile(boots[:, 0], [2.5, 97.5])
        nus = 1.0 / boots[:, 1]
        nlo, nhi = np.percentile(nus, [2.5, 97.5])
    else:  # every bootstrap refit failed: report the point estimate only
        lo = hi = p_th
        nlo = nhi = nu
    n_par = 6 if args.correction else 5
    out = {
        "p_th": round(float(p_th), 5),
        "p_th_ci95": [round(float(lo), 5), round(float(hi), 5)],
        "nu": round(float(nu), 3),
        "nu_ci95": [round(float(nlo), 3), round(float(nhi), 3)],
        "correction": bool(args.correction),
        "n_points": len(results),
        "n_boot_ok": len(boots),
        "residual_chi2_per_dof": round(
            float(np.sum(((_model(theta, ds, ps) - fs) * ws) ** 2)
                  / max(len(fs) - n_par, 1)), 2),
    }
    print(json.dumps(out, indent=1))
    return out


def _model(theta, ds, ps):
    p_th, inv_nu, A, B, C = theta[:5]
    x = (ps - p_th) * ds**inv_nu
    model = A + B * x + C * x**2
    if len(theta) > 5:
        model = model + theta[5] / ds
    return model


def plot(args):
    """Two-panel threshold figure: failure-rate curves per d with the
    fitted p_th, and the finite-size-scaling data collapse.

    Encoding: d is an ordered magnitude, so it wears a single-hue ordinal
    blue ramp (light -> dark = small -> large d; lightness-monotone, so
    the order survives every color-vision deficiency); identity is
    double-encoded by the legend and the distinct marker per d.  One axis
    per panel; recessive grid; text in ink, not series color."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    results = json.load(open(args.data))
    ds_all = sorted({r["d"] for r in results})
    ramp = ["#86b6ef", "#5598e7", "#2a78d6", "#1c5cab", "#104281",
            "#0d366b"]
    markers = ["o", "s", "D", "^", "v", "P"]
    color = {d: ramp[i % len(ramp)] for i, d in enumerate(ds_all)}
    mark = {d: markers[i % len(markers)] for i, d in enumerate(ds_all)}

    ds = np.array([r["d"] for r in results], float)
    ps = np.array([r["p"] for r in results], float)
    fs = np.array([r["failure_rate"] for r in results], float)
    ns = np.array([r["n"] for r in results], float)
    errs = np.sqrt(np.maximum(fs * (1 - fs), 1.0 / ns) / ns)
    ws = 1.0 / errs
    theta = _fit_once(ds, ps, fs, ws, p0=float(np.median(ps)))
    p_th, inv_nu = float(theta[0]), float(theta[1])

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.4), dpi=150)
    ink, muted = "#1a1a1a", "#6b6b6b"
    for ax in (ax1, ax2):
        ax.grid(True, color="#e8e7e4", linewidth=0.8, zorder=0)
        ax.spines[["top", "right"]].set_visible(False)
        ax.tick_params(colors=muted)
    for d in ds_all:
        sel = ds == d
        o = np.argsort(ps[sel])
        ax1.errorbar(ps[sel][o], fs[sel][o], yerr=errs[sel][o],
                     color=color[d], marker=mark[d], ms=4.5, lw=2,
                     capsize=2, label=f"d={d}", zorder=3)
        x = (ps[sel] - p_th) * d**inv_nu
        ax2.errorbar(x[o], fs[sel][o], yerr=errs[sel][o], ls="none",
                     color=color[d], marker=mark[d], ms=5, capsize=2,
                     label=f"d={d}", zorder=3)
    ax1.axvline(p_th, color=muted, lw=1, ls="--", zorder=1)
    ax1.annotate(f"$p_{{th}}$ = {p_th:.4f}", (p_th, ax1.get_ylim()[0]),
                 xytext=(4, 6), textcoords="offset points", color=ink,
                 fontsize=9)
    ax1.set_xlabel("physical error rate p", color=ink)
    ax1.set_ylabel("logical failure rate", color=ink)
    ax1.set_title("PTEQ failure rates near threshold", color=ink,
                  fontsize=11)
    ax1.legend(frameon=False, fontsize=8, loc="upper left")
    xx = np.linspace(min((ps - p_th) * ds**inv_nu),
                     max((ps - p_th) * ds**inv_nu), 100)
    ax2.plot(xx, theta[2] + theta[3] * xx + theta[4] * xx**2,
             color=muted, lw=1, ls="--", zorder=2)
    ax2.set_xlabel(r"$x = (p - p_{th})\,d^{1/\nu}$", color=ink)
    ax2.set_ylabel("logical failure rate", color=ink)
    ax2.set_title(
        rf"data collapse  ($\nu$ = {1.0 / inv_nu:.2f})", color=ink,
        fontsize=11)
    ax2.legend(frameon=False, fontsize=8, loc="upper left")
    fig.tight_layout()
    fig.savefig(args.out)
    print(f"wrote {args.out}")


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("collect")
    c.add_argument("--sizes", default="5,7,9,11,13")
    c.add_argument("--ps", default="0.175,0.1825,0.19,0.1975")
    c.add_argument("-n", type=int, default=2048)
    c.add_argument("--batch", type=int, default=512)
    c.add_argument("--cap", type=int, default=None,
                   help="fixed step cap (default: cap_c * d^3)")
    c.add_argument("--cap-c", type=float, default=50.0)
    c.add_argument("--data", required=True)
    f = sub.add_parser("fit")
    f.add_argument("--data", required=True)
    f.add_argument("--boot", type=int, default=400)
    f.add_argument("--min-converged", type=float, default=0.0)
    f.add_argument("--p0", type=float, default=0.189,
                   help="initial p_th guess (e.g. ~0.3 for biased XZZX)")
    f.add_argument("--correction", action="store_true",
                   help="add the leading D/d correction-to-scaling term")
    pl = sub.add_parser("plot")
    pl.add_argument("--data", required=True)
    pl.add_argument("--out", default="threshold.png")
    args = ap.parse_args()
    if args.cmd == "collect":
        collect(args)
    elif args.cmd == "plot":
        plot(args)
    else:
        fit(args)


if __name__ == "__main__":
    main()
