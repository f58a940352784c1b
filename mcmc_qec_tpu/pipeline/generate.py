"""Batch data-generation driver.

Batched redesign of generate_data.py:20-269 and
generate_data_noise_models.py:17-195: instead of one syndrome per process,
whole batches of syndromes are sampled, warm-started and decoded per device
step, with periodic checkpointing and ``fixed_errors`` early stop.

Method dispatch mirrors the reference drivers (generate_data.py:136-227,
generate_data_noise_models.py:59-153), including the noise-model parameter
conversions (biased -> alpha for PTEQ, generate_data.py:147-150;
depolarizing -> uncorrelated p_xyz, generate_data_noise_models.py:203-209).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import get_spec, np_eq_class
from ..models.base import CodeSpec
from ..models.noise import (
    biased_alpha_equivalent,
    sample_depolarizing,
    sample_xyz,
    xyz_probs_from_alpha,
    xyz_probs_from_biased,
)
from ..decoders import (
    PTDC,
    PTEQ,
    PTEQConfig,
    PTEQ_alpha,
    PTEQ_alpha_with_shortest,
    PTRC,
    STDC,
    STDC_Nall_n_alpha,
    STDC_general_noise,
    STRC,
    single_temp,
)
from ..matching import (
    class_sorted_mwpm_batch,
    regular_mwpm_batch,
)
from ..ops.pauli import random_logical
from .config import RunConfig
from .dataset import Dataset


def sample_errors(spec: CodeSpec, cfg: RunConfig, key) -> np.ndarray:
    """Batched error sampling per (code, noise) (generate_data.py:56-118)."""
    noise = cfg.noise
    if noise == "depolarizing":
        return np.asarray(sample_depolarizing(key, spec, cfg.p_error, (cfg.batch,)))
    if noise == "biased":
        px, py, pz = xyz_probs_from_biased(cfg.p_error, cfg.eta)
        return np.asarray(sample_xyz(key, spec, px, py, pz, (cfg.batch,)))
    if noise == "alpha":
        # p_error is pz_tilde in the alpha drivers (generate_data.py:67-74)
        px, py, pz = xyz_probs_from_alpha(cfg.p_error, cfg.alpha)
        return np.asarray(sample_xyz(key, spec, px, py, pz, (cfg.batch,)))
    if noise == "uncorrelated":
        # independent X/Z channels of strength p_u = 1 - sqrt(1-p)
        # (generate_data_noise_models.py:203-209)
        p_u = 1.0 - np.sqrt(1.0 - cfg.p_error)
        p_xz = p_u * (1.0 - p_u)
        p_y = p_u**2
        return np.asarray(sample_xyz(key, spec, p_xz, p_y, p_xz, (cfg.batch,)))
    raise ValueError(f"unknown noise {noise!r}")


def uncorrelated_p_xyz(p_error: float) -> np.ndarray:
    p_u = 1.0 - np.sqrt(1.0 - p_error)
    return np.array([p_u * (1.0 - p_u), p_u**2, p_u * (1.0 - p_u)])


def decode_batch(spec: CodeSpec, cfg: RunConfig, states: np.ndarray,
                 seed: int, metrics=None) -> Tuple[np.ndarray, Callable]:
    """Dispatch a batch to the configured decoder.

    Returns (distributions (B, K), decision_fn) where decision_fn maps a
    distribution row to the decoded class (argmax, or argmin for ST —
    generate_data.py:199-203)."""
    method, noise = cfg.method, cfg.noise
    B = states.shape[0]

    # warm start (generate_data.py:126-133), thread-pooled across the batch
    # so the host matcher doesn't starve the device at B >= 256
    if cfg.mwpm_init:
        assert spec.family == "planar", "mwpm_init requires the planar code"
        init = class_sorted_mwpm_batch(spec, states)  # (B,4,nq)
    else:
        key = jax.random.PRNGKey(seed ^ 0x5EED)
        init = np.asarray(random_logical(spec, jnp.asarray(states), key))

    argmax = lambda d: int(np.argmax(d))
    argmin = lambda d: int(np.argmin(d))

    pteq_cfg = PTEQConfig(
        Nc=cfg.Nc, SEQ=cfg.SEQ, TOPS=cfg.TOPS, eps=cfg.eps,
        max_steps=cfg.max_steps, iters=cfg.iters, window=cfg.window,
        conv_criteria=cfg.conv_criteria,
        engine=cfg.engine,
        # mid-decode resume: one checkpoint stream per batch offset so a
        # preempted generate() resumes the in-flight batch exactly
        ckpt_dir=(
            f"{cfg.ckpt_dir}/batch_{seed}"
            if cfg.ckpt_dir and method in ("PTEQ",)
            else None
        ),
    )

    if method == "PTEQ":
        if noise == "depolarizing":
            res = PTEQ(spec, init, cfg.p_error, pteq_cfg, seed=seed,
                       metrics=metrics)
        elif noise == "biased":
            pz_tilde, alpha = biased_alpha_equivalent(cfg.p_error, cfg.eta)
            res = PTEQ_alpha(spec, init, pz_tilde, alpha, pteq_cfg, seed=seed,
                             metrics=metrics)
        elif noise == "alpha":
            res = PTEQ_alpha(spec, init, cfg.p_error, cfg.alpha, pteq_cfg,
                             seed=seed, metrics=metrics)
        else:
            raise ValueError(f"PTEQ does not support noise {noise!r}")
        return res.distribution.astype(np.float32), argmax
    if method == "PTEQ_with_shortest":
        # three concatenated distributions; failures scored on the first K
        # (generate_data.py:167-173)
        assert noise == "alpha"
        res = PTEQ_alpha_with_shortest(
            spec, init, cfg.p_error, cfg.alpha, pteq_cfg, seed=seed
        )
        distr = np.concatenate(
            [
                res.distribution.astype(np.float32),
                res.shortest_boltzmann.astype(np.float32),
                res.shortest_counts.astype(np.float32),
            ],
            axis=1,
        )
        return distr, lambda d: int(np.argmax(d[: spec.n_classes]))
    if method == "all":
        # ST + STDC + STRC concatenated (generate_data_noise_models.py:112-123)
        # independent RNG streams so the sub-decoders sample independent
        # chains (the reference runs separate chain objects per decoder)
        d1 = single_temp(spec, init, cfg.p_error, cfg.steps, seed=seed)
        d2 = STDC(spec, init, cfg.p_error, cfg.p_sampling, cfg.droplets,
                  cfg.steps, seed=seed + 1_000_003)
        d3 = STRC(spec, init, cfg.p_error, cfg.p_sampling, cfg.droplets,
                  cfg.steps, seed=seed + 2_000_003)
        distr = np.concatenate([d1, d2, d3], axis=1).astype(np.float32)
        K = spec.n_classes
        return distr, lambda d: int(np.argmax(d[K : 2 * K]))
    if method == "shortest_comparison":
        # four blocks: STDC depolarizing, its shortest-only truncation,
        # STDC uncorrelated and ITS shortest-only truncation — the dataset
        # plot_uncorrelated.py:149-197 (success_rates_shortest) scores.
        # Each pair comes from ONE sampled stream (decoders.py:490-505).
        from ..decoders import STDC_general_noise_shortest

        p3 = np.full(3, cfg.p_error / 3.0)
        d1, d1s = STDC_general_noise_shortest(
            spec, init, p3, cfg.p_sampling, cfg.droplets, cfg.steps,
            seed=seed,
        )
        d2, d2s = STDC_general_noise_shortest(
            spec, init, uncorrelated_p_xyz(cfg.p_error), cfg.p_sampling,
            cfg.droplets, cfg.steps, seed=seed + 1_000_003,
        )
        distr = np.concatenate([d1, d1s, d2, d2s], axis=1).astype(np.float32)
        return distr, lambda d: int(np.argmax(d[: spec.n_classes]))
    if method == "uncorrelated_comparison":
        # MWPM one-hot + STDC_general_noise; failures scored on the STDC
        # part (generate_data_noise_models.py:141-153)
        d1 = np.zeros((B, spec.n_classes), dtype=np.float32)
        d1[np.arange(B), regular_mwpm_batch(spec, states)] = 100.0
        d2 = STDC_general_noise(
            spec, init, uncorrelated_p_xyz(cfg.p_error), cfg.p_sampling,
            cfg.droplets, cfg.steps, seed=seed,
        ).astype(np.float32)
        distr = np.concatenate([d1, d2], axis=1)
        K = spec.n_classes
        return distr, lambda d: int(np.argmax(d[K : 2 * K]))
    if method == "PTDC":
        d = PTDC(spec, init, cfg.p_error, cfg.p_sampling, cfg.droplets,
                 cfg.Nc, cfg.steps, seed=seed,
                 engine=cfg.engine)
        return d.astype(np.float32), argmax
    if method == "PTRC":
        d = PTRC(spec, init, cfg.p_error, cfg.p_sampling, cfg.droplets,
                 cfg.Nc, cfg.steps, seed=seed,
                 engine=cfg.engine)
        return d.astype(np.float32), argmax
    if method == "STDC":
        if noise in ("depolarizing",):
            d = STDC(spec, init, cfg.p_error, cfg.p_sampling, cfg.droplets,
                     cfg.steps, seed=seed, engine=cfg.engine, metrics=metrics)
        elif noise == "uncorrelated":
            d = STDC_general_noise(spec, init, uncorrelated_p_xyz(cfg.p_error),
                                   cfg.p_sampling, cfg.droplets, cfg.steps,
                                   seed=seed)
        else:
            raise ValueError(f"STDC does not support noise {noise!r}")
        return d.astype(np.float32), argmax
    if method == "STDC_N_n":
        assert noise == "alpha"
        d = STDC_Nall_n_alpha(spec, init, cfg.p_sampling or 0.25, cfg.alpha,
                              cfg.p_error, cfg.droplets, cfg.steps, seed=seed)
        return d.astype(np.float32), argmax
    if method == "ST":
        d = single_temp(spec, init, cfg.p_error, cfg.steps, seed=seed)
        return d.astype(np.float32), argmin
    if method == "STRC":
        d = STRC(spec, init, cfg.p_error, cfg.p_sampling, cfg.droplets,
                 cfg.steps, seed=seed, engine=cfg.engine)
        return d.astype(np.float32), argmax
    if method == "eMWPM":
        # shortest total-length class among class-constrained solutions
        # (generate_data.py:210-220)
        out = np.zeros((B, spec.n_classes), dtype=np.float32)
        seeds_all = class_sorted_mwpm_batch(spec, states)  # (B, 4, nq)
        lens = (seeds_all != 0).sum(axis=-1)
        out[np.arange(B), lens.argmin(axis=1)] = 100.0
        return out, argmax
    if method == "MWPM":
        out = np.zeros((B, spec.n_classes), dtype=np.float32)
        out[np.arange(B), regular_mwpm_batch(spec, states)] = 100.0
        return out, argmax
    raise ValueError(f"unknown method {cfg.method!r}")


def _decode_with_retry(spec, cfg, states, seed, metrics, progress):
    """decode_batch with host-level failure detection (SURVEY §5).

    Runtime errors are retried up to ``cfg.retries`` times (default 0: a
    device fault fails the run) with linear backoff.  PTEQ batches with
    ``cfg.ckpt_dir`` resume from their mid-decode snapshot, so a retry
    continues the interrupted decode
    instead of repeating it; stateless decoders simply rerun (same seed —
    bit-identical samples).  Programming errors (bad config/shape) are
    re-raised immediately rather than retried."""
    last = None
    for attempt in range(cfg.retries + 1):
        try:
            return decode_batch(spec, cfg, states, seed, metrics=metrics)
        except (ValueError, TypeError, AssertionError, KeyError):
            raise  # config/shape bugs: retrying cannot help
        except Exception as e:  # device / runtime failures
            last = e
            if attempt >= cfg.retries:
                break
            if progress:
                progress(
                    f"[generate] decode attempt {attempt + 1} failed "
                    f"({type(e).__name__}: {str(e)[:120]}); retrying in "
                    f"{cfg.retry_wait * (attempt + 1):.0f}s"
                )
            if metrics is not None:
                metrics.log("decode_retry", attempt=attempt,
                            error=str(e)[:200], seed=seed)
            time.sleep(cfg.retry_wait * (attempt + 1))
    raise last


def generate(
    file_path: Optional[str],
    cfg: RunConfig,
    nbr_datapoints: int = 1000,
    progress: Optional[Callable[[str], None]] = print,
    append: bool = False,
) -> Dataset:
    """Generate and decode ``nbr_datapoints`` syndromes (in batches),
    checkpointing to ``file_path`` and stopping early once
    ``cfg.fixed_errors`` failures accumulate (generate_data.py:258-261).

    With ``append=True`` an existing dataset at ``file_path`` is extended up
    to ``nbr_datapoints`` total (the noise-models driver's capacity-capped
    resume, generate_data_noise_models.py:27-46)."""
    import os

    spec = get_spec(cfg.code, cfg.size)
    if cfg.fixed_errors is not None:
        nbr_datapoints = 10_000_000  # run until enough failures
    qms, distrs, trues = [], [], []
    failed = 0
    done = 0
    if append and file_path and os.path.exists(file_path):
        prev = Dataset.load(file_path)
        if len(prev):
            qms.append(prev.qubit_matrices)
            distrs.append(prev.distributions)
            trues.append(prev.true_classes)
            done = len(prev)
            if done >= nbr_datapoints:
                return prev
    t0 = time.time()
    base_key = jax.random.PRNGKey(cfg.seed)
    last_ckpt = 0
    metrics = None
    if cfg.metrics_path:
        from ..utils.metrics import MetricsLogger

        metrics = MetricsLogger(cfg.metrics_path)
    while done < nbr_datapoints:
        n = min(cfg.batch, nbr_datapoints - done)
        # key/seed derived from `done` so append=True resumes produce fresh,
        # non-duplicated samples
        k_err = jax.random.fold_in(base_key, done)
        states = sample_errors(spec, cfg, k_err)[:n]
        eq_true = np_eq_class(spec, states)
        distr, decide = _decode_with_retry(spec, cfg, states, cfg.seed + done,
                                           metrics, progress)
        if cfg.ckpt_dir:
            # the batch finished: drop its mid-decode checkpoint stream so a
            # later run with a changed config can't collide with it
            import shutil

            shutil.rmtree(
                f"{cfg.ckpt_dir}/batch_{cfg.seed + done}", ignore_errors=True
            )
        decisions = np.array([decide(d) for d in distr])
        failed += int((decisions != eq_true).sum())
        qms.append(states.reshape((n,) + spec.state_shape))
        distrs.append(distr)
        trues.append(eq_true.astype(np.int32))
        done += n
        if progress:
            progress(
                f"[generate] {done}/{nbr_datapoints} points, {failed} failed, "
                f"{time.time()-t0:.1f}s"
            )
        if file_path and done - last_ckpt >= cfg.checkpoint_every:
            _dataset(qms, distrs, trues, cfg).save(file_path)
            last_ckpt = done
        if cfg.fixed_errors is not None and failed >= cfg.fixed_errors:
            break
    ds = _dataset(qms, distrs, trues, cfg)
    if file_path:
        ds.save(file_path)
    return ds


def _dataset(qms, distrs, trues, cfg) -> Dataset:
    return Dataset(
        qubit_matrices=np.concatenate(qms) if qms else np.zeros((0,)),
        distributions=np.concatenate(distrs) if distrs else np.zeros((0, 0)),
        true_classes=np.concatenate(trues) if trues else np.zeros((0,), np.int32),
        config=cfg,
    )
