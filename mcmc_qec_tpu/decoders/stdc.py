"""STDC: single-temperature direct counting decoders.

Batched redesign of STDC / STDC_general_noise / STDC_general_noise_shortest
/ STDC_Nall_n_alpha (decoders.py:236-581): for every syndrome, all
(class x droplet) chains run in one batched Metropolis kernel at the
sampling temperature, visits are recorded as on-device content keys, and
Z_E = sum over unique chains of exp(-beta_err . n_xyz) is computed with a
lexsort + segment logsumexp — no host dicts, no process pools
(decoders.py:301-314).

All four reference variants collapse into one engine because both the
sampling acceptance and the error-model weights are vector-beta forms:
 - STDC:                    betas_sampling = betas_err = depolarizing
 - STDC (p_sampling):       betas_sampling = depolarizing(p_sampling)
 - STDC_general_noise:      vector betas (scalar p_sampling -> equal betas,
                            matching the Chain vs Chain_xyz dispatch at
                            decoders.py:351-354)
 - STDC_Nall_n_alpha:       betas_sampling = alpha form; betas_err =
                            (alpha*b, alpha*b, b), b = -ln pz_tilde
                            (decoders.py:537-581)
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import CodeSpec
from ..mcmc.ladder import betas_depolarizing, betas_xyz
from ..ops.engines import resolve_engine
from ..ops.pauli import all_class_states, apply_stabilizers_uniform
from .counting import make_sampler, z_direct_count


@functools.lru_cache(maxsize=None)
def _get_stdc_fn(spec: CodeSpec, droplets: int, steps: int, randomize: bool,
                 shortest_mode: str, conv_mult: float = 0.0,
                 engine: str = "literal", with_stats: bool = False):
    """shortest_mode: "off" (full Z), "only" (shortest-truncated Z) or
    "both" (full + shortest from one sampled stream, decoders.py:490-505).
    Bools are accepted for backward compatibility (False="off", True="only").

    ``with_stats`` additionally returns unique-discovery saturation stats
    per (B, K): (unique_total, unique_by_halftime) — a saturated stream
    discovers ~nothing in its second half, the convergence diagnostic for
    direct counting."""
    if isinstance(shortest_mode, bool):
        shortest_mode = "only" if shortest_mode else "off"
    engine = resolve_engine(engine, "counting", spec)
    iters = 5 if engine == "literal" else 1
    sampler = make_sampler(spec, steps, iters_per_step=iters, engine=engine)

    def run(class_states, key, betas_sampling, betas_error):
        # class_states: (B, K, nq)
        B, K, nq = class_states.shape
        states = jnp.broadcast_to(
            class_states[:, :, None, :], (B, K, droplets, nq)
        )
        k_rain, k_samp = jax.random.split(key)
        if randomize:
            # start each droplet in an independent high-energy state ("rain",
            # decoders.py:244-246)
            states = apply_stabilizers_uniform(spec, states, k_rain, 0.5)
        states, stream = sampler(states, k_samp, betas_sampling)
        from .counting import SampleStream, conv_mult_valid_mask

        valid = None
        if conv_mult:
            # per-droplet early-stop mask (decoders.py:249-263)
            n_tot = jnp.sum(stream.n_xyz, axis=-1).astype(jnp.float32)
            flat_k = stream.keys.reshape(-1, steps, 2)
            flat_n = n_tot.reshape(-1, steps)
            valid = jax.vmap(
                lambda k_, n_: conv_mult_valid_mask(k_, n_, conv_mult, steps)
            )(flat_k, flat_n).reshape(B, K, droplets * steps)
        # merge droplets into one stream per (B, K): reshape so the sample
        # axis spans droplets x steps
        keys_ = stream.keys.reshape(B, K, droplets * steps, 2)
        nxyz = stream.n_xyz.reshape(B, K, droplets * steps, 3)
        merged = SampleStream(keys_, nxyz)

        stats = ()
        if with_stats:
            from .counting import chronological_first_occurrence

            n_samp = droplets * steps

            def disc(keys_one):
                first = chronological_first_occurrence(keys_one)
                t = jnp.arange(n_samp)
                # half-time = the first half of each droplet's own steps
                # (the merged axis is droplet-major) — the saturation
                # diagnostic asks about TIME, matching the streaming
                # path's halfway snapshot
                half = (t % steps) < steps // 2
                return first.sum(), (first & half).sum()

            u_tot, u_half = jax.vmap(disc)(keys_.reshape(-1, n_samp, 2))
            stats = ((u_tot.reshape(B, K), u_half.reshape(B, K)),)

        # normalized percentages via stable softmax (== Z/sum Z * 100,
        # decoders.py:322)
        if shortest_mode == "both":
            logz, logz_s = z_direct_count(merged, betas_error,
                                          valid=valid, with_shortest=True)
            return ((jax.nn.softmax(logz, axis=-1) * 100.0,
                     jax.nn.softmax(logz_s, axis=-1) * 100.0), logz) + stats
        logz = z_direct_count(merged, betas_error,
                              shortest_only=(shortest_mode == "only"),
                              valid=valid)  # (B, K)
        distr = jax.nn.softmax(logz, axis=-1) * 100.0
        return (distr, logz) + stats

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _get_stdc_stream_fn(spec: CodeSpec, droplets: int, steps: int,
                        randomize: bool, shortest_mode: str,
                        conv_mult: float, engine: str, with_stats: bool,
                        capacity: int, window: int):
    """Streaming (bounded-memory) variant of ``_get_stdc_fn``: instead of
    materializing the (B, K, droplets*steps) sample stream in HBM, every
    window of samples is sort-merged into a per-(B, K) bounded buffer of
    the ``capacity`` lowest-weight unique chains (decoders/streaming.py) —
    peak memory is independent of ``steps``, so the reference's default
    budget (droplets=10 x steps=20000, decoders.py:268) runs at production
    batch and d.  Z is exact whenever the buffer never overflows;
    otherwise only chains with Boltzmann weight < exp(-max_kept) are
    dropped (see streaming.py's invariant)."""
    if isinstance(shortest_mode, bool):
        shortest_mode = "only" if shortest_mode else "off"
    engine = resolve_engine(engine, "counting", spec)
    iters = 5 if engine == "literal" else 1
    from .counting import _weighted_length
    from .streaming import logz_from_stream, streaming_scan

    def run(class_states, key, betas_sampling, betas_error):
        B, K, nq = class_states.shape
        R = B * K
        states = jnp.broadcast_to(
            class_states[:, :, None, :], (B, K, droplets, nq)
        )
        k_rain, k_samp = jax.random.split(key)
        if randomize:
            states = apply_stabilizers_uniform(spec, states, k_rain, 0.5)
        states = states.reshape(R, droplets, nq)

        from .counting import make_sampler

        sampler = make_sampler(spec, window, iters_per_step=iters,
                               engine=engine)

        def chunk(states, k):
            states, stream = sampler(states, k, betas_sampling)
            return states, stream.keys, stream.n_xyz

        _, st, cm = streaming_scan(
            chunk, states, k_samp,
            steps=steps, window=window, capacity=capacity,
            rank_fn=lambda nxyz: _weighted_length(nxyz, betas_error),
            nq=nq, R=R, D=droplets, conv_mult=conv_mult,
            track_occupancy=False,
        )
        kovf = (
            jnp.any(cm.kovf, axis=-1) if cm is not None
            else jnp.zeros((R,), bool)
        ).reshape(B, K)
        stats = ()
        if with_stats:
            # overflow accompanies the saturation counts: after eviction,
            # re-discovered chains re-count, so (u_tot, u_half) overstate
            # saturation on overflowed rows (ADVICE r4)
            stats = ((st.n_unique.reshape(B, K),
                      st.n_unique_half.reshape(B, K),
                      st.overflow.reshape(B, K)),)
        min_rank = jnp.min(
            jnp.where(jnp.isfinite(st.r), st.r, jnp.inf), axis=-1
        ).reshape(B, K)
        extras = (st.overflow.reshape(B, K), st.max_kept.reshape(B, K),
                  min_rank, kovf)
        if shortest_mode == "both":
            logz, logz_s = logz_from_stream(st, with_shortest=True)
            logz = logz.reshape(B, K)
            logz_s = logz_s.reshape(B, K)
            return ((jax.nn.softmax(logz, axis=-1) * 100.0,
                     jax.nn.softmax(logz_s, axis=-1) * 100.0),
                    logz) + stats + extras
        logz = logz_from_stream(
            st, shortest_only=(shortest_mode == "only")
        ).reshape(B, K)
        distr = jax.nn.softmax(logz, axis=-1) * 100.0
        return (distr, logz) + stats + extras

    return jax.jit(run)


def _pick_stream_window(droplets: int, steps: int) -> int:
    """Window size so each merge folds ~4k candidates (sort efficiency)
    without exceeding the step budget."""
    return int(np.clip(4096 // max(droplets, 1), 64, max(steps, 64)))


def stdc_run(
    spec: CodeSpec,
    class_states: np.ndarray,  # (B, K, nq) per-class seeds
    betas_sampling: np.ndarray,  # (3,)
    betas_error: np.ndarray,  # (3,)
    droplets: int = 10,
    steps: int = 20000,
    randomize: bool = True,
    shortest_only: bool = False,
    seed: int = 0,
    conv_mult: float = 0.0,
    engine: str = "auto",
    shortest_mode: Optional[str] = None,
    metrics=None,
    stream: str = "auto",
    stream_capacity: int = 4096,
    stream_window: Optional[int] = None,
):
    mode = shortest_mode or ("only" if shortest_only else "off")
    from .streaming import should_stream

    B, K = class_states.shape[0], class_states.shape[1]
    streaming = should_stream(stream, B * K, droplets, steps)
    if streaming:
        fn = _get_stdc_stream_fn(
            spec, droplets, steps, randomize, mode, conv_mult, engine,
            metrics is not None, stream_capacity,
            stream_window or _pick_stream_window(droplets, steps),
        )
    else:
        fn = _get_stdc_fn(spec, droplets, steps, randomize, mode,
                          conv_mult, engine, with_stats=metrics is not None)
    key = jax.random.PRNGKey(seed)
    out = fn(
        jnp.asarray(class_states, jnp.uint8),
        key,
        jnp.asarray(betas_sampling, jnp.float32),
        jnp.asarray(betas_error, jnp.float32),
    )
    distr, logz = out[0], out[1]
    overflow = None
    if streaming:
        from .streaming import warn_conv_mult_overflow, warn_stream_overflow

        overflow, max_kept, min_rank, kovf = out[-4:]
        warn_stream_overflow(np.asarray(overflow), np.asarray(max_kept),
                             np.asarray(min_rank), droplets * steps,
                             "STDC", stream_capacity)
        if conv_mult:
            from .streaming import CONV_MULT_UNIQUE_CAP

            warn_conv_mult_overflow(np.asarray(kovf), "STDC",
                                    CONV_MULT_UNIQUE_CAP)
    if metrics is not None:
        u_tot, u_half = [np.asarray(a) for a in out[2][:2]]
        late = (u_tot - u_half) / np.maximum(u_tot, 1)  # second-half share
        metrics.log(
            "stdc_run",
            n_samples=droplets * steps,
            droplets=droplets,
            unique_mean=float(u_tot.mean()),
            unique_min=int(u_tot.min()),
            unique_max=int(u_tot.max()),
            late_discovery_mean=float(late.mean()),
            late_discovery_max=float(late.max()),
            # saturation stats overstate on overflowed rows (re-discovered
            # evicted chains re-count) — consumers discount via this flag
            overflow_rows=int(np.asarray(overflow).sum())
            if overflow is not None else 0,
        )
    if mode == "both":
        return (np.asarray(distr[0]), np.asarray(distr[1])), np.asarray(logz)
    return np.asarray(distr), np.asarray(logz)


def _class_seeds(spec: CodeSpec, init_states: np.ndarray) -> np.ndarray:
    """(B, nq) -> (B, K, nq) one seed per equivalence class (the vectorized
    to_class loop of decoders.py:285-288)."""
    if init_states.ndim == 3:
        return init_states  # already per-class (mwpm warm start)
    js = jnp.asarray(init_states, jnp.uint8)
    return np.asarray(jax.vmap(lambda s: all_class_states(spec, s))(js))


def STDC(
    spec: CodeSpec,
    init_states: np.ndarray,
    p_error: float,
    p_sampling: Optional[float] = None,
    droplets: int = 10,
    steps: int = 20000,
    seed: int = 0,
    conv_mult: float = 0.0,
    engine: str = "auto",
    metrics=None,
    stream: str = "auto",
    stream_capacity: int = 4096,
) -> np.ndarray:
    """Depolarizing STDC (decoders.py:268-322).  ``init_states`` is (B, nq)
    (random start; droplets are rained) or (B, K, nq) warm starts (no rain,
    decoders.py:277-279).  Returns (B, K) float percentages.

    ``stream``: "auto" switches to the bounded-memory streaming reduction
    once the materialized sample stream would exceed ~1 GiB, so the
    reference-default budget (droplets=10 x steps=20000) runs at any batch
    size; True/False force either path."""
    p_sampling = p_sampling or p_error
    randomize = init_states.ndim == 2
    seeds = _class_seeds(spec, init_states)
    distr, _ = stdc_run(
        spec,
        seeds,
        betas_depolarizing(p_sampling),
        betas_depolarizing(p_error),
        droplets,
        steps,
        randomize,
        seed=seed,
        conv_mult=conv_mult,
        engine=engine,
        metrics=metrics,
        stream=stream,
        stream_capacity=stream_capacity,
    )
    return distr


def _general_noise_betas(p_xyz, p_sampling):
    """(betas_sampling, betas_error) for the general-noise variants.

    ``p_sampling`` may be a scalar (depolarizing sampling chain) or a
    length-3 array (xyz sampling chain), matching the reference's
    Chain/Chain_xyz dispatch (decoders.py:351-354)."""
    if p_sampling is None:
        p_sampling = float(np.sum(p_xyz))
    if np.ndim(p_sampling) == 0:
        bs = betas_depolarizing(float(p_sampling))
    else:
        bs = betas_xyz(*np.asarray(p_sampling))
    # beta_err = -ln((p_i/3)/(1-p_i)) per reference (decoders.py:389)
    p_xyz = np.asarray(p_xyz, dtype=np.float64)
    with np.errstate(divide="ignore"):
        be = -np.log((p_xyz / 3.0) / (1.0 - p_xyz))
    be = np.where(np.isfinite(be), be, 1e30)
    return bs, be


def STDC_general_noise(
    spec: CodeSpec,
    init_states: np.ndarray,
    p_xyz: np.ndarray,
    p_sampling=None,
    droplets: int = 10,
    steps: int = 20000,
    shortest_only: bool = False,
    seed: int = 0,
    engine: str = "auto",
    stream: str = "auto",
) -> np.ndarray:
    """General-noise STDC (decoders.py:345-432)."""
    bs, be = _general_noise_betas(p_xyz, p_sampling)
    # the reference never rains the general-noise chains (decoders.py:365-376
    # sets randomize=False in both init branches)
    seeds = _class_seeds(spec, init_states)
    distr, _ = stdc_run(
        spec, seeds, bs, be, droplets, steps, False, shortest_only, seed,
        engine=engine, stream=stream,
    )
    return distr


def STDC_general_noise_shortest(
    spec: CodeSpec,
    init_states: np.ndarray,
    p_xyz: np.ndarray,
    p_sampling=None,
    droplets: int = 10,
    steps: int = 20000,
    seed: int = 0,
    engine: str = "auto",
    stream: str = "auto",
):
    """Returns (full distribution, shortest-only distribution), both reduced
    from ONE sampled stream — exactly the reference's single-pass structure
    (decoders.py:490-505: both Z's come from the same samples dict)."""
    bs, be = _general_noise_betas(p_xyz, p_sampling)
    seeds = _class_seeds(spec, init_states)
    (full, short), _ = stdc_run(
        spec, seeds, bs, be, droplets, steps, False, seed=seed,
        shortest_mode="both", engine=engine, stream=stream,
    )
    return full, short


def STDC_Nall_n_alpha(
    spec: CodeSpec,
    init_states: np.ndarray,
    pz_tilde_sampling: float,
    alpha: float,
    pz_tilde: float,
    droplets: int = 1,
    steps: int = 20000,
    seed: int = 0,
    engine: str = "auto",
    stream: str = "auto",
) -> np.ndarray:
    """Alpha-noise STDC on n_eff = n_z + alpha (n_x + n_y)
    (decoders.py:510-581): sampling runs at the alpha acceptance for
    pz_tilde_sampling, weights use beta = -ln(pz_tilde)."""
    b_s = -np.log(pz_tilde_sampling)
    bs = np.array([alpha * b_s, alpha * b_s, b_s])
    b_e = -np.log(pz_tilde)
    be = np.array([alpha * b_e, alpha * b_e, b_e])
    # no rain: STDC_droplet_alpha never randomizes (decoders.py:520-536)
    seeds = _class_seeds(spec, init_states)
    distr, _ = stdc_run(spec, seeds, bs, be, droplets, steps, False,
                        seed=seed, engine=engine, stream=stream)
    return distr
