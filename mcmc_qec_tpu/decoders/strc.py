"""STRC: single-temperature ratio counting decoder (decoders.py:745-949).

Z estimate per class from occupancy statistics of a single-temperature
stream sampled at beta_sampling:

    mean_fraction = 0.5 * (N(l0)/m(l0)
                           + N(l1)/m(l1) * exp(-beta_s * (l1 - l0)))
    Z = mean_fraction * sum_n m(n) * exp(-beta_s * l0 + d_beta * n)

with l0/l1 the shortest/next-shortest observed lengths and d_beta =
beta_sampling - beta_error (decoders.py:860-863, 930-946).  Droplet merging
is the identity here because all droplets feed one stream (the combined
m(n)/N(n)/shortest sets equal the reference's dict merges,
decoders.py:883-928).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import CodeSpec
from ..mcmc.ladder import betas_depolarizing
from ..ops.pauli import all_class_states, apply_stabilizers_uniform
from .counting import SampleStream, make_sampler, occupancy_stats


def _strc_reduce(m_n, N_n, shortest, next_shortest, beta_s, beta_e, nq):
    """The STRC Z estimate from occupancy statistics (decoders.py:860-863,
    930-946); inputs have a (..., nq+1) length axis.  Shared by the
    materialized and streaming paths."""
    idx_k = jnp.arange(nq + 1, dtype=jnp.float32)
    l0 = shortest.astype(jnp.float32)
    l1 = next_shortest.astype(jnp.float32)

    def frac_at(N_n_, m_n_, l):
        li = jnp.clip(l.astype(jnp.int32), 0, nq)
        N = jnp.take_along_axis(N_n_, li[..., None], axis=-1)[..., 0]
        m = jnp.take_along_axis(m_n_, li[..., None], axis=-1)[..., 0]
        return N.astype(jnp.float32) / jnp.maximum(m.astype(jnp.float32), 1.0)

    sf = frac_at(N_n, m_n, l0)
    has_next = next_shortest <= nq
    nsf = frac_at(N_n, m_n, l1)
    mean_fraction = jnp.where(
        has_next,
        0.5 * (sf + nsf * jnp.exp(-beta_s * (l1 - l0))),
        sf,
    )
    d_beta = beta_s - beta_e
    # log of sum_n m(n) exp(-beta_s l0 + d_beta n), stably
    shape = (1,) * (m_n.ndim - 1) + (nq + 1,)
    logterm = jnp.where(
        m_n > 0,
        jnp.log(jnp.maximum(m_n.astype(jnp.float32), 1.0))
        + d_beta * idx_k.reshape(shape),
        -jnp.inf,
    )
    mx = jnp.max(logterm, axis=-1)
    logsum = mx + jnp.log(
        jnp.sum(jnp.exp(logterm - mx[..., None]), axis=-1)
    )
    logZ = jnp.log(jnp.maximum(mean_fraction, 1e-30)) - beta_s * l0 + logsum
    return jax.nn.softmax(logZ, axis=-1) * 100.0, logZ


@functools.lru_cache(maxsize=None)
def _get_strc_stream_fn(spec: CodeSpec, droplets: int, steps: int,
                        randomize: bool, conv_mult: float, engine: str,
                        capacity: int, window: int):
    """Bounded-memory STRC: per-length occupancy m(n) accumulates exactly
    in the scan carry; unique-per-length counts N(n) come from the
    streaming buffer ranked by total length, so they are exact for every
    n below the truncation rank — in particular at the shortest and
    next-shortest lengths the Z estimate uses (see
    streaming.occupancy_from_stream)."""
    from ..ops.engines import resolve_engine as _resolve

    engine = _resolve(engine, "counting", spec)
    iters = 5 if engine == "literal" else 1
    from .counting import make_sampler
    from .streaming import occupancy_from_stream, streaming_scan

    sampler = make_sampler(spec, window, iters_per_step=iters, engine=engine)
    nq = spec.nq

    def run(class_states, key, betas_sampling, beta_s, beta_e):
        B, K, _ = class_states.shape
        R = B * K
        states = jnp.broadcast_to(
            class_states[:, :, None, :], (B, K, droplets, nq)
        )
        k_rain, k_samp = jax.random.split(key)
        if randomize:
            states = apply_stabilizers_uniform(spec, states, k_rain, 0.5)
        states = states.reshape(R, droplets, nq)

        def chunk(states, k):
            states, stream = sampler(states, k, betas_sampling)
            return states, stream.keys, stream.n_xyz

        _, st, cm = streaming_scan(
            chunk, states, k_samp,
            steps=steps, window=window, capacity=capacity,
            rank_fn=lambda nx: jnp.sum(nx, axis=-1).astype(jnp.float32),
            nq=nq, R=R, D=droplets, conv_mult=conv_mult,
            track_occupancy=True,
        )
        kovf = (
            jnp.any(cm.kovf, axis=-1) if cm is not None
            else jnp.zeros((R,), bool)
        ).reshape(B, K)
        occ = occupancy_from_stream(st, nq)
        distr, logZ = _strc_reduce(
            occ.m_n.reshape(B, K, nq + 1), occ.N_n.reshape(B, K, nq + 1),
            occ.shortest.reshape(B, K), occ.next_shortest.reshape(B, K),
            beta_s, beta_e, nq,
        )
        # N(n) is exact only strictly below the truncation rank; the Z
        # estimate reads N at the shortest/next-shortest lengths, so flag
        # rows whose buffer truncated at or below next_shortest
        trunc_bad = (
            jnp.isfinite(occ.trunc_at)
            & (occ.trunc_at <= occ.next_shortest.astype(jnp.float32))
        ).reshape(B, K)
        return distr, logZ, trunc_bad, kovf

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _get_strc_fn(spec: CodeSpec, droplets: int, steps: int, randomize: bool,
                 conv_mult: float = 0.0, engine: str = "literal"):
    from ..ops.engines import resolve_engine

    engine = resolve_engine(engine, "counting", spec)
    iters = 5 if engine == "literal" else 1
    sampler = make_sampler(spec, steps, iters_per_step=iters, engine=engine)
    nq = spec.nq

    def run(class_states, key, betas_sampling, beta_s, beta_e):
        B, K, _ = class_states.shape
        states = jnp.broadcast_to(
            class_states[:, :, None, :], (B, K, droplets, nq)
        )
        k_rain, k_samp = jax.random.split(key)
        if randomize:
            states = apply_stabilizers_uniform(spec, states, k_rain, 0.5)
        _, stream = sampler(states, k_samp, betas_sampling)
        valid = None
        if conv_mult:
            from .counting import conv_mult_valid_mask

            n_tot = jnp.sum(stream.n_xyz, axis=-1).astype(jnp.float32)
            valid = jax.vmap(
                lambda k_, n_: conv_mult_valid_mask(k_, n_, conv_mult, steps)
            )(stream.keys.reshape(-1, steps, 2), n_tot.reshape(-1, steps))
            valid = valid.reshape(B, K, droplets * steps)
        stream = SampleStream(
            stream.keys.reshape(B, K, droplets * steps, 2),
            stream.n_xyz.reshape(B, K, droplets * steps, 3),
        )
        st = occupancy_stats(stream, nq, valid=valid)  # arrays (B, K, nq+1)
        return _strc_reduce(st.m_n, st.N_n, st.shortest, st.next_shortest,
                            beta_s, beta_e, nq)

    return jax.jit(run)


def STRC(
    spec: CodeSpec,
    init_states: np.ndarray,
    p_error: float,
    p_sampling: Optional[float] = None,
    droplets: int = 10,
    steps: int = 20000,
    seed: int = 0,
    conv_mult: float = 0.0,
    engine: str = "auto",
    stream: str = "auto",
    stream_capacity: int = 4096,
    stream_window: Optional[int] = None,
) -> np.ndarray:
    """Returns (B, K) float percentages (decoders.py:835-949).

    ``stream``: "auto" switches to the bounded-memory streaming reduction
    once the materialized sample stream would exceed ~1 GiB (see
    decoders/streaming.py); True/False force either path."""
    p_sampling = p_sampling or p_error
    randomize = init_states.ndim == 2
    if randomize:
        js = jnp.asarray(init_states, jnp.uint8)
        seeds = jax.vmap(lambda s: all_class_states(spec, s))(js)
    else:
        seeds = jnp.asarray(init_states, jnp.uint8)
    beta_e = float(betas_depolarizing(p_error)[0])
    beta_s = float(betas_depolarizing(p_sampling)[0])
    from .stdc import _pick_stream_window
    from .streaming import should_stream

    B, K = seeds.shape[0], seeds.shape[1]
    streaming = should_stream(stream, B * K, droplets, steps)
    if streaming:
        fn = _get_strc_stream_fn(
            spec, droplets, steps, randomize, conv_mult, engine,
            stream_capacity,
            stream_window or _pick_stream_window(droplets, steps),
        )
    else:
        fn = _get_strc_fn(spec, droplets, steps, randomize, conv_mult, engine)
    out = fn(
        seeds,
        jax.random.PRNGKey(seed),
        jnp.asarray(betas_depolarizing(p_sampling), jnp.float32),
        jnp.float32(beta_s),
        jnp.float32(beta_e),
    )
    if streaming:
        _warn_occupancy_truncation(np.asarray(out[2]), "STRC",
                                   stream_capacity)
        if conv_mult:
            from .streaming import warn_conv_mult_overflow

            warn_conv_mult_overflow(np.asarray(out[3]), "STRC",
                                    CONV_MULT_UNIQUE_CAP)
    return np.asarray(out[0])


def _warn_occupancy_truncation(trunc_bad: np.ndarray, name: str,
                               capacity: int) -> None:
    """Streaming occupancy keeps only the ``capacity`` shortest unique
    chains per row; if that buffer truncated at or below the
    next-shortest length, the Z estimate's N(l0)/N(l1) undercount.  The
    results are then biased, not silently — warn with the row count."""
    bad = int(trunc_bad.sum())
    if bad:
        import warnings

        warnings.warn(
            f"{name}: occupancy buffer (stream_capacity={capacity}) "
            f"truncated at/below the next-shortest length in {bad} "
            f"(row, class) cells — unique counts there undercount; "
            f"raise stream_capacity or use stream=False",
            RuntimeWarning,
            stacklevel=3,
        )
