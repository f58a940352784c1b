"""PTDC / PTRC: parallel-tempering sampled counting decoders
(decoders.py:138-233, 584-742).

Like STDC/STRC but samples come from a full PT ladder per class — every rung
contributes observations each step (decoders.py:146-153, 597-623), and the
step budget is divided by Nc (decoders.py:199, 669).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import CodeSpec
from ..mcmc.ladder import (
    beta_ladder_depolarizing,
    betas_depolarizing,
    init_ladder,
)
from ..ops.pauli import all_class_states
from .counting import SampleStream, occupancy_stats, z_direct_count


@functools.lru_cache(maxsize=None)
def _get_pt_sampler(spec: CodeSpec, Nc: int, steps: int, iters: int,
                    engine: str = "literal"):
    """Sampler over (B*K) ladders recording every rung each step.

    Uses the permutation-carrying ladder step (mcmc/ladder.py
    make_perm_ladder_step): rung swaps move indices, not (N, Nc, nq)
    state rows, and the per-step records come out in rung order via small
    gathers — the r4 step's full-state take_along_axis per step was the
    dominant non-sweep cost of PTDC/PTRC (VERDICT r4 #3/#7)."""
    from ..ops.engines import resolve_engine
    from ..mcmc.ladder import make_perm_ladder_step, perm_enter

    engine = resolve_engine(engine, "counting", spec)
    ladder_step = make_perm_ladder_step(spec, Nc, iters, engine=engine)

    def run(ls_state, ls_flag, ls_tops, key, betas_ladder):
        from ..mcmc.ladder import LadderState

        pls = perm_enter(LadderState(ls_state, ls_flag, ls_tops))

        def body(carry, k):
            pls = carry
            pls, keys_, nxyz, _ = ladder_step(pls, k, betas_ladder)
            return pls, (keys_, nxyz)

        ks = jax.random.split(key, steps)
        _, (keys_, nxyz) = jax.lax.scan(body, pls, ks)
        # (steps, N, Nc, .) -> (N, Nc, steps, .)
        keys_ = jnp.moveaxis(keys_, 0, 2)
        nxyz = jnp.moveaxis(nxyz, 0, 2)
        return keys_, nxyz

    return jax.jit(run)


def _pt_iters(engine: str) -> int:
    """Updates per recorded ladder step.  The reference records every
    ladder step, each being iters=10 single-stabilizer proposals per rung
    (decoders.py:146-153, mcmc.py:94); one colored sweep is 2d^2 proposals
    per rung, so the sweep/kernel engines record after ONE sweep — the
    same convention as counting.make_sampler (round-3 PTDC/PTRC ran 10
    full sweeps per recorded sample, ~10x the needed decorrelation work)."""
    return 10 if engine == "literal" else 1


def _pt_seeds(spec: CodeSpec, init_states: np.ndarray):
    if init_states.ndim == 2:
        js = jnp.asarray(init_states, jnp.uint8)
        return jax.vmap(lambda s: all_class_states(spec, s))(js)  # (B,K,nq)
    return jnp.asarray(init_states, jnp.uint8)


def _pt_stream(
    spec: CodeSpec,
    init_states: np.ndarray,
    p_sampling: float,
    Nc: int,
    steps: int,
    droplets: int,
    iters: int,
    seed: int,
    engine: str = "auto",
):
    """Run droplet PT ladders for every (syndrome, class); returns streams
    with axes (B, K, Nc, droplets*steps)."""
    seeds = _pt_seeds(spec, init_states)
    B, K, nq = seeds.shape
    flat = jnp.broadcast_to(
        seeds[:, :, None, :], (B, K, droplets, nq)
    ).reshape(B * K * droplets, nq)
    ls = init_ladder(spec, flat, Nc)
    sampler = _get_pt_sampler(spec, Nc, steps, iters, engine)
    ladder = beta_ladder_depolarizing(p_sampling, Nc)
    keys_, nxyz = sampler(
        ls.state, ls.flag, ls.tops0, jax.random.PRNGKey(seed),
        jnp.asarray(ladder, jnp.float32),
    )
    # (B*K*D, Nc, steps, .) -> (B, K, Nc, D*steps, .)
    keys_ = keys_.reshape(B, K, droplets, Nc, steps, 2)
    nxyz = nxyz.reshape(B, K, droplets, Nc, steps, 3)
    keys_ = jnp.moveaxis(keys_, 2, 3).reshape(B, K, Nc, droplets * steps, 2)
    nxyz = jnp.moveaxis(nxyz, 2, 3).reshape(B, K, Nc, droplets * steps, 3)
    return SampleStream(keys_, nxyz), ladder


@functools.lru_cache(maxsize=None)
def _get_pt_stream_scan_fn(spec: CodeSpec, Nc: int, steps: int, window: int,
                           iters: int, engine: str, droplets: int,
                           capacity: int, per_rung: bool, B: int, K: int):
    """Streaming PT sampler: the ladder advances window by window and every
    rung's visits are folded into bounded buffers on the fly (see
    decoders/streaming.py) — no (B, K, Nc, droplets*steps) stream in HBM.

    per_rung=False (PTDC): one buffer per (B, K), all rungs and droplets
    merged, rank = Boltzmann weight at beta_error (passed to run).
    per_rung=True (PTRC): one buffer per (B, K, Nc) ranked by total
    length, plus exact per-length occupancy counts."""
    from ..ops.engines import resolve_engine
    from ..mcmc.ladder import make_perm_ladder_step, perm_enter
    from .streaming import streaming_scan

    eng = resolve_engine(engine, "counting", spec)
    ladder_step = make_perm_ladder_step(spec, Nc, iters, engine=eng)
    nq = spec.nq

    def run(ls_state, ls_flag, ls_tops, key, betas_ladder, betas_error):
        from ..mcmc.ladder import LadderState

        pls0 = perm_enter(LadderState(ls_state, ls_flag, ls_tops))
        N = ls_state.shape[0]  # B * K * droplets

        def chunk(pls, k):
            def body(carry, kk):
                pls = carry
                pls, keys_, nxyz, _ = ladder_step(pls, kk, betas_ladder)
                return pls, (keys_, nxyz)

            ks = jax.random.split(k, window)
            pls, (keys_, nxyz) = jax.lax.scan(body, pls, ks)
            # (W, N, Nc, .) with N = B*K*droplets
            keys_ = keys_.reshape(window, B, K, droplets, Nc, 2)
            nxyz = nxyz.reshape(window, B, K, droplets, Nc, 3)
            if per_rung:
                # rows (B*K*Nc), droplet axis = droplets
                keys_ = jnp.transpose(keys_, (1, 2, 4, 3, 0, 5)).reshape(
                    B * K * Nc, droplets, window, 2
                )
                nxyz = jnp.transpose(nxyz, (1, 2, 4, 3, 0, 5)).reshape(
                    B * K * Nc, droplets, window, 3
                )
            else:
                # rows (B*K), droplet axis = droplets*Nc
                keys_ = jnp.transpose(keys_, (1, 2, 3, 4, 0, 5)).reshape(
                    B * K, droplets * Nc, window, 2
                )
                nxyz = jnp.transpose(nxyz, (1, 2, 3, 4, 0, 5)).reshape(
                    B * K, droplets * Nc, window, 3
                )
            return pls, keys_, nxyz

        if per_rung:
            R, D = B * K * Nc, droplets
            rank_fn = lambda nx: jnp.sum(nx, axis=-1).astype(jnp.float32)
        else:
            R, D = B * K, droplets * Nc
            from .counting import _weighted_length

            rank_fn = lambda nx: _weighted_length(nx, betas_error)
        _, st, _ = streaming_scan(
            chunk, pls0, key,
            steps=steps, window=window, capacity=capacity,
            rank_fn=rank_fn, nq=nq, R=R, D=D,
            track_occupancy=per_rung,
        )
        return st

    return jax.jit(run)


def PTDC(
    spec: CodeSpec,
    init_states: np.ndarray,
    p_error: float,
    p_sampling: Optional[float] = None,
    droplets: int = 4,
    Nc: Optional[int] = None,
    steps: int = 20000,
    seed: int = 0,
    engine: str = "auto",
    stream: str = "auto",
    stream_capacity: int = 4096,
    stream_window: int = 256,
    conv_mult: float = 0.0,
) -> np.ndarray:
    """Direct counting over PT samples (decoders.py:168-233).  All rungs'
    visits enter one unique-chain set per class; Z = sum_unique
    exp(-beta_err n).  Returns uint8 percentages like the reference
    (decoders.py:233).

    ``stream``: "auto" switches to the bounded-memory streaming reduction
    once the materialized stream would exceed ~1 GiB.

    ``conv_mult``: the shortest-chain extension rule over each droplet
    ladder's combined rung stream (decoders.py:156-161; reference default
    0 = off).  The rule's step index is the *outer* ladder step (all Nc
    rung visits of a step share it).  Runs on the materialized path
    (conv_mult forces it)."""
    p_sampling = p_sampling or p_error
    Nc = Nc or spec.size
    steps_eff = steps // Nc
    iters = _pt_iters(engine)
    be = jnp.asarray(betas_depolarizing(p_error), jnp.float32)
    seeds = _pt_seeds(spec, init_states)
    B, K = seeds.shape[:2]
    from .streaming import should_stream

    use_stream = should_stream(stream, B * K, droplets * Nc, steps_eff)
    if conv_mult:
        # the conv_mult automaton needs the chronological per-droplet
        # stream; the bounded-memory path does not carry one per droplet
        # across rungs, so the materialized reduction is used
        use_stream = False
    if use_stream:
        from .streaming import logz_from_stream

        nq = spec.nq
        flat = jnp.broadcast_to(
            seeds[:, :, None, :], (B, K, droplets, nq)
        ).reshape(B * K * droplets, nq)
        ls = init_ladder(spec, flat, Nc)
        fn = _get_pt_stream_scan_fn(
            spec, Nc, steps_eff, min(stream_window, steps_eff), iters,
            engine, droplets, stream_capacity, False, B, K,
        )
        ladder = beta_ladder_depolarizing(p_sampling, Nc)
        st = fn(ls.state, ls.flag, ls.tops0, jax.random.PRNGKey(seed),
                jnp.asarray(ladder, jnp.float32), be)
        from .streaming import warn_stream_overflow

        overflow = np.asarray(st.overflow)
        if overflow.any():
            # min_rank reduced on-device: fetching st.r itself would move
            # the whole (R, capacity) buffer to the host
            min_rank = np.asarray(
                jax.jit(
                    lambda r: jnp.min(
                        jnp.where(jnp.isfinite(r), r, jnp.inf), axis=-1
                    )
                )(st.r)
            )
            warn_stream_overflow(overflow, np.asarray(st.max_kept),
                                 min_rank, droplets * Nc * steps_eff,
                                 "PTDC", stream_capacity)
        logz = logz_from_stream(st).reshape(B, K)
    else:
        stream_s, _ = _pt_stream(
            spec, init_states, p_sampling, Nc, steps_eff, droplets, iters,
            seed, engine,
        )
        valid = None
        if conv_mult:
            from .counting import conv_mult_valid_mask

            # rebuild the chronological per-droplet stream (step-major,
            # rung-minor — the reference records every rung within a step
            # before advancing, decoders.py:146-153) and gate it
            k5 = stream_s.keys.reshape(B, K, Nc, droplets, steps_eff, 2)
            n5 = stream_s.n_xyz.reshape(B, K, Nc, droplets, steps_eff, 3)
            kc = jnp.transpose(k5, (0, 1, 3, 4, 2, 5)).reshape(
                B * K * droplets, steps_eff * Nc, 2
            )
            nc_ = jnp.transpose(n5, (0, 1, 3, 4, 2, 5)).reshape(
                B * K * droplets, steps_eff * Nc, 3
            )
            ntot = jnp.sum(nc_, -1).astype(jnp.float32)
            t_idx = jnp.repeat(
                jnp.arange(steps_eff), Nc
            ).astype(jnp.float32)
            # the break may only fire after a step's LAST rung visit
            # (decoders.py:156-161: all rungs recorded, stop possibly
            # extended, THEN the break check)
            se = jnp.tile(
                jnp.arange(Nc) == Nc - 1, steps_eff
            )
            valid = jax.vmap(
                lambda k_, n_: conv_mult_valid_mask(
                    k_, n_, conv_mult, steps_eff, t=t_idx, step_end=se
                )
            )(kc, ntot).reshape(B, K, droplets * steps_eff * Nc)
            merged = SampleStream(
                kc.reshape(B, K, -1, 2), nc_.reshape(B, K, -1, 3)
            )
        else:
            # merge rung axis into the sample axis: dedup across the
            # whole ladder
            merged = SampleStream(
                stream_s.keys.reshape(B, K, -1, 2),
                stream_s.n_xyz.reshape(B, K, -1, 3),
            )
        logz = z_direct_count(merged, be, valid=valid)
    distr = jax.nn.softmax(logz, axis=-1) * 100.0
    return np.asarray(distr).astype(np.uint8)


@functools.partial(jax.jit, static_argnames=("nq",))
def _ptrc_reduce(m_n, N_n, shortest, next_shortest, beta_ladder, beta_err,
                 nq: int):
    """On-device log-space PTRC reduction over rungs and lengths.

    Inputs have axes (B, K, Nc, [nq+1]); the top rung (infinite
    temperature) is excluded like the reference (decoders.py:726).
    Working in log space (logsumexp over lengths, then over rungs) keeps
    the whole reduction in f32 on the accelerator — the previous
    host-side version needed f64 + exponent clipping because it summed
    raw Boltzmann terms.  softmax(logZ) == Z / sum(Z) exactly."""
    m = m_n[..., :-1, :].astype(jnp.float32)  # (B, K, R, nq+1)
    N = N_n[..., :-1, :].astype(jnp.float32)
    l0 = shortest[..., :-1].astype(jnp.float32)  # (B, K, R)
    l1 = next_shortest[..., :-1].astype(jnp.float32)
    bl = beta_ladder[:-1]  # (R,)
    db = bl - beta_err

    def take(arr, idx):
        return jnp.take_along_axis(
            arr, jnp.clip(idx.astype(jnp.int32), 0, nq)[..., None], axis=-1
        )[..., 0]

    c0 = take(N, l0) / jnp.maximum(take(m, l0), 1.0)
    c1 = (
        take(N, l1) / jnp.maximum(take(m, l1), 1.0)
        * jnp.exp(-bl * jnp.maximum(l1 - l0, 0.0))
    )
    C = jnp.where(l1 <= nq, 0.5 * (c0 + c1), c0)
    ns = jnp.arange(nq + 1, dtype=jnp.float32)
    logm = jnp.where(m > 0, jnp.log(jnp.maximum(m, 1e-30)), -jnp.inf)
    expo = (
        ns * db[None, None, :, None]
        - (bl * l0)[..., None]
        + logm
    )
    logZ_i = jnp.log(jnp.maximum(C, 1e-30)) + jax.nn.logsumexp(expo, axis=-1)
    logZ_i = jnp.where((l0 <= nq) & (C > 0), logZ_i, -jnp.inf)
    logZ = jax.nn.logsumexp(logZ_i, axis=-1)  # (B, K)
    any_fin = jnp.isfinite(logZ).any(axis=-1, keepdims=True)
    logZ_safe = jnp.where(jnp.isfinite(logZ), logZ, -1e30)
    return jnp.where(
        any_fin, jax.nn.softmax(logZ_safe, axis=-1) * 100.0, 0.0
    )


def PTRC(
    spec: CodeSpec,
    init_states: np.ndarray,
    p_error: float,
    p_sampling: Optional[float] = None,
    droplets: int = 4,
    Nc: Optional[int] = None,
    steps: int = 20000,
    seed: int = 0,
    engine: str = "auto",
    stream: str = "auto",
    stream_capacity: int = 2048,
    stream_window: int = 256,
    conv_mult: float = 2.0,
) -> np.ndarray:
    """Ratio counting over PT samples (decoders.py:638-742): per rung i
    (except the top),

        C_i    = mean over the two shortest lengths of
                 N(l)/m(l) * exp(-beta_i (l - l_min))        (decoders.py:734)
        Z_i    = C_i * sum_n m(n) exp(n d_beta_i - beta_i l_min)
                                                            (decoders.py:737)
        Z_eq   = sum_i Z_i

    with beta_i from the p-ladder and d_beta_i = beta_i - beta_error.
    The reduction runs on-device in log space (no (B, K, Nc, nq+1) host
    fetch; scales to large batch x Nc).  Returns uint8 percentages
    (decoders.py:742).

    ``conv_mult`` is accepted for signature parity (reference default
    2.0) but is a no-op, exactly as in the reference: PTRC_droplet
    updates the stop point yet its break is commented out
    (decoders.py:626-631), so every sample is recorded regardless."""
    del conv_mult  # dead knob in the reference too (decoders.py:631)
    p_sampling = p_sampling or p_error
    Nc = Nc or spec.size
    steps_eff = steps // Nc
    iters = _pt_iters(engine)
    nq = spec.nq
    seeds = _pt_seeds(spec, init_states)
    B, K = seeds.shape[:2]
    from .streaming import should_stream

    if should_stream(stream, B * K, droplets * Nc, steps_eff):
        from .streaming import occupancy_from_stream

        flat = jnp.broadcast_to(
            seeds[:, :, None, :], (B, K, droplets, nq)
        ).reshape(B * K * droplets, nq)
        ls = init_ladder(spec, flat, Nc)
        ladder = beta_ladder_depolarizing(p_sampling, Nc)
        fn = _get_pt_stream_scan_fn(
            spec, Nc, steps_eff, min(stream_window, steps_eff), iters,
            engine, droplets, stream_capacity, True, B, K,
        )
        st_s = fn(ls.state, ls.flag, ls.tops0, jax.random.PRNGKey(seed),
                  jnp.asarray(ladder, jnp.float32),
                  jnp.zeros((3,), jnp.float32))
        occ = occupancy_from_stream(st_s, nq)
        m_n = occ.m_n.reshape(B, K, Nc, nq + 1)
        N_n = occ.N_n.reshape(B, K, Nc, nq + 1)
        shortest = occ.shortest.reshape(B, K, Nc)
        next_shortest = occ.next_shortest.reshape(B, K, Nc)
        from .strc import _warn_occupancy_truncation

        trunc_bad = (
            np.isfinite(np.asarray(occ.trunc_at))
            & (np.asarray(occ.trunc_at)
               <= np.asarray(occ.next_shortest, np.float32))
        ).reshape(B, K, Nc)
        # the top (infinite-temperature) rung is excluded from the
        # reduction (decoders.py:726) — don't warn about it
        _warn_occupancy_truncation(trunc_bad[..., :-1], "PTRC",
                                   stream_capacity)
    else:
        stream_s, ladder = _pt_stream(
            spec, init_states, p_sampling, Nc, steps_eff, droplets, iters,
            seed, engine,
        )
        st = occupancy_stats(stream_s, nq)  # (B, K, Nc, nq+1)
        m_n, N_n = st.m_n, st.N_n
        shortest, next_shortest = st.shortest, st.next_shortest
    beta_err = betas_depolarizing(p_error)[0]
    distr = _ptrc_reduce(
        m_n, N_n, shortest, next_shortest,
        jnp.asarray(ladder[:, 0], jnp.float32), jnp.float32(beta_err),
        nq,
    )
    return np.asarray(distr).astype(np.uint8)
