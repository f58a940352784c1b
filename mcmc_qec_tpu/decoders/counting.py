"""On-device unique-chain counting and occupancy statistics.

The reference's STDC/STRC/PTDC/PTRC decoders dedup visited chains through
host-side python dicts keyed by ``hash(qubit_matrix.tobytes())``
(decoders.py:251-254, 597-623, 768-781).  Here every chain visit is recorded
on device as a 64-bit content key (two independent 32-bit universal hashes,
ops/pauli.py:pack_key) plus per-Pauli counts; a post-pass lexsort marks
first occurrences and segment-sums produce:

- Z_DC       = sum over *unique* chains of exp(-beta_err . n_xyz)   (STDC)
- m(n), N(n) = total / unique observations per length               (STRC/PTRC)
- shortest-set statistics                                           (STRC)

Droplet merging is free: all droplets of a class feed one stream, and
dedup over the combined stream is exactly the reference's dict-union merge
(decoders.py:313-314, 883-928).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import CodeSpec
from ..ops.metropolis import make_chain_update
from ..ops.pauli import count_errors_xyz, make_hash_mults, pack_key


class SampleStream(NamedTuple):
    """Recorded chain visits, leading axes (..., n_samples)."""

    keys: jax.Array  # (..., N, 2) uint32
    n_xyz: jax.Array  # (..., N, 3) int32


def make_sampler(spec: CodeSpec, steps: int, iters_per_step: int = 5,
                 engine: str = "literal", interpret: bool = False):
    """Build ``sample(states, key, betas) -> (states, SampleStream)``.

    Each of ``steps`` recording steps runs ``iters_per_step`` Metropolis
    updates then records the current chain (decoders.py:249-254: 5
    proposals per recorded step).  ``states``: (..., nq); stream axes
    (..., steps).

    engine="literal": one update = one random-stabilizer proposal (the
    reference's dynamics — but a long *sequential* dependency chain, so the
    device is latency-bound).  engine="sweep": one update = one colored
    sweep = n_stabs parallel proposals (~n_stabs x fewer sequential steps
    per recorded sample and dense vector math; same stationary
    distribution, more decorrelated samples).  engine="kernel": the same
    sweeps in one Pallas kernel call per recorded step (``interpret`` runs
    it through the Pallas interpreter off the GPU).
    """
    from ..ops.engines import resolve_engine

    engine = resolve_engine(engine, "counting", spec)
    if engine == "sweep":
        from ..ops.dense_sweep import make_dense_sweep

        sweep = make_dense_sweep(spec)

        def update(states, key, betas):
            def body(s, k):
                return sweep(s, k, betas), None

            ks = jax.random.split(key, iters_per_step)
            states, _ = jax.lax.scan(body, states, ks)
            return states

    elif engine == "kernel":
        from ..ops.sweep_kernel import make_kernel_sweep

        update = make_kernel_sweep(spec, iters_per_step, interpret=interpret)

    else:
        update = make_chain_update(spec, iters_per_step)
    mults = jnp.asarray(make_hash_mults(spec))

    def sample(states: jax.Array, key: jax.Array, betas: jax.Array):
        def body(s, k):
            s = update(s, k, betas)
            keys_ = pack_key(spec, s, mults)  # (..., 2)
            nxyz = count_errors_xyz(s)  # (..., 3)
            return s, (keys_, nxyz)

        ks = jax.random.split(key, steps)
        states, (keys_, nxyz) = jax.lax.scan(body, states, ks)
        # scan stacks on axis 0 -> move to second-to-last
        keys_ = jnp.moveaxis(keys_, 0, -2)
        nxyz = jnp.moveaxis(nxyz, 0, -2)
        return states, SampleStream(keys_, nxyz)

    return sample


def first_occurrence(keys: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Sort a (N, 2) key stream lexicographically and mark first occurrences.

    Returns (order, first_mask) where ``order`` sorts the stream and
    ``first_mask[i]`` is True when sorted key i differs from key i-1.
    """
    order = jnp.lexsort((keys[:, 1], keys[:, 0]))
    sk = keys[order]
    prev = jnp.roll(sk, 1, axis=0)
    diff = jnp.any(sk != prev, axis=-1)
    first = diff.at[0].set(True)
    return order, first


def chronological_first_occurrence(keys: jax.Array) -> jax.Array:
    """First-occurrence mask in *time order* for a (N, 2) key stream: True at
    index t iff keys[t] was never seen at an earlier index."""
    n = keys.shape[0]
    t = jnp.arange(n)
    order = jnp.lexsort((t, keys[:, 1], keys[:, 0]))
    sk = keys[order]
    prev = jnp.roll(sk, 1, axis=0)
    first_sorted = jnp.any(sk != prev, axis=-1).at[0].set(True)
    return jnp.zeros(n, bool).at[order].set(first_sorted)


def conv_mult_valid_mask(keys: jax.Array, n: jax.Array, conv_mult: float,
                         steps: int, t: Optional[jax.Array] = None,
                         step_end: Optional[jax.Array] = None) -> jax.Array:
    """Per-step validity under the reference's shortest-chain extension rule
    (decoders.py:249-263): every *new* chain with length <= the running
    shortest extends the stop point to step * conv_mult; sampling ends at the
    first step with step >= stop and step*100 >= steps.  Samples after the
    break contribute nothing (equivalent in distribution to breaking).

    ``t`` optionally supplies each sample's step index (the PT variants
    record Nc rung visits per ladder step, all sharing the outer step
    index, decoders.py:146-161); default = sample position.  When a step
    spans multiple samples, ``step_end`` must mark each step's LAST
    sample: the reference records every rung of step s (and applies any
    stop extension found at any rung) BEFORE evaluating the break
    (decoders.py:156-161), so ``broken`` may only transition at step
    boundaries — never between rungs of one step."""
    first = chronological_first_occurrence(keys)
    if t is None:
        t = jnp.arange(n.shape[0])
    if step_end is None:
        step_end = jnp.ones(n.shape[0], bool)

    def body(carry, inp):
        shortest, stop, broken = carry
        step, nt, ft, se = inp
        is_new_short = ft & (nt <= shortest)
        shortest = jnp.where(is_new_short, nt, shortest)
        stop = jnp.where(is_new_short, step * conv_mult, stop)
        valid = ~broken
        broken = broken | (
            se & (step >= stop) & (step * 100 >= steps)
        )
        return (shortest, stop, broken), valid

    init = (jnp.asarray(n.max() + 1, n.dtype), jnp.asarray(float(steps)),
            jnp.asarray(False))
    _, valid = jax.lax.scan(
        body, init, (t.astype(jnp.float32), n, first, step_end)
    )
    return valid


def _weighted_length(n_xyz: jax.Array, betas: jax.Array) -> jax.Array:
    """sum_i beta_i * n_i with 0 * inf := 0 (p_i = 0 handling,
    decoders.py:406-417)."""
    terms = jnp.where(n_xyz > 0, n_xyz.astype(jnp.float32) * betas, 0.0)
    return jnp.sum(terms, axis=-1)


def z_direct_count(
    stream: SampleStream,
    betas_error: jax.Array,
    shortest_only: bool = False,
    valid: Optional[jax.Array] = None,
    with_shortest: bool = False,
) -> jax.Array:
    """log Z_E = logsumexp over unique chains of -beta_err . n_xyz.

    Implements STDC's Boltzmann sum (decoders.py:317-318, 406-417); with
    ``shortest_only`` only chains within ~1e-5 of the minimal weighted
    length contribute (decoders.py:413-414).  ``with_shortest`` returns
    *both* reductions, (log Z, log Z_shortest), from the single sorted
    stream — the reference computes both Z's from one sample stream
    (decoders.py:490-505), so one sampler pass suffices.  ``valid`` (same
    leading shape as the sample axis) restricts counting to un-masked
    samples (the conv_mult early-stop rule).  Vectorized over leading axes;
    returns log Z (...,) (or a pair of them with ``with_shortest``).
    """

    def one(keys, n_xyz, v):
        # one fused lexicographic sort; with a validity mask, invalid
        # samples of a key sort after valid ones so the group
        # representative is valid whenever possible.  The maskless path
        # (the common one: conv_mult off) carries 2 fewer sort operands —
        # the sort is the dominant cost of the whole reduction
        w_all = _weighted_length(n_xyz, betas_error)
        if v is None:
            k1, k2, w = jax.lax.sort(
                (keys[:, 0], keys[:, 1], w_all), num_keys=2
            )
            first = (
                (k1 != jnp.roll(k1, 1)) | (k2 != jnp.roll(k2, 1))
            ).at[0].set(True)
        else:
            k1, k2, vinv, w, vs = jax.lax.sort(
                (keys[:, 0], keys[:, 1], (~v).astype(jnp.int32), w_all,
                 v.astype(jnp.int32)),
                num_keys=3,
            )
            first = (
                ((k1 != jnp.roll(k1, 1)) | (k2 != jnp.roll(k2, 1)))
                .at[0].set(True)
                & (vs == 1)
            )

        def reduce(mask):
            neg = -w
            m = jnp.max(jnp.where(mask, neg, -jnp.inf))
            s = jnp.sum(jnp.where(mask, jnp.exp(neg - m), 0.0))
            return m + jnp.log(s)

        if shortest_only or with_shortest:
            wmin = jnp.min(jnp.where(first, w, jnp.inf))
            short = first & jnp.isclose(w, wmin, rtol=1e-5, atol=1e-8)
            if with_shortest:
                return reduce(first), reduce(short)
            return reduce(short)
        return reduce(first)

    flat_keys = stream.keys.reshape((-1,) + stream.keys.shape[-2:])
    flat_nxyz = stream.n_xyz.reshape((-1,) + stream.n_xyz.shape[-2:])
    if valid is None:
        out = jax.vmap(lambda k, n: one(k, n, None))(flat_keys, flat_nxyz)
    else:
        flat_valid = valid.reshape((-1, valid.shape[-1]))
        out = jax.vmap(one)(flat_keys, flat_nxyz, flat_valid)
    lead = stream.keys.shape[:-2]
    if with_shortest:
        return out[0].reshape(lead), out[1].reshape(lead)
    return out.reshape(lead)


class OccupancyStats(NamedTuple):
    """Per-length occupancy of a stream (arrays indexed by total length n)."""

    m_n: jax.Array  # (..., nq+1) total observations per length
    N_n: jax.Array  # (..., nq+1) unique chains per length
    shortest: jax.Array  # (...,) minimal observed length
    next_shortest: jax.Array  # (...,) second-smallest observed length (or nq+1)


def occupancy_stats(stream: SampleStream, nq: int,
                    valid: Optional[jax.Array] = None) -> OccupancyStats:
    """m(n), N(n) and shortest/next-shortest lengths (STRC/PTRC machinery,
    decoders.py:597-623, 768-827)."""

    def one(keys, n_xyz, v):
        n_all = jnp.sum(n_xyz, axis=-1)
        k1, k2, vinv, n, vs = jax.lax.sort(
            (keys[:, 0], keys[:, 1], (~v).astype(jnp.int32), n_all,
             v.astype(jnp.int32)),
            num_keys=3,
        )
        first = (
            ((k1 != jnp.roll(k1, 1)) | (k2 != jnp.roll(k2, 1))).at[0].set(True)
            & (vs == 1)
        )
        m_n = jnp.zeros(nq + 2, jnp.int32).at[n].add(vs)
        N_n = jnp.zeros(nq + 2, jnp.int32).at[n].add(first.astype(jnp.int32))
        has = m_n[: nq + 1] > 0
        idx = jnp.arange(nq + 1)
        shortest = jnp.min(jnp.where(has, idx, nq + 1))
        nxt = jnp.min(jnp.where(has & (idx > shortest), idx, nq + 1))
        return m_n[: nq + 1], N_n[: nq + 1], shortest, nxt

    flat_keys = stream.keys.reshape((-1,) + stream.keys.shape[-2:])
    flat_nxyz = stream.n_xyz.reshape((-1,) + stream.n_xyz.shape[-2:])
    if valid is None:
        flat_valid = jnp.ones(flat_keys.shape[:2], bool)
    else:
        flat_valid = valid.reshape((-1, valid.shape[-1]))
    m_n, N_n, sh, nx = jax.vmap(one)(flat_keys, flat_nxyz, flat_valid)
    lead = stream.keys.shape[:-2]
    return OccupancyStats(
        m_n.reshape(lead + (nq + 1,)),
        N_n.reshape(lead + (nq + 1,)),
        sh.reshape(lead),
        nx.reshape(lead),
    )


def unique_count_in_shortest(stream: SampleStream, nq: int) -> Tuple[jax.Array, jax.Array]:
    """(#unique chains at the shortest length, #unique at next shortest)."""
    stats = occupancy_stats(stream, nq)
    lead = stats.shortest.shape
    idx = stats.shortest.reshape(-1)
    nxt = stats.next_shortest.reshape(-1)
    N_flat = stats.N_n.reshape((-1, nq + 1))
    n_short = N_flat[jnp.arange(len(idx)), jnp.clip(idx, 0, nq)]
    n_next = jnp.where(
        nxt <= nq, N_flat[jnp.arange(len(nxt)), jnp.clip(nxt, 0, nq)], 0
    )
    return n_short.reshape(lead), n_next.reshape(lead)
