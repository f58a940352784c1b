"""Parallel-tempering ladder with replica exchange, batched over syndromes.

Batched redesign of ``Ladder``/``Ladder_biased``/``Ladder_alpha``
(src/mcmc.py:49-103, src/mcmc_biased.py:66-124, src/mcmc_alpha.py:77-137):
the ladder is an array axis, rung temperatures are rows of a (Nc, 3) beta
table, and one generalized swap rule

    log r = sum_i (beta_hi_i - beta_lo_i) * (n_hi_i - n_lo_i)

covers all three reference variants: for depolarizing (equal per-Pauli
betas) it collapses exactly to rel_p**(ne_hi - ne_lo) (src/mcmc.py:86-92,
144-149) and for alpha exactly to (pz_lo/pz_hi)**(n_eff_hi - n_eff_lo)
(src/mcmc_alpha.py:117-123).  For biased noise the reference approximates
the swap with the total-count depolarizing rule (src/mcmc_biased.py:105-112)
even though its per-Pauli probabilities differ; our rule keeps the exact
per-Pauli form, which is the detailed-balance-correct swap for that model
(a deliberate fix, not bit-parity).

The swap sweep is sequential top->bottom like the reference (mcmc.py:96-99)
so a replica can fall the whole ladder in one step — this drives the tops0
round-trip counter used for burn-in/convergence.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import CodeSpec
from ..ops.metropolis import make_chain_update
from ..ops.pauli import count_errors_xyz, eq_class


class LadderState(NamedTuple):
    """Batched ladder state: B independent ladders of Nc chains each."""

    state: jax.Array  # (B, Nc, nq) uint8
    flag: jax.Array  # (B, Nc) int32 — 1 marks the descendant of a top chain
    tops0: jax.Array  # (B,) int32 — count of top-flags reaching the bottom


# ---------------------------------------------------------------------------
# Beta tables
# ---------------------------------------------------------------------------


def betas_xyz(p_x, p_y, p_z) -> np.ndarray:
    """beta_i = -ln(p_i / (1 - p_total)) (the unified acceptance form)."""
    p = p_x + p_y + p_z
    return -np.log(np.array([p_x, p_y, p_z]) / (1.0 - p))


def betas_depolarizing(p: float) -> np.ndarray:
    return betas_xyz(p / 3.0, p / 3.0, p / 3.0)


def beta_ladder_depolarizing(p_bottom: float, Nc: int, p_top: float = 0.75) -> np.ndarray:
    """linspace p-ladder bottom -> 0.75 (src/mcmc.py:62-66)."""
    ps = np.linspace(p_bottom, p_top, Nc)
    return np.stack([betas_depolarizing(p) for p in ps])


def beta_ladder_biased(p_bottom: float, eta: float, Nc: int) -> np.ndarray:
    """p_top = (eta+1)/(2*eta+1) (src/mcmc_biased.py:83-86)."""
    p_top = (eta + 1.0) / (2.0 * eta + 1.0)
    ps = np.linspace(p_bottom, p_top, Nc)
    out = []
    for p in ps:
        pz = p * eta / (eta + 1.0)
        px = p / (2.0 * (eta + 1.0))
        out.append(betas_xyz(px, px, pz))
    return np.stack(out)


def beta_ladder_alpha(pz_tilde_bottom: float, alpha: float, Nc: int) -> np.ndarray:
    """pz_tilde ladder bottom -> 1 (src/mcmc_alpha.py:94-98); the unified
    betas are beta_z = -ln pz_tilde, beta_x = beta_y = -alpha ln pz_tilde."""
    pzt = np.linspace(pz_tilde_bottom, 1.0, Nc)
    bz = -np.log(np.maximum(pzt, 1e-30))
    return np.stack([alpha * bz, alpha * bz, bz], axis=-1)


# ---------------------------------------------------------------------------
# Ladder step
# ---------------------------------------------------------------------------


def init_ladder(spec: CodeSpec, init_states: jax.Array, Nc: int) -> LadderState:
    """Replicate (B, nq) initial states across Nc rungs; the top rung starts
    flagged (src/mcmc.py:72-79)."""
    B = init_states.shape[0]
    state = jnp.broadcast_to(init_states[:, None, :], (B, Nc, init_states.shape[-1]))
    flag = jnp.zeros((B, Nc), dtype=jnp.int32).at[:, -1].set(1)
    tops0 = jnp.zeros((B,), dtype=jnp.int32)
    return LadderState(state=jnp.asarray(state, dtype=jnp.uint8), flag=flag, tops0=tops0)


def _make_sweeps(spec: CodeSpec, iters: int, engine: str, interpret: bool):
    """``sweeps(state, key, betas) -> state``: ``iters`` colored sweeps,
    as an XLA scan (engine "sweep") or one kernel call ("kernel")."""
    if engine == "kernel":
        from ..ops.sweep_kernel import make_kernel_sweep

        return make_kernel_sweep(spec, iters, interpret=interpret)
    from ..ops.dense_sweep import make_dense_sweep

    sweep_fn = make_dense_sweep(spec)

    def sweeps(state, key, betas):
        def body(s, k):
            return sweep_fn(s, k, betas), None

        state, _ = jax.lax.scan(body, state, jax.random.split(key, iters))
        return state

    return sweeps


def make_ladder_step(
    spec: CodeSpec,
    Nc: int,
    iters: int = 10,
    p_logical: float = 0.5,
    engine: str = "literal",
    top_exact_accept: bool = False,
    exchange: str = "sequential",
    interpret: bool = False,
):
    """Build ``step(ls, key, betas) -> (ls, bottom_eq, bottom_n_xyz,
    swap_acc)`` where ``swap_acc`` is the (B, Nc-1) per-rung-pair accepted
    swap indicator for this step (replica-exchange observability).

    One call = ``iters`` Metropolis updates on every rung (top rung mixes
    in logical proposals w.p. ``p_logical``, src/mcmc.py:20-35) followed by a
    sequential top->bottom replica-exchange sweep with flag/tops0
    bookkeeping (src/mcmc.py:94-103).  ``betas`` is a traced (Nc, 3) array so
    one compiled executable serves every error rate.

    engine="literal": one update = one random-stabilizer proposal (reference
    cadence).  engine="sweep": one update = one colored sweep (n_stabs
    parallel proposals) — far better device utilization; the top rung
    additionally runs ``iters`` literal proposals with logical mixing so
    class transitions keep the reference cadence.  engine="kernel": the
    ``iters`` sweeps run in one Pallas kernel call (``interpret`` runs it
    through the Pallas interpreter off the GPU).

    ``top_exact_accept``: set True when the top rung's betas are exactly
    zero (depolarizing p_top=0.75, src/mcmc.py:62-66, and alpha
    pz_tilde_top=1, src/mcmc_alpha.py:94-98 — in both, factor==1 so every
    logical proposal is accepted, src/mcmc.py:30).  Logical masks commute
    under XOR, so the ``iters`` sequential MH rounds collapse into one
    batched XOR of gated random masks — no error counting, no sequential
    chain.  Distributionally identical to the general path when the top
    betas are 0.

    ``exchange``: "sequential" is the reference's top->bottom swap sweep
    (a replica can fall the whole ladder in one step, mcmc.py:96-99);
    "even_odd" proposes all even pairs then all odd pairs — each phase is
    a valid Metropolis move on disjoint pairs, so the sampler targets the
    same joint distribution (SURVEY §7.1 #4), but there is no serial
    dependence chain across rung pairs.  A replica moves at most 2 rungs
    per step (vs a possible full-ladder fall), yet the measured tops0
    round-trip rate stays within ~5% of sequential at d=5 — the two
    phases per step compensate — so TOPS/tops_burn need no recalibration
    (tests/test_even_odd_exchange.py).
    """
    from ..ops.engines import resolve_engine

    if exchange not in ("sequential", "even_odd"):
        raise ValueError(
            f"exchange={exchange!r}: expected 'sequential' or 'even_odd'"
        )
    engine = resolve_engine(engine, "chain", spec)
    update = make_chain_update(spec, iters, include_logical=(p_logical > 0))
    p_log_vec = jnp.zeros((Nc,)).at[-1].set(p_logical)
    if engine in ("sweep", "kernel"):
        from ..ops.pauli import count_errors_xyz as _cexyz

        sweeps = _make_sweeps(spec, iters, engine, interpret)
        draws = spec.logical_draws

        def _gated_masks(top, key):
            """(iters, B, nq) gated random-logical masks, all rounds batched."""
            B = top.shape[0]
            gate = jax.random.bernoulli(
                jax.random.fold_in(key, 0xA), p_logical, (iters, B)
            )
            mask = jnp.zeros((iters,) + top.shape, top.dtype)
            for i, drw in enumerate(draws):
                ko, kx, kz = jax.random.split(
                    jax.random.fold_in(key, 100 + i), 3
                )
                op = jax.random.randint(ko, (iters, B), 0, 4)
                xp = jax.random.randint(kx, (iters, B), 0, drw.x_masks.shape[0])
                zp = jax.random.randint(kz, (iters, B), 0, drw.z_masks.shape[0])
                do = jnp.asarray(drw.op_lut)[op]  # (iters, B, 2)
                xm = jnp.asarray(drw.x_masks)[xp] * do[..., 0:1]
                zm = jnp.asarray(drw.z_masks)[zp] * do[..., 1:2]
                mask = mask ^ xm ^ zm
            return jnp.where(gate[..., None], mask, jnp.zeros_like(mask))

        if top_exact_accept:

            def top_logical_mix(top, key, betas_top):
                """Zero-beta top rung: every gated proposal accepts and the
                masks commute, so one XOR applies all ``iters`` rounds."""
                del betas_top
                masks = _gated_masks(top, key)
                total = masks[0]
                for t in range(1, iters):
                    total = total ^ masks[t]
                return top ^ total

        else:

            def top_logical_mix(top, key, betas_top):
                """General batched logical mixing for the top rung:
                ``iters`` sequential MH rounds (proposals pre-generated in
                one batch; the per-Pauli count of the current state is kept
                incrementally so each round costs one count, not two)."""
                B = top.shape[0]
                masks = _gated_masks(top, key)
                logu = jnp.log(
                    jax.random.uniform(
                        jax.random.fold_in(key, 0xB), (iters, B), minval=1e-38
                    )
                )
                n_top = _cexyz(top).astype(jnp.float32)  # (B, 3)
                for t in range(iters):
                    new = top ^ masks[t]
                    n_new = _cexyz(new).astype(jnp.float32)
                    logr = -jnp.sum(betas_top * (n_new - n_top), axis=-1)
                    accept = logu[t] < logr
                    top = jnp.where(accept[:, None], new, top)
                    n_top = jnp.where(accept[:, None], n_new, n_top)
                return top

    def step(ls: LadderState, key: jax.Array, betas: jax.Array):
        betas_j = jnp.asarray(betas, dtype=jnp.float32)  # (Nc, 3)
        state, flag, tops0 = ls
        B = state.shape[0]
        k_sweep, k_swap = jax.random.split(key)

        # 1) Metropolis on every rung (batched over B and Nc).
        if engine != "literal":
            state = sweeps(state, k_sweep, betas_j[None, :, :])
            k_top = jax.random.fold_in(k_sweep, 0x707)
            top = top_logical_mix(state[:, -1], k_top, betas_j[-1])
            state = state.at[:, -1].set(top)
        else:
            state = update(
                state, k_sweep, betas_j[None, :, :], p_log_vec[None, :]
            )

        # 2) Replica-exchange sweep (unrolled; Nc is small).  Swaps act on
        #    a per-ladder rung permutation; the (B, Nc, nq) state is
        #    gathered once at the end instead of being rewritten per
        #    accepted pair.
        n_xyz = count_errors_xyz(state).astype(jnp.float32)  # (B, Nc, 3)
        perm = jnp.broadcast_to(jnp.arange(Nc)[None, :], (B, Nc))
        accepts = [None] * (Nc - 1)

        def accept_pair(i, j):
            ki = jax.random.fold_in(k_swap, j)
            d_beta = betas_j[i + 1] - betas_j[i]  # (3,)
            dn = n_xyz[:, i + 1] - n_xyz[:, i]  # (B, 3)
            logr = jnp.sum(d_beta * dn, axis=-1)  # (B,)
            u = jax.random.uniform(ki, (B,), minval=1e-38)
            return jnp.log(u) < logr

        def swap_rows(arr, i, accept):
            ai, aj = arr[:, i], arr[:, i + 1]
            sel = accept.reshape((B,) + (1,) * (ai.ndim - 1))
            arr = arr.at[:, i].set(jnp.where(sel, aj, ai))
            return arr.at[:, i + 1].set(jnp.where(sel, ai, aj))

        if exchange == "even_odd":
            # two phases of disjoint adjacent pairs — no serial chain
            for phase in (0, 1):
                for j, i in enumerate(range(phase, Nc - 1, 2)):
                    accept = accept_pair(i, 100 * phase + j)
                    accepts[i] = accept.astype(jnp.int32)
                    perm = swap_rows(perm, i, accept)
                    flag = swap_rows(flag, i, accept)
                    n_xyz = swap_rows(n_xyz, i, accept)
        else:
            for j, i in enumerate(reversed(range(Nc - 1))):
                accept = accept_pair(i, j)
                accepts[i] = accept.astype(jnp.int32)
                perm = swap_rows(perm, i, accept)
                flag = swap_rows(flag, i, accept)
                n_xyz = swap_rows(n_xyz, i, accept)
        state = jnp.take_along_axis(state, perm[:, :, None], axis=1)

        # 3) Flag bookkeeping (src/mcmc.py:100-103).
        flag = flag.at[:, -1].set(1)
        hit = flag[:, 0] == 1
        tops0 = tops0 + hit.astype(jnp.int32)
        flag = flag.at[:, 0].set(jnp.where(hit, 0, flag[:, 0]))

        bottom_eq = eq_class(spec, state[:, 0])  # (B,)
        swap_acc = jnp.stack(accepts, axis=1)  # (B, Nc-1) accepted swaps
        return LadderState(state, flag, tops0), bottom_eq, n_xyz[:, 0], swap_acc

    return step


class PermLadderState(NamedTuple):
    """Ladder state for position-carrying scans: ``state`` stays in
    PHYSICAL chain order across steps; ``pos[b, j]`` is the rung position
    currently held by physical chain j; ``flag`` is PER-CHAIN (the
    top-descendant marker travels with its chain for free)."""

    state: jax.Array  # (B, Nc, nq) uint8, physical order
    flag: jax.Array  # (B, Nc) int32, per chain
    tops0: jax.Array  # (B,) int32
    pos: jax.Array  # (B, Nc) int32, chain -> rung position


def perm_enter(ls: LadderState) -> PermLadderState:
    B, Nc = ls.flag.shape
    pos = jnp.broadcast_to(jnp.arange(Nc, dtype=jnp.int32)[None, :], (B, Nc))
    # LadderState.flag is position-space; with pos = identity the same
    # array is the per-chain flag
    return PermLadderState(ls.state, ls.flag, ls.tops0, pos)


def perm_exit(pls: PermLadderState) -> LadderState:
    """Materialize position order with ONE gather (perm = argsort(pos))."""
    perm = jnp.argsort(pls.pos, axis=1)
    state = jnp.take_along_axis(pls.state, perm[:, :, None], axis=1)
    flag = jnp.take_along_axis(pls.flag, perm, axis=1)
    return LadderState(state, flag, pls.tops0)


def make_perm_ladder_step(
    spec: CodeSpec,
    Nc: int,
    iters: int = 10,
    engine: str = "sweep",
    exchange: str = "sequential",
    interpret: bool = False,
):
    """Position-carrying variant of ``make_ladder_step`` for the PT
    counting samplers (PTDC/PTRC, p_logical == 0): instead of physically
    reordering the (B, Nc, nq) state on every accepted swap and gathering
    the whole ladder each step (the r4 XLA-ladder swap chain that
    dominated PTDC once sweeps were cheap — VERDICT r4 #3/#7), each chain
    carries its current rung index and every permutation-dependent value
    is produced GATHER-FREE:

    - per-chain betas = one-hot(pos) @ betas — one flat (B*Nc, Nc)x(Nc, 3)
      matmul;
    - per-position Pauli counts = a one-hot-weighted broadcast reduction;
    - accepted swaps increment/decrement ``pos`` ELEMENTWISE (a chain at
      rung i moves to i+1), and swap the two (B, 3) count rows;
    - the per-step observables (keys (B, Nc, 2), n_xyz) are emitted in
      rung order through an exact one-hot contraction (uint32 keys split
      into 16-bit halves so the f32 matmul is exact).

    This keeps loop-carried-index gathers out of the scan body.  Whether
    it still beats ``make_ladder_step``'s gather form on a GPU is not
    measured (ROADMAP C4).

    The sampled process is distributionally identical to
    make_ladder_step's (same proposal kernels, same swap rule, same
    sequential top->bottom sweep semantics — a chain can fall the whole
    ladder in one step because ``pos`` updates between adjacent pairs).
    No logical mixing: the counting samplers run p_logical=0
    (decoders.py:146-153 use plain ladders).

    ``engine``/``interpret`` as in ``make_ladder_step``.

    Returns ``step(pls, key, betas) -> (pls, keys_pos, n_xyz_pos,
    swap_acc)`` with keys/n_xyz in rung-position order; use
    ``perm_enter``/``perm_exit`` around the scan.
    """
    from ..ops.engines import resolve_engine
    from ..ops.pauli import make_hash_mults, pack_key

    engine = resolve_engine(engine, "chain", spec)
    if exchange not in ("sequential", "even_odd"):
        raise ValueError(
            f"exchange={exchange!r}: expected 'sequential' or 'even_odd'"
        )
    if engine == "literal":
        update = make_chain_update(spec, iters, include_logical=False)
    else:
        sweeps = _make_sweeps(spec, iters, engine, interpret)
    mults = jnp.asarray(make_hash_mults(spec))
    rng_nc = jnp.arange(Nc, dtype=jnp.int32)

    def step(pls: PermLadderState, key: jax.Array, betas: jax.Array):
        betas_j = jnp.asarray(betas, dtype=jnp.float32)  # (Nc, 3)
        state, flag, tops0, pos = pls
        B = state.shape[0]
        k_sweep, k_swap = jax.random.split(key)

        # chain j runs at rung pos[b, j]'s temperature (flat matmul)
        oh = (pos[:, :, None] == rng_nc[None, None, :]).astype(jnp.float32)
        # HIGHEST: a default-precision f32 matmul may round the betas to
        # TF32 on the GPU (measured: 9e-4 absolute error on an H100)
        betas_chain = jnp.dot(
            oh.reshape(B * Nc, Nc), betas_j,
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(B, Nc, 3)

        # 1) Metropolis on every rung (physical order, per-chain betas)
        if engine == "literal":
            state = update(state, k_sweep, betas_chain, 0.0)
        else:
            state = sweeps(state, k_sweep, betas_chain)

        # 2) Replica exchange on the rung indices
        n_phys = count_errors_xyz(state).astype(jnp.float32)  # (B, Nc, 3)
        # per-position counts: one-hot-weighted reduction over chains
        n_at = jnp.sum(n_phys[:, :, None, :] * oh[:, :, :, None], axis=1)
        accepts = [None] * (Nc - 1)

        pair_iter = (
            [(100 * ph + j, i) for ph in (0, 1)
             for j, i in enumerate(range(ph, Nc - 1, 2))]
            if exchange == "even_odd"
            else list(enumerate(reversed(range(Nc - 1))))
        )
        for j, i in pair_iter:
            ki = jax.random.fold_in(k_swap, j)
            d_beta = betas_j[i + 1] - betas_j[i]
            logr = jnp.sum(d_beta * (n_at[:, i + 1] - n_at[:, i]), axis=-1)
            u = jax.random.uniform(ki, (B,), minval=1e-38)
            acc = jnp.log(u) < logr  # (B,)
            accepts[i] = acc.astype(jnp.int32)
            # chains at rungs i / i+1 trade places — elementwise on pos
            accp = acc[:, None]
            pos = jnp.where(
                accp & (pos == i), i + 1,
                jnp.where(accp & (pos == i + 1), i, pos),
            )
            acc3 = acc[:, None]
            ni, ni1 = n_at[:, i], n_at[:, i + 1]
            n_at = n_at.at[:, i].set(jnp.where(acc3, ni1, ni))
            n_at = n_at.at[:, i + 1].set(jnp.where(acc3, ni, ni1))

        # 3) Flag bookkeeping (src/mcmc.py:100-103), per chain
        at_top = pos == Nc - 1
        at_bot = pos == 0
        flag = jnp.where(at_top, 1, flag)
        hit = jnp.sum(flag * at_bot, axis=1)  # 0/1 per ladder
        tops0 = tops0 + hit
        flag = jnp.where(at_bot, 0, flag)

        # 4) Observables in rung order: exact one-hot contraction (the
        # POST-swap one-hot; uint32 keys as 16-bit halves, every f32
        # product <= 65535 and exactly one term per sum)
        oh2 = (pos[:, :, None] == rng_nc[None, None, :]).astype(jnp.float32)
        keys_phys = pack_key(spec, state, mults)  # (B, Nc, 2)
        k16 = jnp.stack(
            [keys_phys[..., 0] & 0xFFFF, keys_phys[..., 0] >> 16,
             keys_phys[..., 1] & 0xFFFF, keys_phys[..., 1] >> 16], -1,
        ).astype(jnp.float32)
        kp = jnp.sum(
            k16[:, :, None, :] * oh2[:, :, :, None], axis=1
        ).astype(jnp.uint32)
        keys_pos = jnp.stack(
            [kp[..., 0] | (kp[..., 1] << 16),
             kp[..., 2] | (kp[..., 3] << 16)], -1,
        )
        swap_acc = jnp.stack(accepts, axis=1)
        return (
            PermLadderState(state, flag, tops0, pos),
            keys_pos,
            n_at.astype(jnp.int32),
            swap_acc,
        )

    return step
