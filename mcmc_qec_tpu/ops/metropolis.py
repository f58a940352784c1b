"""Batched Metropolis kernels with the unified vector-beta acceptance rule.

Every acceptance rule in the reference is a special case of

    accept  <=>  log u < -(beta_x*dn_x + beta_y*dn_y + beta_z*dn_z)

with beta_i = -ln(p_i / (1 - p_total)):

- depolarizing: p_i = p/3 equal -> factor**dn (src/mcmc.py:16,34,42)
- xyz:          factors = p_xyz/(1-sum p) -> (factors**dn).prod()
                (src/mcmc.py:106-114,162-173)
- biased eta:   explicit probability-ratio recompute
                (src/mcmc_biased.py:20-59) — our local delta form is exact
                and O(deg) instead of the reference's O(d^2) per proposal
- alpha:        beta_z = -ln pz_tilde, beta_x = beta_y = -alpha*ln pz_tilde
                (src/mcmc_alpha.py:26-70)

Two engines are provided:

- ``make_chain_stepper``: the *literal* engine — one uniformly random
  stabilizer proposal at a time per chain (exactly the reference dynamics,
  src/toric_model.py:287-296 etc.), vectorized over an arbitrary chain batch.
- ``make_sweep_stepper``: the *fast* engine — a conflict-free-colored
  multi-proposal sweep: all stabilizers of one color are proposed and
  accepted in parallel (valid because same-color stabilizers share no
  qubits), one sweep = n_stabs effective proposals.  Same stationary
  distribution, far better arithmetic intensity.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import CodeSpec


def _extended_tables(spec: CodeSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Stabilizer tables with pad entries redirected to sentinel qubit nq."""
    qubits = spec.stab_qubits.copy()
    qubits[spec.stab_ops == 0] = spec.nq
    return qubits, spec.stab_ops


def _dn_xyz(old: jax.Array, new: jax.Array) -> jax.Array:
    """Per-Pauli count change over a local support; trailing axis (3,)."""
    def cnt(v, p):
        return jnp.sum((v == p).astype(jnp.int32), axis=-1)

    return jnp.stack(
        [cnt(new, 1) - cnt(old, 1), cnt(new, 2) - cnt(old, 2), cnt(new, 3) - cnt(old, 3)],
        axis=-1,
    )


def _log_u(key: jax.Array, shape=()) -> jax.Array:
    u = jax.random.uniform(key, shape, minval=1e-38, maxval=1.0)
    return jnp.log(u)


def make_chain_stepper(spec: CodeSpec, include_logical: bool = False):
    """Single-proposal Metropolis stepper for one chain (vmap over batches).

    Returns ``step(state, key, betas, p_logical) -> state`` performing ONE
    proposal; ``state`` is a flat (nq,) uint8 array, ``betas`` is (3,)
    float32, ``p_logical`` a scalar (only used when ``include_logical``).
    Proposal selection is uniform over all stabilizers, which matches every
    family's _apply_random_stabilizer (verified: toric_model.py:287-296,
    planar_model.py:342-352, rotated_surface_model.py:395-408 — the
    full/half split probability ``phalf`` works out to a uniform choice).
    """
    qubits_np, ops_np = _extended_tables(spec)
    stab_qubits = jnp.asarray(qubits_np)
    stab_ops = jnp.asarray(ops_np)
    n_stabs = spec.n_stabs

    draws = spec.logical_draws
    op_luts = [jnp.asarray(d.op_lut) for d in draws]
    x_masks = [jnp.asarray(d.x_masks) for d in draws]
    z_masks = [jnp.asarray(d.z_masks) for d in draws]

    def stab_proposal(state: jax.Array, key: jax.Array, betas: jax.Array) -> jax.Array:
        k1, k2 = jax.random.split(key)
        s = jax.random.randint(k1, (), 0, n_stabs)
        qid = stab_qubits[s]
        ops = stab_ops[s]
        ext = jnp.concatenate([state, jnp.zeros((1,), dtype=state.dtype)])
        old = ext[qid]
        new = old ^ ops
        logr = -jnp.sum(betas * _dn_xyz(old, new).astype(betas.dtype))
        accept = _log_u(k2) < logr
        ext = ext.at[qid].set(jnp.where(accept, new, old))
        return ext[:-1]

    def logical_proposal(state: jax.Array, key: jax.Array, betas: jax.Array) -> jax.Array:
        """Random-logical proposal (toric_model.py:228-253 et al.)."""
        keys = jax.random.split(key, 3 * len(draws) + 1)
        mask = jnp.zeros_like(state)
        for i in range(len(draws)):
            ko, kx, kz = keys[3 * i], keys[3 * i + 1], keys[3 * i + 2]
            op = jax.random.randint(ko, (), 0, 4)
            xp = jax.random.randint(kx, (), 0, x_masks[i].shape[0])
            zp = jax.random.randint(kz, (), 0, z_masks[i].shape[0])
            do = op_luts[i][op]
            m = (x_masks[i][xp] * do[0]) ^ (z_masks[i][zp] * do[1])
            mask = mask ^ m
        new = state ^ mask
        dn = _dn_xyz(state, new).astype(betas.dtype)
        logr = -jnp.sum(betas * dn)
        accept = _log_u(keys[-1]) < logr
        return jnp.where(accept, new, state)

    if not include_logical:

        def step(state, key, betas, p_logical=None):
            del p_logical
            return stab_proposal(state, key, betas)

    else:

        def step(state, key, betas, p_logical):
            kc, kp = jax.random.split(key)
            use_logical = jax.random.uniform(kc) < p_logical
            s_log = logical_proposal(state, kp, betas)
            s_stab = stab_proposal(state, kp, betas)
            return jnp.where(use_logical, s_log, s_stab)

    return step


def make_chain_update(spec: CodeSpec, iters: int, include_logical: bool = False):
    """``update(states, key, betas, p_logical) -> states`` running ``iters``
    sequential proposals on a batch of chains.

    ``states``: (..., nq) uint8; ``betas``: broadcastable (..., 3);
    ``p_logical``: broadcastable (...,).  Mirrors ``Chain.update_chain``
    (src/mcmc.py:19-46) over an arbitrary batch.

    Implementation note: a fully-batched bulk-RNG formulation (one threefry
    draw per stream, take/put_along_axis in the scan body) was tried and
    compiled pathologically slowly; the
    vmap-of-scan form below compiles fast and its per-proposal cost is
    latency-dominated anyway (use engine="sweep" paths for throughput).
    """
    step = make_chain_stepper(spec, include_logical)

    def one_chain(state, key, betas, p_logical):
        keys = jax.random.split(key, iters)

        def body(s, k):
            return step(s, k, betas, p_logical), None

        out, _ = jax.lax.scan(body, state, keys)
        return out

    def update(states, key, betas, p_logical=0.0):
        batch_shape = states.shape[:-1]
        flat = states.reshape((-1, states.shape[-1]))
        n = flat.shape[0]
        keys = jax.random.split(key, n)
        betas_b = jnp.broadcast_to(betas, batch_shape + (3,)).reshape((-1, 3))
        p_b = jnp.broadcast_to(p_logical, batch_shape).reshape((-1,))
        out = jax.vmap(one_chain)(flat, keys, betas_b, p_b)
        return out.reshape(states.shape)

    return update


def make_sweep_stepper(spec: CodeSpec):
    """Colored multi-proposal sweep: ``sweep(state, key, betas) -> state``.

    One call proposes every stabilizer exactly once (grouped into
    conflict-free colors), i.e. n_stabs effective Metropolis proposals.
    ``state``: (..., nq) uint8, batched; ``betas``: (3,) or batched (..., 3).
    """
    qubits_np, ops_np = _extended_tables(spec)
    # append sentinel stabilizer (all pads) at index n_stabs for color padding
    sent_q = np.full((1, spec.stab_deg), spec.nq, dtype=np.int32)
    sent_o = np.zeros((1, spec.stab_deg), dtype=np.uint8)
    qubits_ext = np.concatenate([qubits_np, sent_q], axis=0)
    ops_ext = np.concatenate([ops_np, sent_o], axis=0)

    color_qubits = jnp.asarray(qubits_ext[spec.color_stabs])  # (C, W, deg)
    color_ops = jnp.asarray(ops_ext[spec.color_stabs])
    n_colors = int(spec.color_stabs.shape[0])

    W = int(spec.color_stabs.shape[1])

    def sweep(state: jax.Array, key: jax.Array, betas: jax.Array) -> jax.Array:
        batch_shape = state.shape[:-1]
        betas_b = jnp.broadcast_to(betas, batch_shape + (3,)).astype(jnp.float32)
        ext = jnp.concatenate(
            [state, jnp.zeros(batch_shape + (1,), dtype=state.dtype)], axis=-1
        )
        # one bulk uniform draw for the whole sweep
        all_logu = jnp.log(
            jax.random.uniform(key, (n_colors,) + batch_shape + (W,), minval=1e-38)
        )
        for c in range(n_colors):
            qid = color_qubits[c]  # (W, deg)
            ops = color_ops[c]
            old = ext[..., qid]  # (..., W, deg)
            new = old ^ ops
            dn = _dn_xyz(old, new).astype(jnp.float32)  # (..., W, 3)
            logr = -jnp.einsum("...wk,...k->...w", dn, betas_b)
            accept = all_logu[c] < logr  # (..., W)
            upd = jnp.where(accept[..., None], new, old)
            flat_idx = qid.reshape(-1)
            ext = ext.at[..., flat_idx].set(upd.reshape(batch_shape + (-1,)))
        return ext[..., :-1]

    return sweep
