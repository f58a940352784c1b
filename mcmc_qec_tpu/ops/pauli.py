"""Batched device-side Pauli-state operations (jax.numpy).

All functions operate on *flat* uint8 states of shape ``(..., nq)`` and treat
the spec's numpy tables as compile-time constants (they are baked into the
jitted executable — no host transfers in the hot path).

Replaces the reference's per-object numba wrappers (count_errors,
count_errors_xyz, syndrom, define_equivalence_class, to_class,
apply_stabilizers_uniform — e.g. src/toric_model.py:34-56,
src/planar_model.py:101-129) with batched pure functions.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import CodeSpec


def count_errors(state: jax.Array) -> jax.Array:
    """Total error count n (toric_model.py:174-176)."""
    return jnp.count_nonzero(state, axis=-1).astype(jnp.int32)


def count_errors_xyz(state: jax.Array) -> jax.Array:
    """Per-Pauli counts (n_x, n_y, n_z), stacked on a trailing axis
    (planar_model.py:224-229)."""
    nx = jnp.count_nonzero(state == 1, axis=-1)
    ny = jnp.count_nonzero(state == 2, axis=-1)
    nz = jnp.count_nonzero(state == 3, axis=-1)
    return jnp.stack([nx, ny, nz], axis=-1).astype(jnp.int32)


def bit_planes(state: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(X-component, Z-component) bit planes of a Pauli state."""
    b0 = (state & 1) ^ ((state >> 1) & 1)
    b1 = (state >> 1) & 1
    return b0, b1


def anticommute(a: jax.Array, b: jax.Array) -> jax.Array:
    b0a, b1a = a & 1, (a >> 1) & 1
    b0b, b1b = b & 1, (b >> 1) & 1
    return (b0a & b1b) ^ (b1a & b0b)


def syndrome(spec: CodeSpec, state: jax.Array) -> jax.Array:
    """Defect bit per stabilizer: anticommutation parity of the state with
    each check's Pauli string.  Verified equivalent to the reference's rolled
    XOR formulas (toric_model.py:58-101, planar_model.py:134-153) and
    _find_syndrome loops (rotated_surface_model.py:203-248,
    xzzx_model.py:155-223)."""
    vals = state[..., jnp.asarray(spec.stab_qubits)]  # (..., n_stabs, deg)
    ac = anticommute(vals, jnp.asarray(spec.stab_ops))
    return (jnp.sum(ac.astype(jnp.int32), axis=-1) % 2).astype(jnp.uint8)


def class_bits(spec: CodeSpec, state: jax.Array) -> jax.Array:
    """Class-bit pattern (GF(2)-linear functional of the bit planes)."""
    b0, b1 = bit_planes(state)
    a = jnp.asarray(spec.class_A, dtype=jnp.int32)
    b = jnp.asarray(spec.class_B, dtype=jnp.int32)
    feats = (
        jnp.einsum("fq,...q->...f", a, b0.astype(jnp.int32))
        + jnp.einsum("fq,...q->...f", b, b1.astype(jnp.int32))
    ) % 2
    weights = jnp.asarray(1 << np.arange(spec.n_class_bits), dtype=jnp.int32)
    return jnp.sum(feats * weights, axis=-1)


def eq_class(spec: CodeSpec, state: jax.Array) -> jax.Array:
    """Equivalence class id (toric_model.py:317-351 et al.)."""
    return jnp.asarray(spec.bits_to_eq)[class_bits(spec, state)].astype(jnp.int32)


def to_class(spec: CodeSpec, state: jax.Array, eq: jax.Array) -> jax.Array:
    """Move states to class ``eq`` while preserving the syndrome
    (generalizes toric_model.py:354-377; also provides the planar/rotated/
    xzzx versions the reference lacks)."""
    cur_bits = class_bits(spec, state)
    tgt_bits = jnp.asarray(spec.eq_to_bits)[eq]
    delta = cur_bits ^ tgt_bits
    mask = jnp.asarray(spec.class_delta_masks)[delta]
    return state ^ mask


def all_class_states(spec: CodeSpec, state: jax.Array) -> jax.Array:
    """Stack of ``n_classes`` states, one per equivalence class, with the
    same syndrome as ``state`` (the vectorized form of the reference's
    per-class ``to_class`` loops, decoders.py:285-288)."""
    eqs = jnp.arange(spec.n_classes)
    return jax.vmap(lambda e: to_class(spec, state, e))(eqs)


def apply_stabilizers_uniform(
    spec: CodeSpec, state: jax.Array, key: jax.Array, p: float = 0.5
) -> jax.Array:
    """XOR a random subset of stabilizers (each selected w.p. ``p``) onto the
    state — the "rain" randomization (toric_model.py:299-314,
    planar_model.py:355-376).  Stabilizer application commutes under XOR, so
    the sequential reference loop reduces to one GF(2) mat-vec per bit plane
    (matmul-friendly).
    """
    sel = jax.random.bernoulli(key, p, state.shape[:-1] + (spec.n_stabs,))
    masks = jnp.asarray(spec.stab_masks)
    mb0, mb1 = bit_planes(masks)
    comb_b0 = (
        jnp.einsum("...s,sq->...q", sel.astype(jnp.int32), mb0.astype(jnp.int32)) % 2
    )
    comb_b1 = (
        jnp.einsum("...s,sq->...q", sel.astype(jnp.int32), mb1.astype(jnp.int32)) % 2
    )
    # rebuild Pauli from (X, Z) components: X=1, Z=3, Y=2 = X^Z
    comb = (comb_b0 * 1) ^ (comb_b1 * 3)
    return state ^ comb.astype(jnp.uint8)


def random_logical(spec: CodeSpec, state: jax.Array, key: jax.Array) -> jax.Array:
    """Unconditionally apply a uniformly random logical to each state in the
    batch (the randomized warm start of generate_data.py:130-133)."""
    batch_shape = state.shape[:-1]
    mask = jnp.zeros_like(state)
    for i, drw in enumerate(spec.logical_draws):
        ko, kx, kz = jax.random.split(jax.random.fold_in(key, i), 3)
        op = jax.random.randint(ko, batch_shape, 0, 4)
        xp = jax.random.randint(kx, batch_shape, 0, drw.x_masks.shape[0])
        zp = jax.random.randint(kz, batch_shape, 0, drw.z_masks.shape[0])
        do = jnp.asarray(drw.op_lut)[op]  # (..., 2)
        xm = jnp.asarray(drw.x_masks)[xp] * do[..., 0:1]
        zm = jnp.asarray(drw.z_masks)[zp] * do[..., 1:2]
        mask = mask ^ xm ^ zm
    return state ^ mask


def pack_key(spec: CodeSpec, state: jax.Array, mults: np.ndarray) -> jax.Array:
    """64-bit content key of a chain as two independent 32-bit universal
    hashes (multiply-mod-2^32).  Replaces the host-side
    ``hash(qubit_matrix.tobytes())`` dedup key (decoders.py:251) with an
    on-device, process-independent key.
    """
    s32 = state.astype(jnp.uint32)
    m = jnp.asarray(mults, dtype=jnp.uint32)  # (2, nq)
    h = jnp.einsum("kq,...q->...k", m, s32)  # wraps mod 2^32
    return h  # (..., 2) uint32


def make_hash_mults(spec: CodeSpec, seed: int = 0x9E3779B9) -> np.ndarray:
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    mults = rng.randint(0, 1 << 31, size=(2, spec.nq), dtype=np.int64) * 2 + 1
    return mults.astype(np.uint32)
