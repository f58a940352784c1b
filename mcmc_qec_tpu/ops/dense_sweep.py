"""Dense bitplane sweep engine: gather-free colored Metropolis.

The colored sweep in ops/metropolis.py uses gathers/scatters over the flat
state.  This engine removes all indexed memory access: the Pauli state is
held as two symplectic bitplanes (X-component, Z-component) of shape
(..., nq), and for each conflict-free color

  1. proposal planes are XORs with the color's static op-component masks,
  2. per-stabilizer per-Pauli count deltas are matmuls of elementwise
     plane differences with the color's static selection matrix,
  3. the accept mask is scattered back with the transpose matmul.

Same stationary distribution as the other engines (validated against exact
enumeration in tests/test_metropolis.py); dense elementwise and matmul work,
zero gathers (SURVEY 7.1 #2).  It is the plain reference of the Pallas
sweep kernel (ops/sweep_kernel.py).
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import CodeSpec


@functools.lru_cache(maxsize=None)
def _color_tables(spec: CodeSpec):
    """Per color: selection matrix (W, nq) and op-component masks (nq,)."""
    tables = []
    for color in spec.color_stabs:
        stabs = [int(s) for s in color if s < spec.n_stabs]
        W = len(stabs)
        sel = np.zeros((W, spec.nq), dtype=np.int8)
        xop = np.zeros(spec.nq, dtype=np.uint8)
        zop = np.zeros(spec.nq, dtype=np.uint8)
        for i, s in enumerate(stabs):
            for q, o in zip(spec.stab_qubits[s], spec.stab_ops[s]):
                if o != 0:
                    sel[i, q] = 1
                    xop[q] = (o & 1) ^ ((o >> 1) & 1)  # X component
                    zop[q] = (o >> 1) & 1  # Z component
        tables.append((sel, xop, zop))
    return tables


def sweep_logu(spec: CodeSpec, key: jax.Array, batch_shape) -> jax.Array:
    """The log-uniforms one dense sweep draws: (n_colors, *batch_shape,
    Wmax), Wmax the widest color."""
    tables = _color_tables(spec)
    wmax = max(sel.shape[0] for sel, _, _ in tables)
    return jnp.log(
        jax.random.uniform(key, (len(tables),) + tuple(batch_shape) + (wmax,),
                           minval=1e-38)
    )


def make_dense_sweep(spec: CodeSpec):
    """``sweep(state, key, betas) -> state``: one full colored sweep
    (n_stabs effective proposals) with dense bitplane arithmetic.

    ``state``: (..., nq) uint8 batched; ``betas``: (3,) or batched.
    """
    tables = _color_tables(spec)
    # contraction operands are bf16 with f32 accumulation: the values are
    # small integers, so this is exact.  int8 operands with int32
    # accumulation return wrong sums for some shapes on the GPU (measured
    # on an H100 with jax 0.9.0), which silently corrupts the sampler.
    sels = [jnp.asarray(sel, jnp.bfloat16) for sel, _, _ in tables]
    xops = [jnp.asarray(x) for _, x, _ in tables]
    zops = [jnp.asarray(z) for _, _, z in tables]
    Ws = [sel.shape[0] for sel, _, _ in tables]
    n_colors = len(tables)

    def sweep(state: jax.Array, key: jax.Array, betas: jax.Array) -> jax.Array:
        batch_shape = state.shape[:-1]
        betas_b = jnp.broadcast_to(betas, batch_shape + (3,)).astype(jnp.float32)
        b0 = (state & 1) ^ ((state >> 1) & 1)  # X component plane
        b1 = (state >> 1) & 1  # Z component plane
        logu_all = sweep_logu(spec, key, batch_shape)
        for c in range(n_colors):
            sel = sels[c]  # (W, nq) bf16
            xop, zop = xops[c], zops[c]  # (nq,) uint8
            nb0 = b0 ^ xop
            nb1 = b1 ^ zop
            # per-Pauli occupancy deltas, elementwise
            d1 = (nb0 & (1 - nb1)).astype(jnp.int8) - (b0 & (1 - b1)).astype(jnp.int8)
            d2 = (nb0 & nb1).astype(jnp.int8) - (b0 & b1).astype(jnp.int8)
            d3 = ((1 - nb0) & nb1).astype(jnp.int8) - ((1 - b0) & b1).astype(jnp.int8)
            # per-stabilizer deltas: (..., nq) @ (nq, W)
            def contract(d):
                return jax.lax.dot_general(
                    d.astype(jnp.bfloat16), sel.T,
                    dimension_numbers=(((d.ndim - 1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )

            dn1, dn2, dn3 = contract(d1), contract(d2), contract(d3)
            logr = -(
                betas_b[..., 0:1] * dn1
                + betas_b[..., 1:2] * dn2
                + betas_b[..., 2:3] * dn3
            )  # (..., W)
            accept = (logu_all[c][..., : Ws[c]] < logr).astype(jnp.bfloat16)
            # scatter accepts back to qubits: (..., W) @ (W, nq)
            acc_q = jax.lax.dot_general(
                accept, sel,
                dimension_numbers=(((accept.ndim - 1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ).astype(jnp.uint8)  # (..., nq) in {0, 1}
            b0 = b0 ^ (xop * acc_q)
            b1 = b1 ^ (zop * acc_q)
        # rebuild Pauli values: v = xcomp*1 XOR zcomp*3 (X=1, Z=3, Y=2)
        return ((b0 * 1) ^ (b1 * 3)).astype(jnp.uint8)

    return sweep
