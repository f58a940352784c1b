"""Pallas kernel (Triton route) for the dense colored Metropolis sweep.

Same proposals, acceptance rule and color order as ``ops/dense_sweep.py``.
The XLA form re-reads and re-writes chain-sized arrays several times per
color; here one program keeps a tile of chains in registers across every
color of ``n_sweeps`` sweeps, so the state crosses device memory once in
and once out per call.

Per color the kernel

  1. XORs the chain with the color's stabilizer Paulis (the proposal),
  2. encodes each qubit's per-Pauli occupancy change as one small integer
     ``dX + 9 dY + 81 dZ`` (each d in {-1, 0, 1}) and contracts it with the
     color's 0/1 selection matrix in ONE ``pl.dot``; every stabilizer
     touches at most four qubits, so each per-stabilizer sum stays in
     [-364, 364] and decodes exactly into (dn_X, dn_Y, dn_Z),
  3. accepts with ``logu < -(bx dn_X + by dn_Y + bz dn_Z)`` -- the same
     expression, in the same order, as the dense sweep,
  4. scatters the accepts back to qubits with a second ``pl.dot``.

Dot operands are bf16 with f32 accumulation: the operands are integers of
magnitude <= 81 and the sums are <= 364, so bf16 and f32 hold every value
exactly and the contractions are exact.

Uniforms come from a counter-based hash in the kernel, keyed by (seed,
chain, sweep, color, slot).  An optional ``logu`` operand laid out as
``dense_sweep.sweep_logu`` draws it replaces the generator; with it the
kernel's output equals ``make_dense_sweep``'s chain for chain.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..models.base import CodeSpec
from .dense_sweep import _color_tables

# per-qubit occupancy code of a Pauli value v (I=0, X=1, Y=2, Z=3):
# (CODE_LUT >> 8 v) & 0xFF = 0, 1, 9, 81
_CODE_LUT = (1 << 8) | (9 << 16) | (81 << 24)
# offset that makes a per-stabilizer code sum non-negative (4 * (1+9+81))
_CODE_OFFSET = 364
# a program's chain tile holds about this many qubit slots; wider tiles
# spill registers (measured on an H100: TB=32 at 512 qubit slots ran 20x
# slower than TB=16)
_TILE_SLOTS = 4096
# widest code the kernel holds: a color's selection tile must fit a
# program's shared memory (1024 padded qubits asked for 589,824 B of the
# 232,448 B an H100 program has)
MAX_QUBITS = 512


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _fmix32(h):
    """murmur3's 32-bit finalizer (a bijection with full avalanche)."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> 16)


def _hash_logu(seed, chain, ctr):
    """log of a uniform in (0, 1) for each (chain, counter) pair."""
    h = _fmix32(chain.astype(jnp.uint32) * jnp.uint32(0x9E3779B1) ^ seed)
    h = _fmix32(h + ctr.astype(jnp.uint32) * jnp.uint32(0x632BE5AB))
    h = _fmix32(h ^ seed)
    top24 = (h >> 8).astype(jnp.int32).astype(jnp.float32)
    return jnp.log((top24 + 0.5) * (1.0 / 16777216.0))


@functools.lru_cache(maxsize=None)
def _kernel_tables(spec: CodeSpec):
    """(ops (C, NQP) int32, sel (C, WPmax, NQP) bf16, widths W_c, padded
    widths WP_c) with qubits padded to a power of two."""
    tables = _color_tables(spec)
    nqp = max(32, _pow2(spec.nq))
    widths = tuple(sel.shape[0] for sel, _, _ in tables)
    pwidths = tuple(max(16, _pow2(w)) for w in widths)
    ops = np.zeros((len(tables), nqp), np.int32)
    sel_all = np.zeros((len(tables), max(pwidths), nqp), np.float32)
    for c, (sel, xop, zop) in enumerate(tables):
        # Pauli value of the color's stabilizer at each qubit: X=1, Y=2, Z=3
        ops[c, : spec.nq] = xop.astype(np.int32) ^ (3 * zop.astype(np.int32))
        sel_all[c, : sel.shape[0], : spec.nq] = sel
    return ops, sel_all, widths, pwidths


def _default_tiling(spec: CodeSpec):
    """(chains per program, warps per program) for this code's width."""
    nqp = max(32, _pow2(spec.nq))
    return int(np.clip(_TILE_SLOTS // nqp, 16, 128)), 8 if nqp >= 256 else 4


def make_kernel_sweep(spec: CodeSpec, n_sweeps: int, *,
                      interpret: bool = False):
    """``fn(state, key, betas, logu=None) -> state``: ``n_sweeps`` full
    colored sweeps in one kernel call.

    ``state``: (..., nq) uint8, any batch shape and size (padded
    internally); ``betas``: (3,) or broadcastable to (..., 3), so PT rungs
    can run at their own temperatures; ``key``: a PRNG key seeding the
    in-kernel generator.  ``logu``: optional (n_sweeps, n_colors, ...,
    Wmax) log-uniforms in ``dense_sweep.sweep_logu``'s layout, one slab
    per sweep, used in place of the generator.

    The compiled kernel exists only for NVIDIA GPUs; on any other backend
    ``interpret=True`` must be given to run it through the Pallas
    interpreter.  Codes of more than ``MAX_QUBITS`` qubits are refused.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the sweep kernel compiles only for a GPU backend (found "
            f"{jax.default_backend()!r}); pass interpret=True to run it "
            "through the Pallas interpreter"
        )
    if spec.nq > MAX_QUBITS:
        raise ValueError(
            f"the sweep kernel holds codes of up to {MAX_QUBITS} qubits; "
            f"{spec.family} d={spec.size} has {spec.nq}: use engine='sweep'"
        )
    ops_np, sel_np, widths, pwidths = _kernel_tables(spec)
    n_colors, wpmax, nqp = sel_np.shape
    nq = spec.nq
    tb, num_warps = _default_tiling(spec)
    wmax = max(widths)

    def kernel(seed_ref, bx_ref, by_ref, bz_ref, ops_ref, sel_ref, *rest):
        if len(rest) == 3:
            logu_ref, state_ref, out_ref = rest
        else:
            logu_ref = None
            state_ref, out_ref = rest
        pid = pl.program_id(0)
        v = state_ref[...].astype(jnp.int32)  # (TB, NQP) Pauli values
        bx = bx_ref[...][:, None]
        by = by_ref[...][:, None]
        bz = bz_ref[...][:, None]
        seed = seed_ref[0]
        lut = jnp.int32(_CODE_LUT)

        def code(x):
            return jnp.right_shift(lut, x * 8) & 0xFF

        def one_sweep(t, v):
            for c in range(n_colors):
                wp = pwidths[c]
                op = ops_ref[c, :][None, :]  # (1, NQP)
                sel = sel_ref[c, pl.ds(0, wp), :]  # (WP, NQP) bf16
                nv = v ^ op
                dcode = (code(nv) - code(v)).astype(jnp.bfloat16)
                s = jax.lax.dot_general(
                    dcode, sel, (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )  # (TB, WP) exact integer sums
                e = s.astype(jnp.int32) + _CODE_OFFSET
                q9 = jax.lax.div(e, 9)
                dn1 = (e - 9 * q9 - 4).astype(jnp.float32)
                q81 = jax.lax.div(e, 81)
                dn2 = (q9 - 9 * q81 - 4).astype(jnp.float32)
                dn3 = (q81 - 4).astype(jnp.float32)
                logr = -(bx * dn1 + by * dn2 + bz * dn3)
                if logu_ref is not None:
                    logu = logu_ref[t, c, :, pl.ds(0, wp)]
                else:
                    shape = (tb, wp)
                    chain = (pid * tb
                             + jax.lax.broadcasted_iota(jnp.int32, shape, 0))
                    slot = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
                    logu = _hash_logu(seed, chain,
                                      (t * n_colors + c) * wpmax + slot)
                accept = (logu < logr).astype(jnp.bfloat16)
                acc_q = jnp.dot(accept, sel,
                                preferred_element_type=jnp.float32)
                v = jnp.where(acc_q > 0.5, nv, v)
            return v

        v = jax.lax.fori_loop(0, n_sweeps, one_sweep, v)
        out_ref[...] = v.astype(jnp.uint8)

    ops_j = jnp.asarray(ops_np)
    sel_j = jnp.asarray(sel_np, jnp.bfloat16)

    def fn(state: jax.Array, key: jax.Array, betas: jax.Array,
           logu: Optional[jax.Array] = None) -> jax.Array:
        batch_shape = state.shape[:-1]
        b = math.prod(batch_shape)
        bp = _round_up(max(b, 1), tb)
        x = jnp.pad(state.reshape(b, nq).astype(jnp.uint8),
                    ((0, bp - b), (0, nqp - nq)))
        bt = jnp.broadcast_to(jnp.asarray(betas, jnp.float32),
                              batch_shape + (3,)).reshape(b, 3)
        bt = jnp.pad(bt, ((0, bp - b), (0, 0)))
        seed = jax.random.bits(key, (1,), jnp.uint32)
        args = [seed, bt[:, 0], bt[:, 1], bt[:, 2], ops_j, sel_j]
        in_specs = [
            pl.BlockSpec((1,), lambda i: (0,)),
            pl.BlockSpec((tb,), lambda i: (i,)),
            pl.BlockSpec((tb,), lambda i: (i,)),
            pl.BlockSpec((tb,), lambda i: (i,)),
            pl.BlockSpec((n_colors, nqp), lambda i: (0, 0)),
            pl.BlockSpec((n_colors, wpmax, nqp), lambda i: (0, 0, 0)),
        ]
        if logu is not None:
            lg = jnp.asarray(logu, jnp.float32).reshape(
                n_sweeps, n_colors, b, wmax)
            lg = jnp.pad(lg, ((0, 0), (0, 0), (0, bp - b), (0, wpmax - wmax)))
            args.append(lg)
            in_specs.append(pl.BlockSpec((n_sweeps, n_colors, tb, wpmax),
                                         lambda i: (0, 0, i, 0)))
        args.append(x)
        in_specs.append(pl.BlockSpec((tb, nqp), lambda i: (i, 0)))
        out = pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct((bp, nqp), jnp.uint8),
            grid=(bp // tb,),
            in_specs=in_specs,
            out_specs=pl.BlockSpec((tb, nqp), lambda i: (i, 0)),
            interpret=interpret,
            backend="triton",
            compiler_params=pl_triton.CompilerParams(
                num_warps=num_warps, num_stages=1),
            name=f"sweep_kernel_{spec.family}{spec.size}",
        )(*args)
        return out[:b, :nq].reshape(state.shape)

    return fn
