"""Engine selection: map the user-facing ``engine`` knob to a concrete
sampler implementation.

``"auto"`` -- the default on every decoder entry point and in
``pipeline.RunConfig`` -- resolves here, and only here, to the fastest
path for the decoder family and code width on the current backend.
``"literal"`` is the opt-in parity mode reproducing the reference's
one-random-stabilizer-per-update cadence (src/mcmc.py:82-103) -- useful
for apples-to-apples statistical comparisons, orders of magnitude slower.

Concrete engines:
 - ``sweep``:  conflict-free-colored full sweeps via XLA (all backends)
 - ``kernel``: the same sweeps in one Pallas kernel per call
   (ops/sweep_kernel.py); compiled for NVIDIA GPUs only -- elsewhere the
   builders raise unless asked for the Pallas interpreter explicitly
"""

from __future__ import annotations

import jax

from ..models.base import CodeSpec

VALID_ENGINES = ("auto", "literal", "sweep", "kernel")

# widest code (in qubits) for which "auto" picks the sweep kernel on a GPU,
# per decoder family, from kernel-vs-XLA-sweep timings on an H100.  The PT
# window runs ``iters`` sweeps per kernel call and gains up to toric d=13
# (512 padded qubits, the kernel's limit); the counting samplers run one
# sweep per call and gain at toric d=9 (256 padded qubits) but lose 2x at
# d=13.
_KERNEL_MAX_QUBITS = {"pteq": 512, "counting": 256}


def resolve_engine(engine: str, kind: str, spec: CodeSpec) -> str:
    """Resolve ``"auto"`` for a decoder family on ``spec``'s code.

    kind: ``"pteq"`` (PT-ladder window decoders), ``"counting"``
    (STDC/STRC droplet samplers and the PTDC/PTRC ladders: one sweep per
    recorded step), ``"chain"`` (plain ladder/static paths).
    """
    if engine not in VALID_ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; expected one of {VALID_ENGINES}"
        )
    if engine != "auto":
        return engine
    if (spec.nq <= _KERNEL_MAX_QUBITS.get(kind, 0)
            and jax.default_backend() == "gpu"):
        return "kernel"
    return "sweep"
