"""Multi-process orchestration: runs without SLURM file shuffling.

The reference scales out with SLURM array tasks writing pickle files that
are merged offline (generate_data.py:274-308, concat_data.py).  Here every
process decodes its shard of the syndrome batch on its default device and
results are aggregated in-band with ``process_allgather``.

On a multi-GPU host the supported layout is one process per card, each
pinned to its own card (``CUDA_VISIBLE_DEVICES=<rank>``): a JAX process
reserves most of the memory of every card it can see, so unpinned
processes would starve each other.

Single-process execution is the degenerate case (process_count() == 1), so
all of this is exercised by the regular test suite; the same code paths run
unchanged after ``init_distributed()``.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from .mesh import make_mesh


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu_collectives: Optional[str] = "gloo",
    platform: Optional[str] = None,
) -> None:
    """Initialize jax.distributed (no-op when already initialized).

    ``platform`` pins ``jax_platforms`` (e.g. "cpu") BEFORE backend
    initialization.  On the CPU backend, cross-process collectives
    need an explicit implementation; ``cpu_collectives`` selects it (gloo
    ships with jax).  This is what makes the multi-process paths testable
    without a cluster — see tests/test_multiprocess.py.

    When ``num_processes`` is given, the joined world size is verified —
    a silent fallback to single-process would make every rank decode the
    FULL batch (and write conflicting outputs) instead of its shard."""
    if platform is not None:
        jax.config.update("jax_platforms", platform)
    if cpu_collectives is not None:
        try:
            if (platform or jax.config.jax_platforms) == "cpu":
                jax.config.update(
                    "jax_cpu_collectives_implementation", cpu_collectives
                )
        except Exception:
            pass  # backend already initialized or unknown implementation
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already" not in str(e) and "once" not in str(e):
            raise
    if num_processes is not None and jax.process_count() != num_processes:
        raise RuntimeError(
            f"jax.distributed joined {jax.process_count()} process(es), "
            f"expected {num_processes} — the backend was likely initialized "
            "before init_distributed (pass platform=... or call earlier)"
        )


def host_shard(n_total: int) -> slice:
    """This process's contiguous shard of a global batch of ``n_total``."""
    p = jax.process_index()
    n = jax.process_count()
    per = -(-n_total // n)
    return slice(p * per, min((p + 1) * per, n_total))


def allgather_rows(local: np.ndarray) -> np.ndarray:
    """Gather per-process result rows to every process (identity in
    single-process runs)."""
    if jax.process_count() == 1:
        return np.asarray(local)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(local, tiled=True))


def global_sum(value) -> np.ndarray:
    """Sum a small array across processes (identity single-process)."""
    if jax.process_count() == 1:
        return np.asarray(value)
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(np.asarray(value))
    return np.asarray(gathered).sum(axis=0)


def distributed_generate(file_path, cfg, nbr_datapoints, progress=None):
    """Multi-process variant of pipeline.generate: each process decodes its
    shard with seed ``cfg.seed + rank``; process 0 persists the gathered
    dataset."""
    from ..pipeline.generate import generate as _generate
    import dataclasses

    sl = host_shard(nbr_datapoints)
    n_local = max(sl.stop - sl.start, 0)
    per = -(-nbr_datapoints // jax.process_count())
    local_cfg = dataclasses.replace(cfg, seed=cfg.seed + jax.process_index())
    ds = _generate(None, local_cfg, n_local, progress=progress)

    def pad_rows(a):
        # process_allgather needs equal shapes on every host: pad the ragged
        # last shard and mark padding rows invalid (true_class = -1)
        a = np.asarray(a)
        if len(a) == per:
            return a
        pad_shape = (per - len(a),) + a.shape[1:]
        return np.concatenate([a, np.zeros(pad_shape, a.dtype)], axis=0)

    qms = allgather_rows(pad_rows(ds.qubit_matrices.reshape(len(ds), -1)))
    distrs = allgather_rows(pad_rows(ds.distributions))
    trues_local = pad_rows(ds.true_classes)
    trues_local[len(ds):] = -1
    trues = allgather_rows(trues_local)
    keep = trues >= 0
    qms, distrs, trues = qms[keep], distrs[keep], trues[keep]
    from ..pipeline.dataset import Dataset
    from ..models import get_spec

    spec = get_spec(cfg.code, cfg.size)
    merged = Dataset(
        qubit_matrices=qms.reshape((-1,) + spec.state_shape),
        distributions=distrs,
        true_classes=trues,
        config=cfg,
    )
    if file_path and jax.process_index() == 0:
        merged.save(file_path)
    return merged
