"""Chain-scaling efficiency across the device mesh (weak scaling).

North-star target: >= 80% efficiency scaling the syndrome batch over
devices.  On CPU this runs on the virtual 8-device mesh — NOTE: the 8
virtual devices share the machine's physical cores, so CPU "efficiency"
is capped at n_physical_cores/n_devices and only validates that the
sharded program runs and scales onto whatever silicon exists.  Real
efficiency must be measured on a pod slice, where the same code exercises
ICI.

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/scaling_bench.py --cpu    # virtual 8-device CPU mesh
      python examples/scaling_bench.py          # real device(s)
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    import os

    if "host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
    import jax

    # --cpu: force the virtual 8-device CPU mesh.  This must happen BEFORE
    # any jax.devices()/device_count() call — the first device query locks
    # the backend and jax_platforms updates are ignored afterwards.
    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    elif jax.device_count() == 1 and jax.devices()[0].platform != "gpu":
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from mcmc_qec_tpu.models import get_spec
    from mcmc_qec_tpu.models.noise import sample_depolarizing
    from mcmc_qec_tpu.mcmc.ladder import betas_depolarizing
    from mcmc_qec_tpu.decoders.stdc import _class_seeds, _get_stdc_fn
    from mcmc_qec_tpu.parallel import make_mesh, shard_batch

    spec = get_spec("toric", 5)
    per_dev = 16
    steps, droplets = 200, 2
    n_devices = len(jax.devices())
    results = {}
    for nd in [d for d in (1, 2, 4, 8) if d <= n_devices]:
        mesh = make_mesh(nd)
        B = per_dev * nd
        states = np.asarray(
            sample_depolarizing(jax.random.PRNGKey(0), spec, 0.1, (B,))
        )
        seeds = _class_seeds(spec, states)
        fn = _get_stdc_fn(spec, droplets, steps, True, False, 0.0, "sweep")
        args = (
            shard_batch(seeds, mesh),
            jax.random.PRNGKey(1),
            jnp.asarray(betas_depolarizing(0.25), jnp.float32),
            jnp.asarray(betas_depolarizing(0.1), jnp.float32),
        )
        out = fn(*args)
        jax.block_until_ready(out)
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(*args)
            jax.block_until_ready(out)
            best = max(best, B / (time.perf_counter() - t0))
        results[nd] = best
        base = results[1] if 1 in results else best / nd
        eff = best / (nd * results.get(1, best))
        print(
            f"devices={nd}: {best:8.1f} syndromes/s  "
            f"(weak-scaling efficiency {100*eff:.0f}%)",
            flush=True,
        )


if __name__ == "__main__":
    main()
