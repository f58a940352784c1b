"""mcmc_qec_tpu: a batched MCMC quantum-error-correction decoding framework.

A ground-up JAX/XLA/Pallas redesign with the capability surface of the
reference research code (QEC-project-2020/MCMC-QEC-toric-RL): four surface
code families (toric/planar/rotated/xzzx), the full MCMC decoder suite
(PTEQ/ST/STDC/STRC/PTDC/PTRC plus biased/alpha variants), MWPM warm starts
backed by a native C++ exact matching solver, and a batched data-generation
pipeline that decodes whole syndrome batches per device step.
"""

import os

# fixed in-checkout default: the cache key includes the path, so a cache
# that moves never hits
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def _enable_compilation_cache() -> None:
    """Persistent XLA compilation cache.  The decoder programs are large
    (a full PTEQ window or STDC decode takes the compiler seconds to
    minutes per shape); cached binaries reload in well under a second.
    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself when it is set; otherwise
    the cache lives in ``DEFAULT_CACHE_DIR`` inside the checkout.  Disable
    it with ``jax.config.update("jax_enable_compilation_cache", False)``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)


_enable_compilation_cache()

from . import models, ops

__version__ = "0.1.0"
