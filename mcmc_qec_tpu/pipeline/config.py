"""Canonical run configuration.

The schema keys mirror the reference's ``params`` dicts exactly
(generate_data.py:278-296, generate_data_noise_models.py:201-229,
test_decoders.py:30-46) so reference-driven runs translate 1:1, plus
batching additions (batch, seed, window, engine).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional


@dataclasses.dataclass
class RunConfig:
    # --- reference keys (generate_data.py:278-296) ---
    code: str = "toric"  # toric | planar | rotated | xzzx
    method: str = "PTEQ"  # PTEQ | PTEQ_alpha | PTEQ_biased | PTDC | PTRC |
    #                       STDC | STDC_N_n | ST | STRC | eMWPM | MWPM
    size: int = 5
    noise: str = "depolarizing"  # depolarizing | uncorrelated | biased | alpha
    p_error: float = 0.1
    eta: float = 0.5
    alpha: float = 1.0
    p_sampling: Optional[float] = None
    droplets: int = 4
    mwpm_init: bool = False
    fixed_errors: Optional[int] = None
    Nc: Optional[int] = None
    iters: int = 10
    conv_criteria: str = "error_based"
    SEQ: int = 2
    TOPS: int = 10
    eps: float = 0.1
    steps: Optional[int] = None  # defaults to 5 * size**5 (generate_data.py:296)

    # --- batching additions ---
    batch: int = 64  # syndromes decoded per device step
    seed: int = 0
    # auto (default: the fastest path per decoder family and backend,
    # resolved in ops/engines.py) | literal (reference-cadence parity
    # mode, orders of magnitude slower) | sweep (XLA colored sweep) |
    # kernel (the colored sweep as one Pallas kernel; GPU only)
    engine: str = "auto"
    max_steps: int = 200_000  # PTEQ step cap per batch
    window: int = 200  # PTEQ device window
    checkpoint_every: int = 50  # datapoints between checkpoints
    #                             (generate_data.py:251)
    # mid-decode resilience: with ckpt_dir set, PTEQ-family decodes
    # snapshot their full sampler state (ladder, accumulators, PRNG) under
    # ckpt_dir/batch_<offset>/ and a preempted generate() resumes the
    # in-flight batch bit-identically (combine with the dataset checkpoint
    # above + append=True for the completed batches)
    ckpt_dir: Optional[str] = None
    # observability: JSONL metrics stream (per-window swap acceptance,
    # tops0 rate, energy ESS for PTEQ; unique-discovery saturation for
    # STDC).  None = off.
    metrics_path: Optional[str] = None
    # re-attempt a failed batch decode this many times (0: a device fault
    # fails the run).  With ckpt_dir set, PTEQ retries resume mid-decode
    # from the batch's snapshot instead of restarting it.
    retries: int = 0
    retry_wait: float = 5.0  # seconds between attempts (linear backoff)

    def __post_init__(self):
        if self.steps is None:
            self.steps = int(5 * self.size**5)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "RunConfig":
        return cls(**json.loads(s))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
