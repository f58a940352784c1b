"""PTEQ: parallel-tempering equivalence-class occupation decoding.

Batched redesign of ``PTEQ``/``PTEQ_biased``/``PTEQ_alpha``
(decoders.py:25-105, decoders_biasednoise.py:28-237): the ladder runs fully
on device, batched over a syndrome axis; the host only sees windowed
summaries (class-occupation counts, per-step bottom energies, tops0) and
runs the convergence automaton at window granularity.

Differences from the reference (statistically equivalent, documented):
- convergence ("felkriteriet") is evaluated once per window of W ladder
  steps instead of every step, so a run may take up to W-1 extra steps;
- all syndromes in the batch run until every one of them converged (or the
  step cap); each element's distribution is snapshotted at the end of the
  window in which it converged;
- RNG is explicit counter-based jax.random instead of unseeded global RNG.

The returned distribution matches the reference's quantized uint8
percentages (decoders.py:89).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import CodeSpec
from ..mcmc.ladder import (
    LadderState,
    beta_ladder_alpha,
    beta_ladder_biased,
    beta_ladder_depolarizing,
    init_ladder,
    make_ladder_step,
)
from .convergence import EnergyHistory, error_based_accept


@dataclasses.dataclass(frozen=True)
class PTEQConfig:
    """PT parameters; defaults follow decoders.py:25 / generate_data.py:290."""

    Nc: Optional[int] = None  # ladder length; defaults to lattice size
    SEQ: int = 2
    TOPS: int = 10
    tops_burn: int = 2
    eps: float = 0.1
    max_steps: int = 1_000_000
    iters: int = 10
    p_logical: float = 0.5
    window: int = 100
    conv_criteria: str = "error_based"
    # auto (resolved per backend in ops/engines.py) | literal (reference
    # cadence, opt-in parity mode) | sweep (XLA colored sweeps) | kernel
    # (the same sweeps in one Pallas kernel per ladder step; GPU only).
    # track_shortest runs its dedup fully on device (bounded unique-key
    # buffers in the scan carry).
    engine: str = "auto"
    # replica-exchange schedule: "sequential" (reference parity — the
    # top->bottom sweep, mcmc.py:96-99) or "even_odd" (all even pairs then
    # all odd pairs; same stationary distribution per SURVEY §7.1 #4, no
    # serial cross-pair dependence chain; measured tops0 round-trip rate
    # within ~5% of sequential at d=5 — see
    # RESULTS.md "Even/odd replica exchange" for the measured tradeoff)
    exchange: str = "sequential"
    # energy-trace coarsening: the device returns per-chunk means instead
    # of per-step energies (the felkriteriet quarter means are unchanged at
    # chunk resolution, and the host fetches C times less).  Must divide
    # ``window``.
    energy_chunk: int = 4
    # bounded convergence-automaton memory: the energy history keeps at
    # most cum_rows_cap group rows per element (group span doubles when the
    # cap is hit), so host RAM is O(B * cum_rows_cap) for any max_steps —
    # see decoders/convergence.EnergyHistory for the accuracy argument
    cum_rows_cap: int = 4096
    # track_shortest: per-(element, class) cap on the on-device buffer of
    # unique shortest-n_eff chain keys.  The reference's host sets are
    # unbounded (decoders_biasednoise.py:112-144); beyond the cap the
    # unique count saturates and PTEQResult.shortest_overflow flags it.
    shortest_unique_cap: int = 128
    # batch compaction: once the alive (unconverged) fraction of the
    # current device batch drops to <= compact_frac, repack the stragglers
    # into the next power-of-two bucket so converged syndromes stop
    # consuming device time.  Each new bucket shape compiles once
    # (persistently cached); min_compact bounds the number of buckets.
    # compact=False pins the original batch shape.
    compact: bool = True
    compact_frac: float = 0.5
    min_compact: int = 128
    # adaptive window growth: once the batch compacts, per-window device
    # time shrinks and the host fetch cadence can bound the straggler
    # phase.  After compacting by factor f the window grows by
    # min(f, window_scale_cap), keeping device work per host fetch roughly
    # constant.  Convergence checks coarsen with the window (the documented
    # "up to W-1 extra steps" semantics, applied to the grown window).
    # Scaling only applies on the pipelined path (it is disabled under
    # checkpointing, whose snapshots are fixed-window) and without
    # track_shortest.  1 disables.  Off by default: fetch batching
    # (pipeline_depth_cap) gives the same effect without coarsening the
    # convergence checks.
    window_scale_cap: int = 1
    # fetch batching: after compaction the host keeps up to
    # min(pipeline_depth_cap, B / Br) windows in flight and fetches their
    # summaries in ONE bundled device_get instead of one fetch per
    # window.  Convergence labels
    # and snapshots still use each window's own data — identical to the
    # depth-1 loop — only the *reactions* (early exit, compaction) lag by
    # up to the group, which costs at most a few cheap small-bucket
    # windows.  1 disables (plain depth-1 pipelining).
    pipeline_depth_cap: int = 8
    # explicit fixed pipeline depth from the first window (None = adaptive:
    # depth 1 at full batch, deepening with compaction).  Set this when the
    # whole run is small enough to be fetch-latency-bound from the start.
    pipeline_depth: Optional[int] = None
    # exact mid-decode checkpoint/resume: with ckpt_dir set, the full run
    # state (ladder, accumulators, convergence automaton, PRNG key, row
    # map) is snapshotted every ckpt_every windows and a preempted run
    # resumes bit-identically from the latest snapshot.  The reference only
    # checkpoints pipeline *outputs* (generate_data.py:251-256) — chain
    # state and RNG are lost on preemption there.
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 25


@dataclasses.dataclass
class PTEQResult:
    distribution: np.ndarray  # (B, n_classes) uint8 percentages
    converged: np.ndarray  # (B,) bool
    steps: np.ndarray  # (B,) steps taken at snapshot
    tops0: np.ndarray  # (B,)
    # with track_shortest (PTEQ_alpha_with_shortest,
    # decoders_biasednoise.py:163-172):
    shortest_boltzmann: Optional[np.ndarray] = None  # (B, K) percentages
    shortest_counts: Optional[np.ndarray] = None  # (B, K) percentages
    # (B, K) True where the unique-shortest buffer overflowed
    # (shortest_unique_cap); unique counts there are lower bounds
    shortest_overflow: Optional[np.ndarray] = None
    # device-batch sizes after each compaction (empty = never compacted)
    buckets: Tuple[int, ...] = ()


class ShortestState(NamedTuple):
    """On-device shortest-n_eff tracking (decoders_biasednoise.py:112-144):
    per (element, class) the running minimal energy, the
    number of samples at that minimum, and a bounded buffer of distinct
    chain keys at that minimum (dedup via ops/pauli.pack_key 64-bit
    universal hashes instead of host Python sets).  Lives in the window
    scan carry — no per-step host traffic."""

    val: jax.Array  # (B, K) f32 running min energy (+inf init)
    cnt: jax.Array  # (B, K) i32 samples at the min
    nuq: jax.Array  # (B, K) i32 distinct keys recorded at the min
    ovf: jax.Array  # (B, K) bool buffer overflow (nuq saturated)
    keys: jax.Array  # (B, K, U, KEY_W) i32 distinct-key buffer


# key width: pack_key's two u32 halves, bitcast to i32
KEY_W = 2


def init_shortest(B: int, K: int, U: int) -> ShortestState:
    return ShortestState(
        val=jnp.full((B, K), jnp.inf, jnp.float32),
        cnt=jnp.zeros((B, K), jnp.int32),
        nuq=jnp.zeros((B, K), jnp.int32),
        ovf=jnp.zeros((B, K), bool),
        keys=jnp.zeros((B, K, U, KEY_W), jnp.int32),
    )


def _shortest_update(sh: ShortestState, eq: jax.Array, kk: jax.Array,
                     e: jax.Array, burned: jax.Array) -> ShortestState:
    """One post-step update: element b's class-``eq[b]`` row sees a chain
    with key ``kk[b]`` at energy ``e[b]`` (ignored unless ``burned[b]``).
    A strictly smaller energy resets the row; an equal energy increments
    the count and appends the key if unseen (O(U) membership compare).

    Implemented as dense masked updates over the full (B, K, ...) arrays
    (K is 4 or 16), so the scan body has no per-class scatter/gather."""
    B, K = sh.val.shape
    U = sh.keys.shape[2]
    onek = jnp.arange(K)[None, :] == eq[:, None]  # (B, K)
    gate = onek & (burned > 0)[:, None]
    e_bk = e[:, None]
    better = gate & (e_bk < sh.val)  # (B, K)
    equal = gate & (e_bk == sh.val)
    slot_idx = jnp.arange(U)[None, None, :]  # (1, 1, U)
    valid = slot_idx < sh.nuq[..., None]  # (B, K, U)
    match = jnp.all(sh.keys == kk[:, None, None, :], axis=-1)  # (B, K, U)
    present = jnp.any(valid & match, axis=-1)  # (B, K)
    append = equal & ~present & (sh.nuq < U)
    ovf_new = equal & ~present & (sh.nuq >= U)
    write = better | append
    slot = jnp.where(better, 0, sh.nuq)  # (B, K)
    onehot = slot_idx == slot[..., None]  # (B, K, U)
    buf_base = jnp.where(better[..., None, None],
                         jnp.zeros_like(sh.keys), sh.keys)
    new_keys = jnp.where((write[..., None] & onehot)[..., None],
                         kk[:, None, None, :], buf_base)
    return ShortestState(
        val=jnp.where(better, e_bk, sh.val),
        cnt=jnp.where(better, 1, sh.cnt + equal.astype(jnp.int32)),
        nuq=jnp.where(better, 1, sh.nuq + append.astype(jnp.int32)),
        ovf=jnp.where(better, False, sh.ovf | ovf_new),
        keys=new_keys,
    )


_WINDOW_CACHE = {}


def _get_window_fn(spec: CodeSpec, Nc: int, cfg: PTEQConfig,
                   track_shortest: bool = False,
                   top_exact_accept: bool = False):
    from ..ops.engines import resolve_engine

    if cfg.exchange not in ("sequential", "even_odd"):
        # the kernel-level "none" ablation is not a valid sampler — it
        # must not be reachable through the decoder config
        raise ValueError(
            f"exchange={cfg.exchange!r}: expected 'sequential' or 'even_odd'"
        )
    C = cfg.energy_chunk
    engine = resolve_engine(cfg.engine, "pteq", spec)
    key = (spec.family, spec.size, Nc, cfg.iters, cfg.p_logical, cfg.window,
           cfg.tops_burn, track_shortest, engine, top_exact_accept, C,
           cfg.shortest_unique_cap, cfg.exchange)
    if key in _WINDOW_CACHE:
        return _WINDOW_CACHE[key]

    ladder_step = make_ladder_step(spec, Nc, cfg.iters, cfg.p_logical,
                                   engine=engine,
                                   top_exact_accept=top_exact_accept,
                                   exchange=cfg.exchange)
    if track_shortest:
        from ..ops.pauli import make_hash_mults, pack_key

        mults = jnp.asarray(make_hash_mults(spec))

    def window(ls: LadderState, rkey, betas, eq_count, since_burn, weights,
               sh: Optional[ShortestState] = None):
        """Run cfg.window ladder steps; accumulate post-burn class counts.

        weights: (3,) energy weights for the felkriteriet trace — (1,1,1)
        for depolarizing/biased (count_errors) or (alpha, alpha, 1) for
        alpha noise (n_eff, decoders_biasednoise.py:128).

        With track_shortest, ``sh`` (a ShortestState) rides the scan carry
        and is returned as the last output — all dedup happens on device
        (VERDICT r2 task 2: no per-(step, element) host loop).
        """

        def body(carry, k):
            ls, eq_count, since_burn, swap_sum, sh = carry
            ls, bottom_eq, n_xyz0, swap_acc = ladder_step(ls, k, betas)
            burned = (ls.tops0 >= cfg.tops_burn).astype(jnp.int32)  # (B,)
            B = bottom_eq.shape[0]
            eq_count = eq_count.at[jnp.arange(B), bottom_eq].add(burned)
            since_burn = since_burn + burned
            swap_sum = swap_sum + swap_acc  # (B, Nc-1) window accumulator
            energy = jnp.sum(weights * n_xyz0, axis=-1)  # (B,)
            if track_shortest:
                kk = jax.lax.bitcast_convert_type(
                    pack_key(spec, ls.state[:, 0], mults), jnp.int32
                )  # (B, KEY_W)
                sh = _shortest_update(sh, bottom_eq, kk, energy, burned)
            return (ls, eq_count, since_burn, swap_sum, sh), (energy, burned)

        keys = jax.random.split(rkey, cfg.window)
        swap0 = jnp.zeros(eq_count.shape[:1] + (Nc - 1,), jnp.int32)
        (ls, eq_count, since_burn, swap_sum, sh), outs = jax.lax.scan(
            body, (ls, eq_count, since_burn, swap0, sh), keys
        )
        # compact summaries computed on device so the host fetches (B,)-sized
        # arrays, not (W, B) traces
        burned = outs[1]  # (W, B)
        burn_any = jnp.any(burned > 0, axis=0)
        burn_first = jnp.argmax(burned > 0, axis=0).astype(jnp.int32)
        energies = outs[0]  # (W, B)
        if C > 1:
            W_, B_ = energies.shape
            energies = energies.reshape(W_ // C, C, B_).mean(axis=1)
        extras = (sh,) if track_shortest else ()
        return (ls, eq_count, since_burn, energies, burn_any, burn_first,
                ls.tops0, swap_sum) + extras

    donate = (0, 6) if track_shortest else (0,)
    fn = jax.jit(window, donate_argnums=donate)
    _WINDOW_CACHE[key] = fn
    return fn


def pteq_run(
    spec: CodeSpec,
    init_states: np.ndarray,  # (B, nq) uint8 — one syndrome seed per element
    beta_ladder: np.ndarray,  # (Nc, 3)
    cfg: PTEQConfig = PTEQConfig(),
    energy_weights: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    seed: int = 0,
    track_shortest: bool = False,
    shortest_beta: float = 0.0,
    metrics=None,
) -> PTEQResult:
    """Generic PTEQ engine over an explicit beta ladder.

    ``metrics`` (a utils.metrics.MetricsLogger) opts into per-window
    observability: replica-exchange acceptance per rung pair, tops0
    round-trip rate, energy ESS of the window trace, converged count and
    device-batch size — the SURVEY §5 metrics row the reference lacks
    (its only observability is print(), generate_data.py:54,140)."""
    B = init_states.shape[0]
    Nc = beta_ladder.shape[0]
    K = spec.n_classes
    # depolarizing (p_top=0.75) and alpha (pz_tilde_top=1) ladders have
    # exactly-zero top-rung betas -> always-accept logical mixing fast path
    bl = np.asarray(beta_ladder)
    top_exact = bool(np.allclose(bl[-1], 0.0, atol=1e-9))
    window_fn = _get_window_fn(spec, Nc, cfg, track_shortest, top_exact)
    cur_window = cfg.window  # grows on compaction (window_scale_cap)

    ls = init_ladder(spec, jnp.asarray(init_states, dtype=jnp.uint8), Nc)
    eq_count = jnp.zeros((B, K), dtype=jnp.int32)
    since_burn = jnp.zeros((B,), dtype=jnp.int32)
    betas_j = jnp.asarray(beta_ladder, dtype=jnp.float32)
    weights = jnp.asarray(energy_weights, dtype=jnp.float32)

    key = jax.random.PRNGKey(seed)

    # Host-side convergence automaton state.  The energy-trace prefix sum is
    # maintained incrementally in a capacity-doubling buffer (row t+1 =
    # sum of the first t energies) — recomputing the cumsum each window
    # would be O(T^2) over the run.
    #
    # Batch compaction: device arrays and the per-element automaton arrays
    # below live in *row* space (the current device batch of size Br);
    # ``rows`` maps each row to its original syndrome index (-1 = padding).
    # Result arrays (snap_*, converged, sh_*) stay in original space.
    Br = B
    rows = np.arange(B)
    buckets = []
    hist = EnergyHistory(B, max_rows=cfg.cum_rows_cap)
    burn_start = np.full(B, -1, dtype=np.int64)  # first post-burn step idx
    conv_start = np.zeros(B, dtype=np.int64)  # tops0 at start of streak
    in_streak = np.zeros(B, dtype=bool)
    converged = np.zeros(B, dtype=bool)
    snap_distr = np.zeros((B, K), dtype=np.float64)
    snap_steps = np.zeros(B, dtype=np.int64)
    snap_tops = np.zeros(B, dtype=np.int64)

    # shortest-chain tracking (decoders_biasednoise.py:112-144): the
    # running state lives ON DEVICE in the window scan carry
    # (ShortestState); rows are finalized into these host arrays when they
    # leave the device batch (compaction) or when the run ends
    sh = None
    if track_shortest:
        sh = init_shortest(B, K, cfg.shortest_unique_cap)
        sh_val_h = np.full((B, K), np.inf)
        sh_cnt_h = np.zeros((B, K), dtype=np.int64)
        sh_nuq_h = np.zeros((B, K), dtype=np.int64)
        sh_ovf_h = np.zeros((B, K), dtype=bool)

        def finalize_sh(row_sel):
            """Flush device shortest stats for current-batch rows
            ``row_sel`` into the original-index host arrays."""
            row_sel = np.asarray(row_sel, dtype=np.int64)
            if len(row_sel) == 0:
                return
            fv, fc, fn_, fo = jax.device_get(
                (sh.val[row_sel], sh.cnt[row_sel], sh.nuq[row_sel],
                 sh.ovf[row_sel])
            )
            orig = rows[row_sel]
            ok = orig >= 0
            sh_val_h[orig[ok]] = fv[ok]
            sh_cnt_h[orig[ok]] = fc[ok]
            sh_nuq_h[orig[ok]] = fn_[ok]
            sh_ovf_h[orig[ok]] = fo[ok]

    steps_done = 0
    # energy-trace resolution: the device returns per-chunk means (C steps
    # per row); all cum/quarter-mean indices below are in chunk units
    C = cfg.energy_chunk
    if cfg.window % C != 0:
        raise ValueError(
            f"window ({cfg.window}) must be divisible by energy_chunk ({C})"
        )
    n_windows = max(1, cfg.max_steps // cfg.window)

    # --- exact mid-decode checkpoint/resume --------------------------------
    ckpt = None
    w0 = 0
    if cfg.ckpt_dir:
        from ..utils.checkpoint import CheckpointManager

        ckpt = CheckpointManager(cfg.ckpt_dir)

        def _snapshot_tree():
            return {
                "ls_state": np.asarray(ls.state),
                "ls_flag": np.asarray(ls.flag),
                "ls_tops0": np.asarray(ls.tops0),
                "eq_count": np.asarray(eq_count),
                "since_burn": np.asarray(since_burn),
                "key": np.asarray(key),
                "rows": rows,
                **{f"hist_{k2}": v for k2, v in hist.snapshot().items()},
                "burn_start": burn_start,
                "conv_start": conv_start,
                "in_streak": in_streak,
                "converged": converged,
                "snap_distr": snap_distr,
                "snap_steps": snap_steps,
                "snap_tops": snap_tops,
                "steps_done": np.asarray(steps_done),
                "buckets": np.asarray(buckets, dtype=np.int64),
                **(
                    {
                        "sh_val": np.asarray(sh.val),
                        "sh_cnt": np.asarray(sh.cnt),
                        "sh_nuq": np.asarray(sh.nuq),
                        "sh_ovf": np.asarray(sh.ovf),
                        "sh_keys": np.asarray(sh.keys),
                        "sh_val_h": sh_val_h,
                        "sh_cnt_h": sh_cnt_h,
                        "sh_nuq_h": sh_nuq_h,
                        "sh_ovf_h": sh_ovf_h,
                    }
                    if track_shortest else {}
                ),
            }

        restored, meta = ckpt.restore_latest(_snapshot_tree())
        if restored is not None:
            sig = (B, Nc, K, cfg.window, spec.family, spec.size)
            if tuple(meta.get("sig", ())) != sig:
                raise ValueError(
                    f"checkpoint in {cfg.ckpt_dir} was written by a different"
                    f" run: {meta.get('sig')} != {sig}"
                )
            ls = LadderState(
                jnp.asarray(restored["ls_state"]),
                jnp.asarray(restored["ls_flag"]),
                jnp.asarray(restored["ls_tops0"]),
            )
            eq_count = jnp.asarray(restored["eq_count"])
            since_burn = jnp.asarray(restored["since_burn"])
            key = jnp.asarray(restored["key"])
            rows = restored["rows"]
            Br = len(rows)
            hist = EnergyHistory.restore(
                {
                    "cum": restored["hist_cum"],
                    "ccnt": restored["hist_ccnt"],
                    "span": restored["hist_span"],
                },
                max_rows=cfg.cum_rows_cap,
            )
            burn_start = restored["burn_start"]
            conv_start = restored["conv_start"]
            in_streak = restored["in_streak"]
            converged = restored["converged"]
            snap_distr = restored["snap_distr"]
            snap_steps = restored["snap_steps"]
            snap_tops = restored["snap_tops"]
            steps_done = int(restored["steps_done"])
            buckets = [int(b) for b in restored["buckets"]]
            if track_shortest:
                sh = ShortestState(
                    jnp.asarray(restored["sh_val"]),
                    jnp.asarray(restored["sh_cnt"]),
                    jnp.asarray(restored["sh_nuq"]),
                    jnp.asarray(restored["sh_ovf"]),
                    jnp.asarray(restored["sh_keys"]),
                )
                sh_val_h = restored["sh_val_h"]
                sh_cnt_h = restored["sh_cnt_h"]
                sh_nuq_h = restored["sh_nuq_h"]
                sh_ovf_h = restored["sh_ovf_h"]
            w0 = int(meta["window_idx"]) + 1

    def fetch_args(out):
        # the host-facing summaries: out[1]/out[2] are this window's own
        # eq_count/since_burn.  Shortest-chain tracking stays entirely on
        # device (out[8], never fetched here).
        return out[3:8] + (out[2], out[1])

    def process_group(group):
        """ONE bundled device->host fetch for a whole group of dispatched
        windows (for post-compaction buckets whose windows run faster than
        a fetch, per-window fetches would bound the loop), then advance the
        automaton window by window in order."""
        if not group:
            return
        data = jax.device_get([f for _, f in group])
        for (gw, _), f in zip(group, data):
            process_window(gw, f)

    def process_window(w, fetch):
        """Advance the host convergence automaton with window ``w``'s
        fetched summaries.  With pipelining the fetch (a device sync)
        happens while later windows already execute on device."""
        nonlocal steps_done, in_streak
        energies = fetch[0]  # (W // C, B) chunk means
        burn_any, burn_first, tops_now = fetch[1], fetch[2], fetch[3]
        swap_window = fetch[4]  # (Br, Nc-1) accepted swaps this window
        Wc = energies.shape[0]
        W = Wc * C

        # track first post-burn step (global index)
        newly = (burn_start < 0) & burn_any
        if newly.any():
            burn_start[newly] = steps_done + burn_first[newly]
        steps_done += W
        hist.append(energies)

        if metrics is not None:
            from ..utils.metrics import effective_sample_size

            real = rows >= 0
            ess = float(
                np.mean(
                    [effective_sample_size(energies[:, b])
                     for b in np.nonzero(real)[0]]
                )
            ) if real.any() else 0.0
            metrics.log(
                "pteq_window",
                window=w,
                steps_done=steps_done,
                swap_accept_rate=(
                    swap_window[real].mean(axis=0) / W
                ).tolist() if real.any() else [],
                tops0_rate=float(tops_now[real].mean()) / max(steps_done, 1),
                energy_ess_per_window=ess,
                energy_mean=float(energies[:, real].mean()) if real.any() else 0.0,
                converged=int(converged.sum()),
                batch_rows=int(Br),
            )

        if cfg.conv_criteria == "error_based":
            sb = fetch[-2]
            real = rows >= 0
            conv_r = np.ones(Br, dtype=bool)
            conv_r[real] = converged[rows[real]]
            active = ~conv_r & (tops_now >= cfg.TOPS) & (burn_start >= 0)
            if active.any():
                accept = hist.accept(
                    np.maximum(burn_start, 0) // C, sb // C, cfg.eps
                )
                # streak bookkeeping (decoders.py:74-82) at window cadence
                start_streak = accept & ~in_streak
                conv_start[start_streak] = tops_now[start_streak]
                in_streak = accept
                done = active & accept & (tops_now - conv_start >= cfg.SEQ)
                if done.any():
                    ec = fetch[-1]
                    idx = np.nonzero(done)[0]
                    orig = rows[idx]
                    # our since_burn equals the number of post-burn samples
                    # (the reference's denominator since_burn+1,
                    # decoders.py:89)
                    snap_distr[orig] = ec[idx] / np.maximum(sb[idx, None], 1)
                    snap_steps[orig] = steps_done
                    snap_tops[orig] = tops_now[idx]
                    converged[orig] = True

    def compact_wanted():
        """Repack stragglers into a smaller bucket once most of the device
        batch has converged (each bucket shape compiles once, persistently
        cached; converged rows otherwise burn device time until the cap)."""
        if not (cfg.compact and Br > cfg.min_compact):
            return False
        real_idx = np.nonzero(rows >= 0)[0]
        alive = real_idx[~converged[rows[real_idx]]]
        if not (0 < len(alive) <= int(Br * cfg.compact_frac)):
            return False
        new_Br = max(cfg.min_compact, 1 << int(len(alive) - 1).bit_length())
        return new_Br < Br

    def do_compact():
        nonlocal ls, eq_count, since_burn, burn_start, conv_start
        nonlocal in_streak, rows, Br, sh, cur_window, window_fn
        real_idx = np.nonzero(rows >= 0)[0]
        alive_rows = real_idx[~converged[rows[real_idx]]]
        n_alive = len(alive_rows)
        new_Br = max(cfg.min_compact, 1 << int(n_alive - 1).bit_length())
        if new_Br >= Br:
            return
        pad = new_Br - n_alive
        sel = np.concatenate([alive_rows, np.repeat(alive_rows[:1], pad)])
        sel_j = jnp.asarray(sel)
        if track_shortest:
            # rows leaving the device batch stop accumulating: flush their
            # shortest stats to the host result arrays first
            finalize_sh(np.setdiff1d(real_idx, alive_rows))
            sh = ShortestState(*(jnp.take(a, sel_j, axis=0) for a in sh))
        ls = LadderState(
            jnp.take(ls.state, sel_j, axis=0),
            jnp.take(ls.flag, sel_j, axis=0),
            jnp.take(ls.tops0, sel_j, axis=0),
        )
        eq_count = jnp.take(eq_count, sel_j, axis=0)
        since_burn = jnp.take(since_burn, sel_j, axis=0)
        hist.select_columns(sel)
        burn_start = burn_start[sel]
        conv_start = conv_start[sel]
        in_streak = in_streak[sel]
        rows = np.concatenate(
            [rows[alive_rows], np.full(pad, -1, rows.dtype)]
        )
        Br = new_Br
        buckets.append(new_Br)
        # adaptive window growth (see PTEQConfig.window_scale_cap): keep
        # rows x steps per dispatched window roughly constant so the
        # device window stays longer than the host fetch
        if ckpt is None and not track_shortest and cfg.window_scale_cap > 1:
            f = min(int(cfg.window_scale_cap), max(1, B // Br))
            new_window = cfg.window * f
            if new_window != cur_window:
                cur_window = new_window
                window_fn = _get_window_fn(
                    spec, Nc, dataclasses.replace(cfg, window=cur_window),
                    track_shortest, top_exact,
                )

    # Window pipelining: dispatch ahead BEFORE fetching earlier windows'
    # results, so the fetch + host automaton overlap device execution.
    # The pipeline runs at depth 1 while the batch is full (windows are
    # device-bound;
    # deeper lag would only delay compaction) and deepens with each
    # compaction (pipeline_depth_cap) so one bundled fetch covers a whole
    # group of the now-cheap windows.  Decisions still use each window's
    # own fetched data, so snapshots are identical to the sequential loop;
    # early convergence wastes at most the in-flight windows, and
    # compaction flushes the pipeline first (its row remap must not race
    # an in-flight shape).  Disabled when checkpointing so a snapshot's
    # device state and automaton state always come from the same window
    # (exact resume).
    pipelined = ckpt is None
    pend = []  # [(window_idx, out)] dispatched but not yet processed
    # current fetch-group size (adaptive unless pinned by cfg)
    depth = 1 if cfg.pipeline_depth is None else max(1, int(cfg.pipeline_depth))
    # opt-in loop timing: MCMC_QEC_PTEQ_DEBUG=1 prints per-window
    # dispatch/process wall times (diagnosing host-loop vs device cost)
    import os as _os
    import time as _time
    _dbg = bool(_os.environ.get("MCMC_QEC_PTEQ_DEBUG"))
    # dispatch budget in STEPS (windows can grow after compaction): same
    # total as the fixed-window loop, n_windows * cfg.window
    step_budget = n_windows * cfg.window
    dispatched_steps = steps_done
    w = w0
    while dispatched_steps < step_budget:
        _t0 = _time.perf_counter()
        key, k = jax.random.split(key)
        args = (ls, k, betas_j, eq_count, since_burn, weights)
        if track_shortest:
            args = args + (sh,)
        out = window_fn(*args)
        dispatched_steps += cur_window
        wi = w
        w += 1
        ls, eq_count, since_burn = out[:3]
        if track_shortest:
            sh = out[8]
        if _dbg:
            _t1 = _time.perf_counter()
        if not pipelined:
            process_window(wi, jax.device_get(fetch_args(out)))
            if converged.all():
                break
            if compact_wanted():
                do_compact()
            if ckpt is not None and (wi + 1 - w0) % max(cfg.ckpt_every, 1) == 0:
                ckpt.save(
                    wi,
                    _snapshot_tree(),
                    {
                        "sig": (B, Nc, K, cfg.window, spec.family, spec.size),
                        "window_idx": wi,
                    },
                )
            continue
        # keep only the host-facing summary refs in flight: retaining the
        # full ``out`` tuple would pin up to 2*depth ladder-state copies
        # (out[0], out[8]) in device memory until the group is processed
        pend.append((wi, fetch_args(out)))
        if len(pend) >= 2 * depth:
            group, pend = pend[:depth], pend[depth:]
            process_group(group)
            if converged.all():
                pend = []  # drop in-flight windows (device time already spent)
                break
            if compact_wanted():
                process_group(pend)  # flush in flight before remapping rows
                pend = []
                if converged.all():
                    break
                do_compact()
                if cfg.pipeline_depth is None:
                    depth = min(max(1, int(cfg.pipeline_depth_cap)),
                                max(1, B // Br))
        if _dbg:
            print(
                f"[pteq w{wi}] dispatch {1e3 * (_t1 - _t0):.1f} ms  "
                f"process {1e3 * (_time.perf_counter() - _t1):.1f} ms  "
                f"Br={Br} conv={int(converged.sum())}/{B}",
                flush=True,
            )
    process_group(pend)

    # unconverged elements: snapshot at the end (with the reference's
    # "hit max steps" warning semantics, decoders.py:84-87)
    if not converged.all():
        ec = np.asarray(eq_count)
        sb = np.asarray(since_burn)
        tops_fin = np.asarray(ls.tops0)
        r_idx = np.nonzero(rows >= 0)[0]
        orig = rows[r_idx]
        m = ~converged[orig]
        r_idx, orig = r_idx[m], orig[m]
        snap_distr[orig] = ec[r_idx] / np.maximum(sb[r_idx, None], 1)
        snap_steps[orig] = steps_done
        snap_tops[orig] = tops_fin[r_idx]

    if metrics is not None:
        metrics.log("pteq_done", steps_done=steps_done, batch=B,
                    converged=int(converged.sum()))
    distr = (snap_distr * 100).astype(np.uint8)
    sh_boltz = sh_counts = sh_overflow = None
    if track_shortest:
        # flush the still-resident rows, then compute the two extra
        # distributions from the host result arrays
        finalize_sh(np.nonzero(rows >= 0)[0])
        # Boltzmann over unique shortest chains: each unique chain at the
        # class's shortest n_eff contributes exp(-beta * n_eff)
        # (decoders_biasednoise.py:163-169)
        n_unique = sh_nuq_h.astype(np.float64)
        with np.errstate(invalid="ignore"):
            logw = -shortest_beta * np.where(
                np.isfinite(sh_val_h), sh_val_h, np.inf
            )
        w_ = n_unique * np.exp(logw - np.nanmax(np.where(np.isfinite(logw), logw, np.nan), axis=1, keepdims=True))
        w_ = np.where(np.isfinite(w_), w_, 0.0)
        tot = w_.sum(axis=1, keepdims=True)
        sh_boltz = np.where(tot > 0, w_ / np.maximum(tot, 1e-300) * 100, 0.0)
        ctot = sh_cnt_h.sum(axis=1, keepdims=True)
        sh_counts = np.where(
            ctot > 0, sh_cnt_h / np.maximum(ctot, 1) * 100, 0.0
        )
        sh_overflow = sh_ovf_h
    return PTEQResult(
        distribution=distr,
        converged=converged,
        steps=snap_steps,
        tops0=snap_tops,
        shortest_boltzmann=sh_boltz,
        shortest_counts=sh_counts,
        shortest_overflow=sh_overflow,
        buckets=tuple(buckets),
    )


# ---------------------------------------------------------------------------
# User-facing decoders
# ---------------------------------------------------------------------------


def PTEQ(
    spec: CodeSpec,
    init_states: np.ndarray,
    p: float,
    cfg: PTEQConfig = PTEQConfig(),
    seed: int = 0,
    metrics=None,
) -> PTEQResult:
    """Depolarizing PTEQ (decoders.py:25-89), batched over syndromes."""
    Nc = cfg.Nc or spec.size
    ladder = beta_ladder_depolarizing(p, Nc)
    return pteq_run(spec, init_states, ladder, cfg, (1.0, 1.0, 1.0), seed,
                    metrics=metrics)


def PTEQ_biased(
    spec: CodeSpec,
    init_states: np.ndarray,
    p: float,
    eta: float = 0.5,
    cfg: PTEQConfig = PTEQConfig(),
    seed: int = 0,
    metrics=None,
) -> PTEQResult:
    """Biased-noise PTEQ (decoders_biasednoise.py:28-75)."""
    Nc = cfg.Nc or spec.size
    ladder = beta_ladder_biased(p, eta, Nc)
    return pteq_run(spec, init_states, ladder, cfg, (1.0, 1.0, 1.0), seed,
                    metrics=metrics)


def PTEQ_alpha(
    spec: CodeSpec,
    init_states: np.ndarray,
    pz_tilde: float,
    alpha: float = 1.0,
    cfg: PTEQConfig = PTEQConfig(),
    seed: int = 0,
    metrics=None,
) -> PTEQResult:
    """Alpha-noise PTEQ on effective length n_eff = n_z + alpha (n_x + n_y)
    (decoders_biasednoise.py:175-222)."""
    Nc = cfg.Nc or spec.size
    ladder = beta_ladder_alpha(pz_tilde, alpha, Nc)
    return pteq_run(spec, init_states, ladder, cfg, (alpha, alpha, 1.0), seed,
                    metrics=metrics)


def PTEQ_alpha_with_shortest(
    spec: CodeSpec,
    init_states: np.ndarray,
    pz_tilde: float,
    alpha: float = 1.0,
    cfg: PTEQConfig = PTEQConfig(),
    seed: int = 0,
) -> PTEQResult:
    """Alpha PTEQ that additionally tracks the unique shortest-n_eff chains
    per class (decoders_biasednoise.py:93-172).  The result's
    ``shortest_boltzmann`` and ``shortest_counts`` carry the two extra
    distributions the reference returns."""
    Nc = cfg.Nc or spec.size
    ladder = beta_ladder_alpha(pz_tilde, alpha, Nc)
    return pteq_run(
        spec, init_states, ladder, cfg, (alpha, alpha, 1.0), seed,
        track_shortest=True, shortest_beta=float(-np.log(pz_tilde)),
    )
