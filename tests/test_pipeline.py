"""Pipeline: generation driver, dataset round-trip, evaluation, golden
corpus reader, plotting."""

import os

import numpy as np
import pytest

from mcmc_qec_tpu.models import get_spec, np_eq_class
from mcmc_qec_tpu.pipeline import (
    Dataset,
    RunConfig,
    concat_datasets,
    evaluate_dataset,
    generate,
    load_golden_corpus,
)
from mcmc_qec_tpu.pipeline.plot import plot_state, plot_success_rates

GOLDEN = "/root/reference/data/drl_failures_p_0.15.xz"


def test_generate_stdc_planar(tmp_path):
    cfg = RunConfig(
        code="planar", method="STDC", size=3, noise="depolarizing",
        p_error=0.08, p_sampling=0.25, droplets=2, steps=1500, batch=8,
    )
    ds = generate(str(tmp_path / "out.npz"), cfg, nbr_datapoints=8, progress=None)
    assert len(ds) == 8
    res = evaluate_dataset(ds)
    # d=3 planar at p=0.08 with a correct decoder succeeds most of the time
    assert res.success_rate >= 0.6, res
    # round-trip
    ds2 = Dataset.load(str(tmp_path / "out.npz"))
    assert np.array_equal(ds2.qubit_matrices, ds.qubit_matrices)
    assert ds2.config.method == "STDC"


def test_generate_mwpm_and_emwpm(tmp_path):
    for method in ("MWPM", "eMWPM"):
        cfg = RunConfig(
            code="planar", method=method, size=5, noise="depolarizing",
            p_error=0.05, batch=10,
        )
        ds = generate(None, cfg, nbr_datapoints=10, progress=None)
        res = evaluate_dataset(ds)
        assert res.success_rate >= 0.6, (method, res)


def test_generate_st_uses_argmin():
    cfg = RunConfig(
        code="planar", method="ST", size=3, noise="depolarizing",
        p_error=0.06, steps=1500, batch=6,
    )
    ds = generate(None, cfg, nbr_datapoints=6, progress=None)
    res = evaluate_dataset(ds, decision="argmin")
    assert res.n_points == 6


def test_generate_biased_xzzx():
    cfg = RunConfig(
        code="xzzx", method="STDC", size=3, noise="depolarizing",
        p_error=0.08, p_sampling=0.2, droplets=2, steps=1000, batch=4,
    )
    ds = generate(None, cfg, nbr_datapoints=4, progress=None)
    assert ds.distributions.shape == (4, 4)


def test_concat():
    cfg = RunConfig(code="planar", method="STDC", size=3, steps=500,
                    droplets=1, batch=2, p_error=0.05, p_sampling=0.2)
    a = generate(None, cfg, 2, progress=None)
    b = generate(None, cfg, 2, progress=None)
    c = concat_datasets([a, b])
    assert len(c) == 4


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="golden corpus absent")
def test_golden_corpus_loads():
    spec, flat, trues = load_golden_corpus(GOLDEN)
    assert flat.shape == (2603, 50)
    assert trues.shape == (2603,)
    assert set(np.unique(trues)) <= set(range(16))


def test_plotting(tmp_path):
    import jax
    from mcmc_qec_tpu.models.noise import sample_depolarizing

    for family, d in [("toric", 5), ("planar", 5), ("rotated", 5), ("xzzx", 5)]:
        spec = get_spec(family, d)
        s = np.asarray(sample_depolarizing(jax.random.PRNGKey(0), spec, 0.1, (1,)))[0]
        plot_state(spec, s, str(tmp_path / f"{family}.png"))
        assert (tmp_path / f"{family}.png").exists()
    plot_success_rates(
        {"STDC": {0.05: 0.99, 0.1: 0.9}, "MWPM": {0.05: 0.97, 0.1: 0.8}},
        str(tmp_path / "rates.png"),
    )
    assert (tmp_path / "rates.png").exists()


def test_reference_dataframe_bridge(tmp_path):
    pd = pytest.importorskip("pandas")
    from mcmc_qec_tpu.pipeline import read_reference_dataset, to_reference_dataframe

    cfg = RunConfig(code="planar", method="STDC", size=3, steps=500,
                    droplets=1, batch=2, p_error=0.05, p_sampling=0.2)
    ds = generate(None, cfg, 2, progress=None)
    df = to_reference_dataframe(ds, params={"method": "STDC"})
    path = str(tmp_path / "ref.xz")
    df.to_pickle(path)
    qms, distrs = read_reference_dataset(path)
    assert len(qms) == 2
    assert np.array_equal(qms[0], ds.qubit_matrices[0])


def test_evaluate_submethods():
    from mcmc_qec_tpu.pipeline import evaluate_submethods

    cfg = RunConfig(code="planar", method="all", size=3, p_error=0.08,
                    p_sampling=0.25, droplets=2, steps=500, batch=3)
    ds = generate(None, cfg, 3, progress=None)
    res = evaluate_submethods(ds)
    assert set(res) == {"ST", "STDC", "STRC"}
    for r in res.values():
        assert r.n_points == 3


def test_shortest_comparison_method_and_submethods():
    from mcmc_qec_tpu.pipeline import evaluate_submethods

    cfg = RunConfig(code="planar", method="shortest_comparison", size=3,
                    p_error=0.08, p_sampling=0.25, droplets=2, steps=400,
                    batch=3)
    ds = generate(None, cfg, 3, progress=None)
    assert ds.distributions.shape == (3, 16)  # 4 blocks x 4 classes
    res = evaluate_submethods(ds)
    assert set(res) == {"stdc_depol", "stdc_depol_short", "stdc_uncorr",
                        "stdc_uncorr_short"}
    for r in res.values():
        assert r.n_points == 3


def test_pteq_with_shortest_submethods():
    from mcmc_qec_tpu.pipeline import evaluate_submethods

    cfg = RunConfig(code="xzzx", method="PTEQ_with_shortest", size=3,
                    noise="alpha", p_error=0.10, alpha=1.5, Nc=3,
                    max_steps=600, window=100, batch=2, iters=2)
    ds = generate(None, cfg, 2, progress=None)
    assert ds.distributions.shape == (2, 12)  # 3 blocks x 4 classes
    res = evaluate_submethods(ds)
    assert set(res) == {"PTEQ", "shortest_boltzmann", "shortest_count"}


def test_known_error():
    from mcmc_qec_tpu.models import np_syndrome
    from mcmc_qec_tpu.models.noise import known_error

    for family, pos in (("rotated", [(2, 2), (1, 0)]),
                        ("xzzx", [(0, 1), (1, 1)])):
        spec = get_spec(family, 5)
        state = known_error(spec)
        grid = state.reshape(spec.state_shape)
        assert all(grid[r, c] == 1 for r, c in pos)
        assert (grid != 0).sum() == 2
        assert np_syndrome(spec, state).any()  # nontrivial syndrome
    with pytest.raises(ValueError):
        known_error(get_spec("toric", 5))


def test_cli_append(tmp_path):
    from mcmc_qec_tpu.cli import main

    out = str(tmp_path / "cli_append.npz")
    base = ["generate", "--code", "planar", "--method", "STDC", "--size",
            "3", "--p-error", "0.08", "--p-sampling", "0.25", "--droplets",
            "1", "--steps", "300", "--batch", "2", "--out", out]
    assert main(base + ["-n", "2"]) == 0
    assert main(base + ["-n", "4", "--append"]) == 0
    ds = Dataset.load(out)
    assert len(ds) == 4


def test_mcmc_data_reader_and_append(tmp_path):
    from mcmc_qec_tpu.pipeline import MCMCDataReader

    cfg = RunConfig(code="planar", method="STDC", size=3, p_error=0.08,
                    p_sampling=0.25, droplets=1, steps=400, batch=2)
    path = str(tmp_path / "r.npz")
    generate(path, cfg, 2, progress=None)
    ds2 = generate(path, cfg, 5, progress=None, append=True)
    assert len(ds2) == 5
    reader = MCMCDataReader(path)
    assert reader.get_capacity() == 5
    n = 0
    while reader.has_next():
        qm, distr = reader.next()
        assert qm.shape == (2, 3, 3)
        assert distr.shape == (4,)
        n += 1
    assert n == 5
    assert len(reader.full()) == 5 * (18 + 4)


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="golden corpus absent")
def test_mcmc_data_reader_reference_format():
    from mcmc_qec_tpu.pipeline import MCMCDataReader

    reader = MCMCDataReader(GOLDEN, size=5)
    assert reader.get_capacity() == 2603
    qm, chain = reader.next()
    assert np.asarray(qm).shape == (2, 5, 5)


def test_generate_retries_transient_failures(tmp_path, monkeypatch):
    """Host-level failure detection: a decode that dies with a runtime
    error is retried (SURVEY §5 elasticity row); the final dataset is the
    one an uninterrupted run produces (same seeds)."""
    import sys

    gen = sys.modules["mcmc_qec_tpu.pipeline.generate"]

    cfg = RunConfig(
        code="planar", method="STDC", size=3, noise="depolarizing",
        p_error=0.08, p_sampling=0.25, droplets=2, steps=400, batch=4,
        retries=2, retry_wait=0.0,
        metrics_path=str(tmp_path / "m.jsonl"),
    )
    clean = generate(None, cfg, nbr_datapoints=8, progress=None)

    real = gen.decode_batch
    fails = {"left": 2}

    def flaky(spec, c, states, seed, metrics=None):
        if fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("simulated device fault")
        return real(spec, c, states, seed, metrics=metrics)

    monkeypatch.setattr(gen, "decode_batch", flaky)
    ds = generate(None, cfg, nbr_datapoints=8, progress=None)
    assert fails["left"] == 0
    assert np.array_equal(ds.distributions, clean.distributions)
    import json

    events = [json.loads(l)["event"]
              for l in open(tmp_path / "m.jsonl") if l.strip()]
    assert events.count("decode_retry") == 2


def test_generate_does_not_retry_config_errors(monkeypatch):
    import sys

    gen = sys.modules["mcmc_qec_tpu.pipeline.generate"]

    cfg = RunConfig(code="toric", method="STDC", size=3, noise="biased",
                    batch=2, retries=5, retry_wait=0.0)
    calls = {"n": 0}

    def boom(spec, c, states, seed, metrics=None):
        calls["n"] += 1
        raise ValueError("bad config")

    monkeypatch.setattr(gen, "decode_batch", boom)
    with pytest.raises(ValueError):
        generate(None, cfg, nbr_datapoints=2, progress=None)
    assert calls["n"] == 1


def test_generate_exhausted_retries_reraises(monkeypatch):
    import sys

    gen = sys.modules["mcmc_qec_tpu.pipeline.generate"]

    cfg = RunConfig(code="toric", method="STDC", size=3, batch=2,
                    retries=1, retry_wait=0.0)

    def always(spec, c, states, seed, metrics=None):
        raise RuntimeError("persistent device loss")

    monkeypatch.setattr(gen, "decode_batch", always)
    with pytest.raises(RuntimeError, match="persistent"):
        generate(None, cfg, nbr_datapoints=2, progress=None)


def test_rotated_defect_positions_match_reference_conventions():
    """Flux-dot geometry of the rotated/xzzx rendering: interior defects
    sit at plaquette centers, boundary half-stab defects are nudged 0.25
    into the lattice, and corners take the first matching edge rule —
    the reference's elif chain (rotated_surface_model.py:177-189)."""
    from mcmc_qec_tpu.pipeline.plot import _rotated_defect_xy

    d = 5
    assert _rotated_defect_xy(d, 2, 3) == (2.5, d - 2.5)  # interior
    assert _rotated_defect_xy(d, 2, 0) == (-0.25, d - 2.5)  # left edge
    assert _rotated_defect_xy(d, 0, 2) == (1.5, d - 0.75)  # top edge
    assert _rotated_defect_xy(d, 2, d) == (d - 0.75, d - 2.5)  # right
    assert _rotated_defect_xy(d, d, 2) == (1.5, -0.25)  # bottom edge
    assert _rotated_defect_xy(d, 0, 0) == (-0.25, d - 0.5)  # corner: col
