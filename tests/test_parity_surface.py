"""Capability-surface contract: every reference-inventory component
(SURVEY.md §2 / PARITY.md) has a live, importable counterpart.  Guards
future rounds against silently dropping surface."""

import importlib

import numpy as np
import pytest


SURFACE = {
    "mcmc_qec_tpu.models": [
        "get_spec", "np_syndrome", "np_eq_class", "np_to_class",
        "np_count_errors", "defect_array",
    ],
    "mcmc_qec_tpu.models.noise": [
        "sample_depolarizing", "sample_xyz", "sample_n_random_errors",
        "xyz_probs_from_biased", "xyz_probs_from_alpha",
        "alpha_tilde_from_p", "biased_alpha_equivalent",
    ],
    "mcmc_qec_tpu.ops": [
        "syndrome", "eq_class", "to_class", "all_class_states",
        "count_errors", "count_errors_xyz", "apply_stabilizers_uniform",
        "random_logical", "pack_key", "make_chain_stepper",
        "make_chain_update", "make_sweep_stepper",
    ],
    "mcmc_qec_tpu.ops.dense_sweep": ["make_dense_sweep"],
    "mcmc_qec_tpu.ops.sweep_kernel": ["make_kernel_sweep"],
    "mcmc_qec_tpu.mcmc": [
        "LadderState", "make_ladder_step", "beta_ladder_depolarizing",
        "beta_ladder_biased", "beta_ladder_alpha", "betas_xyz",
        "betas_depolarizing",
    ],
    "mcmc_qec_tpu.decoders": [
        "PTEQ", "PTEQ_biased", "PTEQ_alpha", "PTEQ_alpha_with_shortest",
        "PTEQConfig", "single_temp", "STDC", "STDC_general_noise",
        "STDC_general_noise_shortest", "STDC_Nall_n_alpha", "STRC",
        "PTDC", "PTRC",
    ],
    "mcmc_qec_tpu.decoders.convergence": ["error_based_accept", "quarter_means"],
    "mcmc_qec_tpu.matching": [
        "class_sorted_mwpm", "regular_mwpm", "enhanced_mwpm",
        "mwpm_correction", "solve_layer", "generate_classes",
        "generate_edges", "generate_edges_constrained", "shortest_distance",
    ],
    "mcmc_qec_tpu.native": ["mwpm_solve", "brute_force_mwpm", "build_library"],
    "mcmc_qec_tpu.pipeline": [
        "RunConfig", "Dataset", "MCMCDataReader", "generate", "decode_batch",
        "sample_errors", "evaluate_dataset", "evaluate_submethods",
        "concat_datasets", "read_reference_dataset", "to_reference_dataframe",
        "load_golden_corpus", "replay_golden", "success_rate_curve",
    ],
    "mcmc_qec_tpu.pipeline.plot": ["plot_state", "plot_success_rates"],
    "mcmc_qec_tpu.parallel": [
        "make_mesh", "shard_batch", "replicate", "pad_to_multiple",
        "init_distributed", "host_shard", "allgather_rows", "global_sum",
        "distributed_generate",
    ],
    "mcmc_qec_tpu.utils": [
        "CheckpointManager", "save_pytree", "load_pytree", "MetricsLogger",
        "effective_sample_size", "swap_acceptance_from_traces",
        "unique_discovery_curve", "StageTimer", "Throughput", "device_trace",
    ],
    "mcmc_qec_tpu.cli": ["main"],
}


@pytest.mark.parametrize("module,names", SURFACE.items(),
                         ids=list(SURFACE.keys()))
def test_surface_exists(module, names):
    mod = importlib.import_module(module)
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, f"{module} lost surface: {missing}"


def test_all_decoder_methods_dispatchable():
    """Every reference method name resolves in the pipeline dispatcher."""
    from mcmc_qec_tpu.pipeline import RunConfig

    methods = ["PTEQ", "PTEQ_with_shortest", "PTDC", "PTRC", "STDC",
               "STDC_N_n", "ST", "STRC", "eMWPM", "MWPM", "all",
               "uncorrelated_comparison"]
    import inspect

    from mcmc_qec_tpu.pipeline import generate as _  # noqa
    from mcmc_qec_tpu.pipeline.generate import decode_batch

    src = inspect.getsource(decode_batch)
    for m in methods:
        assert f'"{m}"' in src, f"method {m} not dispatched"
