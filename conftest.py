"""Marks for the tests of the frozen JAX package (thinshelllab_tpu), whose
own test files this repo keeps as they are, and the plugins every run of
tests/ loads.

SLOW holds each of the package's self-tests that takes over 30 s alone (one
process, cold compile cache), with those seconds: the tier-1 run
(`-m 'not slow'`) leaves them out and `-m slow` runs them. Every test under
tests/ gets a time limit (tests/_time_limit.py): its own `timeout` marker,
else TIMEOUTS' entry, else DEFAULT_TIMEOUT_S. The port's own test files
carry their marks themselves.
"""
import os

import pytest

pytest_plugins = ["pytester", "tests._time_limit"]

# jaxlib's CPU LAPACK kernels run on scipy's OpenBLAS. Eight threads a
# process, six xdist workers on eight cores: a JAX test of 12 s alone took
# 380 s, and 20 s with one thread. One thread in every process of a run:
# OpenBLAS reads this when it loads, after this file, and xdist's workers
# and the tests' subprocesses inherit it. The count moves LAPACK's results
# in their last bits, so the goldens are written with it too (README.md).
os.environ["OPENBLAS_NUM_THREADS"] = "1"

SLOW = {
    "tests/test_adjoint.py::test_trajectory_gradient_directional": 103.22,
    "tests/test_adjoint.py::test_single_step_ift_exact": 102.32,
    "tests/test_adjoint.py::test_static_friction_loss_seed": 45.06,
    "tests/test_adjoint.py::test_yield_gate_tape_matches_recompute": 38.68,
    "tests/test_adjoint.py::test_f32_backward_chain_finite_per_step": 54.27,
    "tests/test_adjoint.py::test_compensated_backward_matches_plain": 36.20,
    "tests/test_adjoint_chunked.py::"
    "test_chunked_matches_single_scan[False-False]": 103.63,
    "tests/test_adjoint_chunked.py::"
    "test_chunked_matches_single_scan[True-True]": 65.07,
    "tests/test_assembly.py::test_hvp_and_diag_match_dense[make-kw0]": 98.33,
    "tests/test_assembly.py::test_hvp_and_diag_match_dense[make-kw1]": 77.10,
    "tests/test_assembly.py::test_residual_gather_matches_scatter": 84.01,
    "tests/test_assembly.py::"
    "test_smoothed_preconditioner_solve_agrees_with_dense": 85.22,
    "tests/test_assembly.py::test_minres_matches_dense_on_true_hessian": 128.83,
    "tests/test_assembly.py::test_hess_refresh_same_fixed_point": 51.88,
    "tests/test_assembly.py::test_pallas_dia_spmv_matches_xla_interpret": 70.40,
    "tests/test_assembly.py::test_contact_split_hvp_matches_unsplit": 37.18,
    "tests/test_assembly.py::"
    "test_linesearch_energy_matches_total[make-kw0]": 47.84,
    "tests/test_assembly.py::"
    "test_linesearch_energy_matches_total[make-kw1]": 49.67,
    "tests/test_assembly.py::"
    "test_pallas_dia_precond_matches_xla_interpret": 87.31,
    "tests/test_assembly.py::test_warm_started_cg_matches_dense": 51.93,
    "tests/test_assembly.py::test_force_groups_from_soups_bit_exact": 38.49,
    "tests/test_assembly.py::"
    "test_linesearch_ef_matches_energy_and_force[make-kw0]": 46.67,
    "tests/test_assembly.py::"
    "test_linesearch_ef_matches_energy_and_force[make-kw1]": 52.84,
    "tests/test_collision.py::test_contact_constraint_on_folding": 64.44,
    "tests/test_collision.py::test_check_differential_utility": 76.39,
    "tests/test_collision.py::test_spatial_hash_broadphase_matches_dense": 61.20,
    "tests/test_collision.py::test_self_contact_hairpin_end_to_end": 48.58,
    "tests/test_gradient_oracle.py::"
    "test_backward_matches_reference_chain_oracle": 258.19,
    "tests/test_gridsolve.py::test_extraction_matches_dense_lanes": 96.27,
    "tests/test_gridsolve.py::test_bcr_solve_accuracy": 107.48,
    "tests/test_gridsolve.py::"
    "test_grid_preconditioned_minres_converges_fast": 66.56,
    "tests/test_parallel.py::test_sharded_population_rewards": 283.28,
    "tests/test_parallel.py::test_cmaes_driver_with_mesh": 91.55,
    "tests/test_parallel.py::"
    "test_sharded_matches_single_device_on_cg_dia_path": 115.32,
    "tests/test_parallel.py::test_graft_entry_contract": 300.0,  # cut there
    "tests/test_parallel.py::test_import_purity_and_dryrun_subprocess": 134.64,
    "tests/test_parallel.py::"
    "test_sharded_matches_single_device_on_hash_broadphase": 125.95,
    "tests/test_render.py::test_debug_plots": 42.12,
    "tests/test_sb3_interop.py::test_sb3_train_contract[ppo]": 36.73,
    "tests/test_scenes.py::test_scene_forward[sliding]": 32.47,
    "tests/test_stepper_chunked.py::"
    "test_chunked_matches_single_scan[False]": 31.39,
    "tests/test_stepper_chunked.py::"
    "test_chunked_matches_single_scan[True]": 30.02,
    "tests/test_stepper_chunked.py::test_chunked_handles_ragged_tail": 32.70,
    "tests/test_training.py::test_trajopt_iteration": 30.29,
    "tests/test_training.py::test_ppo_trainer_smoke": 34.80,
    "tests/test_training.py::"
    "test_rollout_stop_step_matches_serial_replay": 31.76,
    "tests/test_training.py::test_trajopt_improves_objective": 41.89,
}

DEFAULT_TIMEOUT_S = 300

TIMEOUTS = {
    "tests/test_parallel.py::test_sharded_population_rewards": 600,
    "tests/test_parallel.py::test_graft_entry_contract": 900,
    # above the 1200 s its child process may take
    "tests/test_parallel.py::test_import_purity_and_dryrun_subprocess": 1260,
    "tests/test_gradient_oracle.py::"
    "test_backward_matches_reference_chain_oracle": 600,
}


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # before `-m` deselects by mark
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
        if item.nodeid in TIMEOUTS:
            item.add_marker(pytest.mark.timeout(TIMEOUTS[item.nodeid]))
        elif (item.nodeid.startswith("tests/")
              and item.get_closest_marker("timeout") is None):
            item.add_marker(pytest.mark.timeout(DEFAULT_TIMEOUT_S))
