"""Scaled multistart tests: chunked device-resident candidate batches on the
8-way virtual mesh, winners against the float64 oracle, candidate × ensemble
2-D meshes,
and min_error termination (BASELINE.json "thousands of pulse candidates"
north star, scaled to the CPU test budget).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from qoc_tpu.models import EnsembleLinearHamiltonian, LinearHamiltonian
from qoc_tpu.optim import Adam
from qoc_tpu.parallel import grape_schroedinger_multistart, make_mesh
from qoc_tpu.standard import (
    SIGMA_Z,
    TargetStateInfidelity,
    get_annihilation_operator,
    get_creation_operator,
)


def _problem():
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    hamiltonian = LinearHamiltonian(h0, np.stack((a,)))
    initial_states = np.array([[[1.0], [0.0]]])
    target_states = np.array([[[0.0], [1.0]]])
    costs = [TargetStateInfidelity(target_states)]
    return hamiltonian, initial_states, costs


def test_multistart_64_candidates_sharded_matches_single_device():
    hamiltonian, initial_states, costs = _problem()
    kwargs = dict(n_starts=64, complex_controls=True, iteration_count=30,
                  log_iteration_step=0, optimizer=Adam(learning_rate=0.02),
                  system_eval_count=21, fused_chunk=10)
    sharded = grape_schroedinger_multistart(
        1, 21, costs, 10, hamiltonian, initial_states,
        mesh=make_mesh(8, axis_name="candidate"), **kwargs)
    single = grape_schroedinger_multistart(
        1, 21, costs, 10, hamiltonian, initial_states,
        mesh=make_mesh(1, axis_name="candidate"), **kwargs)
    assert sharded.errors.shape == (64,)
    assert np.allclose(sharded.errors, single.errors, atol=1e-9)
    assert np.allclose(sharded.best_controls, single.best_controls,
                       atol=1e-9)
    assert sharded.best_error == sharded.errors.min()
    assert sharded.iterations_per_s > 0


def _winner_oracle(result, members=None, forb=None, forb_weight=0.0):
    """The winner's best error against the float64 oracle evaluated at its
    (clipped, evaluated) controls: mean over members of the final
    infidelity plus the weighted per-step forbidden-state penalty."""
    from oracles import (flat_controls, linear_h, schroedinger_traj,
                         state_fidelity)
    from qoc_tpu.models import MagnusPolicy
    h0 = np.asarray(SIGMA_Z) / 2
    ops = get_annihilation_operator(2)[None]
    target = np.array([[[0.0], [1.0]]])
    flat = flat_controls(result.best_controls)
    total = 0.0
    deltas = [0.0] if members is None else members[:, 0]
    for delta in deltas:
        traj = schroedinger_traj(linear_h((1 + delta) * h0, ops), flat,
                                 result.best_controls.shape, 20,
                                 MagnusPolicy.M2, np.array([[[1.0], [0.0]]]),
                                 evolution_time=10.0)
        total += 1 - state_fidelity(target, traj[-1])
        if forb is not None:
            total += forb_weight * sum(
                abs(np.vdot(forb[0, 0], s[0])) ** 2 for s in traj) / 20
    assert np.all(np.isfinite(result.errors))
    assert result.best_error == result.errors.min()
    assert abs(result.best_error - total / len(deltas)) < 1e-9


def test_multistart_winner_matches_scipy():
    hamiltonian, initial_states, costs = _problem()
    result = grape_schroedinger_multistart(
        1, 21, costs, 10, hamiltonian, initial_states, n_starts=8,
        complex_controls=True, iteration_count=8, log_iteration_step=0,
        optimizer=Adam(learning_rate=0.02), system_eval_count=21,
        fused_chunk=4, mesh=make_mesh(8, axis_name="candidate"))
    _winner_oracle(result)


def test_multistart_step_costs_winner_matches_scipy():
    """Step costs (ForbidStates) ride the candidate-batched loss."""
    from qoc_tpu.standard import ForbidStates
    hamiltonian, initial_states, costs = _problem()
    forb = np.zeros((1, 1, 2, 1), dtype=complex)
    forb[0, 0, 0] = 1
    costs = costs + [ForbidStates(forb, 21, cost_multiplier=0.1)]
    result = grape_schroedinger_multistart(
        1, 21, costs, 10, hamiltonian, initial_states, n_starts=8,
        complex_controls=True, iteration_count=6, log_iteration_step=0,
        optimizer=Adam(learning_rate=0.02), system_eval_count=21,
        fused_chunk=3, mesh=make_mesh(8, axis_name="candidate"))
    _winner_oracle(result, forb=forb, forb_weight=0.1)


def test_multistart_ensemble_2d_mesh_matches_1d():
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    ens_ham = EnsembleLinearHamiltonian(h0, np.stack((a,)), [h0])
    params = np.linspace(-0.05, 0.05, 4).reshape(-1, 1)
    initial_states = np.array([[[1.0], [0.0]]])
    target_states = np.array([[[0.0], [1.0]]])
    costs = [TargetStateInfidelity(target_states)]
    kwargs = dict(n_starts=8, complex_controls=True, iteration_count=10,
                  log_iteration_step=0, optimizer=Adam(learning_rate=0.02),
                  system_eval_count=21, hamiltonian_params=params,
                  fused_chunk=5)
    devices = np.asarray(jax.devices())
    mesh_2d = Mesh(devices.reshape(4, 2), ("candidate", "ensemble"))
    mesh_1d = Mesh(devices.reshape(8, 1), ("candidate", "ensemble"))
    r2d = grape_schroedinger_multistart(
        1, 21, costs, 10, ens_ham, initial_states, mesh=mesh_2d, **kwargs)
    r1d = grape_schroedinger_multistart(
        1, 21, costs, 10, ens_ham, initial_states, mesh=mesh_1d, **kwargs)
    assert np.allclose(r2d.errors, r1d.errors, atol=1e-9)
    assert np.allclose(r2d.best_controls, r1d.best_controls, atol=1e-9)


def test_multistart_ensemble_winner_matches_scipy():
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    ens_ham = EnsembleLinearHamiltonian(h0, np.stack((a,)), [h0])
    params = np.linspace(-0.05, 0.05, 2).reshape(-1, 1)
    initial_states = np.array([[[1.0], [0.0]]])
    target_states = np.array([[[0.0], [1.0]]])
    costs = [TargetStateInfidelity(target_states)]
    devices = np.asarray(jax.devices())
    result = grape_schroedinger_multistart(
        1, 21, costs, 10, ens_ham, initial_states, n_starts=4,
        complex_controls=True, iteration_count=6, log_iteration_step=0,
        optimizer=Adam(learning_rate=0.02), system_eval_count=21,
        hamiltonian_params=params, fused_chunk=3,
        mesh=Mesh(devices.reshape(4, 2), ("candidate", "ensemble")))
    _winner_oracle(result, members=params)


def test_multistart_min_error_terminates_early():
    hamiltonian, initial_states, costs = _problem()
    result = grape_schroedinger_multistart(
        1, 21, costs, 10, hamiltonian, initial_states,
        system_eval_count=21, n_starts=8, complex_controls=True,
        iteration_count=400, log_iteration_step=0, min_error=0.1,
        fused_chunk=25, optimizer=Adam(learning_rate=0.02),
        mesh=make_mesh(8, axis_name="candidate"))
    assert result.best_error <= 0.1
    assert result.iteration_count_ran < 400


def test_multistart_h5_saving(tmp_path):
    import h5py
    from qoc_tpu import evolve_schroedinger_discrete
    hamiltonian, initial_states, costs = _problem()
    save_path = str(tmp_path / "00000_multistart.h5")
    result = grape_schroedinger_multistart(
        1, 21, costs, 10, hamiltonian, initial_states, 21, n_starts=8,
        complex_controls=True, iteration_count=6, log_iteration_step=0,
        optimizer=Adam(learning_rate=0.02), fused_chunk=3,
        save_file_path=save_path, save_iteration_step=2,
        mesh=make_mesh(8, axis_name="candidate"))
    with h5py.File(save_path, "r") as f:
        errors = np.asarray(f["error"])
        controls_rows = np.asarray(f["controls"])
        finals = np.asarray(f["final_states"])
    assert errors.shape == (3,)
    assert np.all(errors < np.finfo(np.float64).max)
    # Winner rows are real evaluated iterates: recomputing the final states
    # from the saved controls reproduces the saved final_states.
    for save_step in range(3):
        ev = evolve_schroedinger_discrete(
            10, hamiltonian, initial_states, 21, costs=costs,
            controls=controls_rows[save_step])
        assert np.allclose(ev.final_states, finals[save_step], atol=1e-9)
        assert abs(ev.error - errors[save_step]) < 1e-9
    # The winner's best error is at most the last saved row's error.
    assert result.best_error <= errors[-1] + 1e-12


def test_multistart_rejects_host_only_optimizer():
    from qoc_tpu.optim import LBFGSB
    hamiltonian, initial_states, costs = _problem()
    with pytest.raises(ValueError, match="LBFGSB is host-loop only"):
        grape_schroedinger_multistart(
            1, 21, costs, 10, hamiltonian, initial_states, 21, n_starts=8,
            complex_controls=True, optimizer=LBFGSB())


def test_multistart_best_iteration_matches_single_run():
    """A 1-candidate multistart is exactly grape_schroedinger_discrete
    (candidate 0 seeds with the reference flat controls), including the
    tracked best iteration."""
    from qoc_tpu import grape_schroedinger_discrete
    hamiltonian, initial_states, costs = _problem()
    kwargs = dict(complex_controls=True, iteration_count=12,
                  log_iteration_step=0, system_eval_count=21)
    multi = grape_schroedinger_multistart(
        1, 21, costs, 10, hamiltonian, initial_states, n_starts=1,
        optimizer=Adam(learning_rate=0.02),
        mesh=make_mesh(1, axis_name="candidate"), fused_chunk=5, **kwargs)
    single = grape_schroedinger_discrete(
        1, 21, costs, 10, hamiltonian, initial_states,
        optimizer=Adam(learning_rate=0.02), **kwargs)
    assert abs(multi.best_error - single.best_error) < 1e-12
    assert multi.best_iteration == single.best_iteration
    assert np.allclose(multi.best_controls, single.best_controls,
                       atol=1e-12)


def test_multistart_resume_reproduces_uninterrupted(tmp_path):
    """Kill-at-chunk-boundary + resume_from reproduces the uninterrupted
    64-candidate run's per-candidate best errors exactly (VERDICT r2 #3):
    the full candidate carry (params, Adam moments, done flags, bests) is
    checkpointed at chunk boundaries and restored on device."""
    hamiltonian, initial_states, costs = _problem()
    kwargs = dict(n_starts=64, complex_controls=True,
                  log_iteration_step=0, optimizer=Adam(learning_rate=0.02),
                  system_eval_count=21, fused_chunk=4,
                  mesh=make_mesh(8, axis_name="candidate"))
    full = grape_schroedinger_multistart(
        1, 21, costs, 10, hamiltonian, initial_states, iteration_count=12,
        save_file_path=str(tmp_path / "00000_full.h5"), **kwargs)
    # "Killed" run: only 8 of 12 iterations before the process dies.
    killed_path = str(tmp_path / "00000_killed.h5")
    grape_schroedinger_multistart(
        1, 21, costs, 10, hamiltonian, initial_states, iteration_count=8,
        save_file_path=killed_path, **kwargs)
    resumed = grape_schroedinger_multistart(
        1, 21, costs, 10, hamiltonian, initial_states, iteration_count=12,
        resume_from=killed_path, **kwargs)
    assert resumed.iteration_count_ran == 4
    assert np.array_equal(resumed.errors, full.errors)
    assert np.array_equal(resumed.best_controls, full.best_controls)
    assert resumed.best_iteration == full.best_iteration
    assert resumed.best_error == full.best_error


def test_multistart_resume_rejects_single_run_checkpoint(tmp_path):
    from qoc_tpu import grape_schroedinger_discrete
    hamiltonian, initial_states, costs = _problem()
    path = str(tmp_path / "00000_single.h5")
    grape_schroedinger_discrete(
        1, 21, costs, 10, hamiltonian, initial_states,
        complex_controls=True, iteration_count=4, log_iteration_step=0,
        system_eval_count=21, save_file_path=path, save_iteration_step=2)
    with pytest.raises(ValueError, match="single-run checkpoint"):
        grape_schroedinger_multistart(
            1, 21, costs, 10, hamiltonian, initial_states, n_starts=8,
            complex_controls=True, iteration_count=8, log_iteration_step=0,
            system_eval_count=21, resume_from=path,
            mesh=make_mesh(8, axis_name="candidate"))


def test_multistart_ensemble_h5_winner_rows(tmp_path):
    """Ensemble multistart writes member-extended winner rows (leading
    member axis on final_states + a hamiltonian_params dataset); each row's
    member-stacked final states must match per-member evolve recomputation
    at the saved winner controls."""
    import h5py
    from qoc_tpu import evolve_schroedinger_discrete
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    ens_ham = EnsembleLinearHamiltonian(h0, np.stack((a,)), [h0])
    _, initial_states, costs = _problem()
    params = np.linspace(-0.05, 0.05, 4).reshape(-1, 1)
    path = str(tmp_path / "00000_ms_ens.h5")
    result = grape_schroedinger_multistart(
        1, 21, costs, 10, ens_ham, initial_states, 21, n_starts=8,
        complex_controls=True, hamiltonian_params=params, iteration_count=4,
        log_iteration_step=0, save_file_path=path, save_iteration_step=2)
    with h5py.File(path, "r") as f:
        finals = np.asarray(f["final_states"])
        controls_rows = np.asarray(f["controls"])
        saved_params = np.asarray(f["hamiltonian_params"])
        errors = np.asarray(f["error"])
    assert finals.shape == (2, 4, 1, 2, 1)
    assert np.allclose(saved_params, params)
    assert np.all(errors < np.finfo(np.float64).max)
    for m in range(4):
        member_h = lambda c, t, _row=params[m]: ens_ham(_row, c, t)
        ev = evolve_schroedinger_discrete(10, member_h, initial_states, 21,
                                          controls=controls_rows[1])
        assert np.allclose(finals[1, m], ev.final_states, atol=1e-7)
    assert result.best_final_states.shape == (4, 1, 2, 1)


def test_multistart_ensemble_hamiltonian_needs_params():
    """An ensemble-contract Hamiltonian without hamiltonian_params fails
    fast with a clear error instead of a TypeError deep inside tracing."""
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    ens_ham = EnsembleLinearHamiltonian(h0, np.stack((a,)), [h0])
    _, initial_states, costs = _problem()
    with pytest.raises(ValueError, match="hamiltonian_params"):
        grape_schroedinger_multistart(
            1, 21, costs, 10, ens_ham, initial_states, 21, n_starts=8,
            complex_controls=True, iteration_count=2)
