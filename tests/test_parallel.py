"""Multi-device tests on the 8-way virtual CPU mesh (SURVEY.md §4): sharded
psum results must equal the single-device computation, and ensemble GRAPE
must optimize the mean error.
"""

import numpy as np

import jax
import jax.numpy as jnp

from qoc_tpu.optim import Adam
from qoc_tpu.parallel import grape_schroedinger_ensemble, make_mesh
from qoc_tpu.standard import (
    SIGMA_Z,
    TargetStateInfidelity,
    get_annihilation_operator,
    get_creation_operator,
)

RNG = np.random.default_rng(21)


def _ensemble_setup():
    h0 = jnp.asarray(np.asarray(SIGMA_Z) / 2)
    a = jnp.asarray(get_annihilation_operator(2))
    ad = jnp.asarray(get_creation_operator(2))

    def hamiltonian(params, c, t):
        detuning = params[0]
        return ((1.0 + detuning) * h0 + c[0] * a + jnp.conjugate(c[0]) * ad)

    initial_states = np.array([[[1.0], [0.0]]])
    target_states = np.array([[[0.0], [1.0]]])
    return hamiltonian, initial_states, target_states


def test_devices_available():
    assert jax.device_count() == 8


def test_ensemble_sharded_matches_single_device():
    hamiltonian, initial_states, target_states = _ensemble_setup()
    costs = [TargetStateInfidelity(target_states)]
    params = RNG.normal(scale=0.05, size=(8, 1))
    kwargs = dict(complex_controls=True, iteration_count=12,
                  log_iteration_step=0,
                  optimizer=Adam(learning_rate=0.01))
    sharded = grape_schroedinger_ensemble(
        1, 11, costs, 10, hamiltonian, params, initial_states, 11,
        mesh=make_mesh(8), **kwargs)
    single = grape_schroedinger_ensemble(
        1, 11, costs, 10, hamiltonian, params, initial_states, 11,
        mesh=make_mesh(1), **kwargs)
    assert np.isclose(sharded.best_error, single.best_error, rtol=1e-9)
    assert np.allclose(sharded.best_controls, single.best_controls,
                       atol=1e-9)
    assert sharded.best_final_states.shape == (8, 1, 2, 1)


def test_ensemble_optimizes_mean_error():
    hamiltonian, initial_states, target_states = _ensemble_setup()
    costs = [TargetStateInfidelity(target_states)]
    params = RNG.normal(scale=0.02, size=(8, 1))
    result = grape_schroedinger_ensemble(
        1, 11, costs, 10, hamiltonian, params, initial_states, 11,
        complex_controls=True, iteration_count=150, log_iteration_step=0,
        mesh=make_mesh(8), optimizer=Adam(learning_rate=0.02))
    assert result.best_error < 0.05


def test_ensemble_member_count_divisibility_checked():
    hamiltonian, initial_states, target_states = _ensemble_setup()
    costs = [TargetStateInfidelity(target_states)]
    params = RNG.normal(size=(6, 1))  # not divisible by 8
    try:
        grape_schroedinger_ensemble(
            1, 5, costs, 5, hamiltonian, params, initial_states, 5,
            complex_controls=True, iteration_count=1, log_iteration_step=0,
            mesh=make_mesh(8))
        raised = False
    except ValueError:
        raised = True
    assert raised


def test_multistart_beats_or_matches_single_start():
    from qoc_tpu.parallel import grape_schroedinger_multistart
    hamiltonian0, initial_states, target_states = _ensemble_setup()
    hamiltonian = lambda c, t: hamiltonian0(np.zeros(1), c, t)
    costs = [TargetStateInfidelity(target_states)]
    result = grape_schroedinger_multistart(
        1, 11, costs, 10, hamiltonian, initial_states, 11, n_starts=8,
        complex_controls=True, iteration_count=60, log_iteration_step=0,
        mesh=make_mesh(8, axis_name="candidate"),
        optimizer=Adam(learning_rate=0.02))
    assert result.errors.shape == (8,)
    assert result.best_error == result.errors.min()
    assert result.best_controls.shape == (11, 1)
    assert np.isfinite(result.best_error)
    # best candidate made progress from ~0.97 initial error
    assert result.best_error < 0.5

def _linear_ensemble_case(seed, n_members, n_shards, step_costs):
    """Loss and gradient of a member-sharded EnsembleLinearHamiltonian
    ensemble against the float64 oracle (mean of the member losses), and
    the sharded loss against the one-device loss."""
    from oracles import (basis_states, check_value_and_grad, linear_h,
                         random_problem, schroedinger_traj, state_fidelity)
    from qoc_tpu.models import (EnsembleLinearHamiltonian,
                                GrapeSchroedingerDiscreteState,
                                InterpolationPolicy, MagnusPolicy)
    from qoc_tpu.parallel import build_ensemble_loss
    from qoc_tpu.standard import ForbidStates

    rng = np.random.default_rng(seed)
    d, n_c, n_steps = 4, 2 if not step_costs else 1, 25
    h0, ops = random_problem(rng, d, n_c)
    ens_ham = EnsembleLinearHamiltonian(h0, ops, [h0])  # (1+delta) * h0
    params = rng.normal(scale=0.05, size=(n_members, 1))
    initial, target = basis_states(d, [0]), basis_states(d, [d - 1])
    forb = basis_states(d, [1])[:, None]
    costs = [TargetStateInfidelity(target)]
    if step_costs:
        costs.append(ForbidStates(forb, n_steps + 1))
    pstate = GrapeSchroedingerDiscreteState(
        True, n_c, n_steps, 1, costs, 2.0, None, None,
        np.zeros((n_steps, n_c), dtype=complex), initial,
        InterpolationPolicy.LINEAR, 1, 0, [10.0] * n_c, MagnusPolicy.M2, 0,
        Adam(), None, False, 0, n_steps + 1)
    shape = pstate.controls_shape

    def oracle(flat):
        total = 0.0
        for delta in params[:, 0]:
            traj = schroedinger_traj(linear_h((1 + delta) * h0, ops), flat,
                                     shape, n_steps, MagnusPolicy.M2,
                                     initial)
            total += 1 - state_fidelity(target, traj[-1])
            if step_costs:
                total += sum(abs(np.vdot(forb[0, 0], s[0])) ** 2
                             for s in traj) / n_steps
        return total / n_members

    loss = build_ensemble_loss(pstate, ens_ham, params, make_mesh(n_shards))
    check_value_and_grad(loss, oracle, shape, rng)
    single = build_ensemble_loss(pstate, ens_ham, params, make_mesh(1))
    flat = jnp.asarray(0.3 * rng.normal(size=(2 * n_steps * n_c,)))
    controls = flat[:flat.size // 2] + 1j * flat[flat.size // 2:]
    controls = controls.reshape(shape)
    assert np.isclose(float(loss(controls)[0]), float(single(controls)[0]),
                      rtol=1e-12)


def test_linear_ensemble_matches_scipy():
    _linear_ensemble_case(33, 8, 8, step_costs=False)


def test_linear_ensemble_step_costs_match_scipy():
    _linear_ensemble_case(35, 4, 4, step_costs=True)


def test_state_axis_sharding_matches_single_device():
    """mesh= on the plain driver shards the K state axis (gate synthesis:
    K = d unitary columns) with results identical to the unsharded run."""
    from qoc_tpu import grape_schroedinger_discrete
    from qoc_tpu.standard import (column_vector_list_to_matrix,
                                  matrix_to_column_vector_list)
    rng = np.random.default_rng(5)
    d = 8
    h = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    h0 = (h + h.conj().T) / 2
    drive = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    hamiltonian = lambda c, t: (jnp.asarray(h0) + c[0] * jnp.asarray(drive)
                                + jnp.conjugate(c[0])
                                * jnp.asarray(drive.conj().T))
    initial_states = matrix_to_column_vector_list(np.eye(d))
    target_unitary = np.linalg.qr(
        rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))[0]
    target_states = matrix_to_column_vector_list(target_unitary)
    costs = [TargetStateInfidelity(target_states)]
    kwargs = dict(complex_controls=True, iteration_count=8,
                  log_iteration_step=0, optimizer=Adam(learning_rate=0.02))
    sharded = grape_schroedinger_discrete(
        1, 11, costs, 5, hamiltonian, initial_states, 11,
        mesh=make_mesh(8, axis_name="state"), **kwargs)
    single = grape_schroedinger_discrete(
        1, 11, costs, 5, hamiltonian, initial_states, 11, **kwargs)
    assert np.allclose(sharded.errors, single.errors, atol=1e-9)
    assert np.allclose(sharded.best_controls, single.best_controls,
                       atol=1e-9)
    assert sharded.best_final_states.shape == (8, d, 1)


# ---------------------------------------------------------------------------
# Ensemble H5 saving / resume (VERDICT r2 #1, #7)
# ---------------------------------------------------------------------------

def test_ensemble_h5_saving_member_schema(tmp_path):
    """Ensemble runs write member-stacked final/intermediate states into a
    member-extended GRAPE schema (the reference schema has no ensemble
    concept, schroedingermodels.py:276-307); rows must match per-member
    evolve recomputation at the saved controls."""
    import h5py
    from qoc_tpu import evolve_schroedinger_discrete
    hamiltonian, initial_states, target_states = _ensemble_setup()
    costs = [TargetStateInfidelity(target_states)]
    params = RNG.normal(scale=0.05, size=(4, 1))
    save_path = str(tmp_path / "00000_ensemble.h5")
    grape_schroedinger_ensemble(
        1, 5, costs, 4.0, hamiltonian, params, initial_states, 5,
        complex_controls=True, iteration_count=6, log_iteration_step=0,
        mesh=make_mesh(4), optimizer=Adam(learning_rate=0.01),
        save_file_path=save_path, save_iteration_step=2,
        save_intermediate_states=True)
    with h5py.File(save_path, "r") as f:
        finals = np.asarray(f["final_states"])
        inters = np.asarray(f["intermediate_states"])
        errors = np.asarray(f["error"])
        controls_rows = np.asarray(f["controls"])
        saved_params = np.asarray(f["hamiltonian_params"])
    assert finals.shape == (3, 4, 1, 2, 1)
    assert inters.shape == (3, 5, 4, 1, 2, 1)
    assert np.allclose(saved_params, params)
    assert np.all(errors < np.finfo(np.float64).max)
    for m in range(4):
        member_h = lambda c, t, _row=params[m]: hamiltonian(_row, c, t)
        ev = evolve_schroedinger_discrete(
            4.0, member_h, initial_states, 5, controls=controls_rows[2],
            save_intermediate_states=True)
        assert np.allclose(finals[2, m], ev.final_states, atol=1e-9)
        assert np.allclose(inters[2, :, m], ev.intermediate_states,
                           atol=1e-9)
    # The member-aware plot path reads the 6-D intermediate layout.
    from qoc_tpu.plot import plot_state_population
    plot_state_population(save_path, member=2,
                          save_file_path=str(tmp_path / "pop.png"))


def test_ensemble_resume_reproduces_uninterrupted_run(tmp_path):
    """resume_from on the ensemble driver restores params + Adam moments +
    iteration numbering; the extended run's H5 rows must equal the
    uninterrupted run's."""
    import h5py
    hamiltonian, initial_states, target_states = _ensemble_setup()
    costs = [TargetStateInfidelity(target_states)]
    params = RNG.normal(scale=0.05, size=(4, 1))
    kwargs = dict(complex_controls=True, log_iteration_step=0,
                  mesh=make_mesh(4), save_iteration_step=1, fused_chunk=3)

    def run(path, iteration_count, **extra):
        return grape_schroedinger_ensemble(
            1, 5, costs, 4.0, hamiltonian, params, initial_states, 5,
            iteration_count=iteration_count, save_file_path=path,
            optimizer=Adam(learning_rate=0.01), **kwargs, **extra)

    full_path = str(tmp_path / "00000_full.h5")
    run(full_path, 10)
    part_path = str(tmp_path / "00000_part.h5")
    run(part_path, 5)
    resumed = run(part_path, 10, resume_from=part_path)
    assert resumed.iteration_count_ran == 5
    with h5py.File(full_path, "r") as f_full, \
            h5py.File(part_path, "r") as f_res:
        assert np.allclose(np.asarray(f_full["error"]),
                           np.asarray(f_res["error"]), atol=1e-12)
        assert np.allclose(np.asarray(f_full["controls"]),
                           np.asarray(f_res["controls"]), atol=1e-12)
        assert np.asarray(f_res["final_states"]).shape == (10, 4, 1, 2, 1)


def test_path_selection_logged(capsys):
    """One should_log line states which propagation path the loss compiled
    to and its memory plan (time block, remat)."""
    hamiltonian, initial_states, target_states = _ensemble_setup()
    costs = [TargetStateInfidelity(target_states)]
    params = RNG.normal(scale=0.05, size=(4, 1))
    grape_schroedinger_ensemble(
        1, 5, costs, 4.0, hamiltonian, params, initial_states, 5,
        complex_controls=True, iteration_count=1, log_iteration_step=1,
        mesh=make_mesh(4), optimizer=Adam(learning_rate=0.01))
    out = capsys.readouterr().out
    assert "ensemble propagation path = batched Magnus+expm" in out
    assert "4 members x 4 shards" in out

    from qoc_tpu import grape_schroedinger_discrete
    grape_schroedinger_discrete(
        1, 5, costs, 4.0, lambda c, t: hamiltonian(np.zeros(1), c, t),
        initial_states, 5, complex_controls=True, iteration_count=1,
        log_iteration_step=1)
    out = capsys.readouterr().out
    assert "propagation path = blocked batched Magnus" in out
    assert "block=4, remat=False" in out
