"""Lindblad parallel-layer tests: ensemble-robust GRAPE over the 8-way
virtual mesh, winners against the float64 oracle, density-batch mesh
sharding, Lindblad multistart, and ensemble H5 saving — the open-system
mirror of tests/test_parallel.py / test_multistart.py (SURVEY.md §2.4
applied to the reference's second flagship entry point,
/root/reference/qoc/core/lindbladdiscrete.py:110-256).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qoc_tpu import (
    evolve_lindblad_discrete,
    grape_lindblad_ensemble,
    grape_lindblad_multistart,
)
from qoc_tpu.models import (
    ConstantLindblad,
    EnsembleLinearHamiltonian,
    LindbladMethod,
    LinearHamiltonian,
)
from qoc_tpu.optim import Adam
from qoc_tpu.parallel import build_lindblad_ensemble_loss, make_mesh
from qoc_tpu.standard import (
    SIGMA_Z,
    TargetDensityInfidelity,
    get_annihilation_operator,
)


def _problem():
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    ens_ham = EnsembleLinearHamiltonian(h0, np.stack((a,)), [h0])
    members = np.linspace(-0.05, 0.05, 4).reshape(-1, 1)
    initial = np.array([[[1.0, 0.0], [0.0, 0.0]]], dtype=complex)
    target = np.array([[[0.0, 0.0], [0.0, 1.0]]], dtype=complex)
    costs = [TargetDensityInfidelity(target)]
    lindblad_data = ConstantLindblad(np.array([1e-3]), np.stack([a]))
    return ens_ham, members, initial, costs, lindblad_data


def test_superoperator_basis_member_layout():
    """EnsembleLinearHamiltonian.superoperator_basis with weights
    [1, delta, Re c, Im c] reproduces the direct Lindblad superoperator of
    the member Hamiltonian."""
    from qoc_tpu.ops.lindblad import lindblad_superoperator
    ens_ham, _, _, _, _ = _problem()
    h0 = ens_ham.h0
    a = ens_ham.operators[0]
    gammas, lops = np.array([0.02]), np.stack([a])
    dt = 0.7
    basis = ens_ham.superoperator_basis(dt, gammas, lops)
    assert basis.shape == (4, 4, 4)  # [s0, s_param, s_P, s_Q]
    delta, c = 0.033, 0.2 - 0.4j
    w = np.array([1.0, delta, c.real, c.imag])
    h_member = (1 + delta) * h0 + c * a + np.conj(c) * a.conj().T
    s_direct = np.asarray(lindblad_superoperator(gammas, h_member, lops,
                                                 hilbert_size=2))
    assert np.allclose(np.einsum("k,kij->ij", w, basis) / dt, s_direct,
                       atol=1e-12)


def test_lindblad_ensemble_sharded_matches_single_rkdp5():
    ens_ham, members, initial, costs, lindblad_data = _problem()
    kwargs = dict(complex_controls=True, iteration_count=6,
                  lindblad_data=lindblad_data, log_iteration_step=0,
                  optimizer=Adam(learning_rate=0.05))
    sharded = grape_lindblad_ensemble(
        1, 7, costs, 5.0, ens_ham, members, initial, 2,
        mesh=make_mesh(4), **kwargs)
    single = grape_lindblad_ensemble(
        1, 7, costs, 5.0, ens_ham, members, initial, 2,
        mesh=make_mesh(1), **kwargs)
    assert sharded.best_final_densities.shape == (4, 1, 2, 2)
    # psum reduces members in a different order than the single-shard sum;
    # the adaptive integrator's long FP chains amplify that reduction-order
    # noise through 6 Adam steps (the MAGNUS twin below holds 1e-10).
    assert abs(sharded.best_error - single.best_error) < 1e-6
    assert np.allclose(sharded.best_controls, single.best_controls,
                       atol=1e-5)
    # Ensemble mean error: each member's trace is preserved.
    traces = np.trace(sharded.best_final_densities, axis1=-2, axis2=-1)
    assert np.allclose(traces, 1.0, atol=1e-6)


def test_lindblad_ensemble_sharded_matches_single_magnus():
    ens_ham, members, initial, costs, lindblad_data = _problem()
    kwargs = dict(complex_controls=True, iteration_count=6,
                  lindblad_data=lindblad_data, log_iteration_step=0,
                  method=LindbladMethod.MAGNUS_EXPM,
                  optimizer=Adam(learning_rate=0.05))
    sharded = grape_lindblad_ensemble(
        1, 7, costs, 5.0, ens_ham, members, initial, 21,
        mesh=make_mesh(4), **kwargs)
    single = grape_lindblad_ensemble(
        1, 7, costs, 5.0, ens_ham, members, initial, 21,
        mesh=make_mesh(1), **kwargs)
    assert abs(sharded.best_error - single.best_error) < 1e-10
    assert np.allclose(sharded.best_controls, single.best_controls,
                       atol=1e-10)


def _winner_oracle(result, members=None, forb=None, n_steps=20):
    """Best error against the float64 oracle at the recorded (clipped,
    evaluated) best controls: the member-mean final density infidelity plus
    the per-step forbidden-density penalty."""
    from oracles import (density_fidelity, flat_controls, lindblad_traj,
                         linear_h)
    from qoc_tpu.models import MagnusPolicy
    _, _, initial, _, _ = _problem()
    target = np.array([[[0.0, 0.0], [0.0, 1.0]]], dtype=complex)
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    flat = flat_controls(result.best_controls)
    deltas = [0.0] if members is None else members[:, 0]
    total = 0.0
    for delta in deltas:
        traj = lindblad_traj(linear_h((1 + delta) * h0, a[None]), [1e-3],
                             a[None], flat, result.best_controls.shape,
                             n_steps, MagnusPolicy.M2, initial,
                             evolution_time=5.0)
        total += 1 - density_fidelity(target, traj[-1])
        if forb is not None:
            total += sum(abs(np.trace(forb[0, 0].conj().T @ rho[0]) / 2) ** 2
                         for rho in traj) / n_steps
    assert abs(result.best_error - total / len(deltas)) < 1e-9


def test_lindblad_ensemble_winner_matches_scipy():
    ens_ham, members, initial, costs, lindblad_data = _problem()
    result = grape_lindblad_ensemble(
        1, 7, costs, 5.0, ens_ham, members, initial, 21,
        complex_controls=True, iteration_count=5,
        lindblad_data=lindblad_data, log_iteration_step=0,
        method=LindbladMethod.MAGNUS_EXPM,
        optimizer=Adam(learning_rate=0.05), mesh=make_mesh(4))
    _winner_oracle(result, members=members)


def test_lindblad_ensemble_step_costs_winner_matches_scipy():
    """Step costs (ForbidDensities) ride the member-sharded loss."""
    from qoc_tpu.standard import ForbidDensities
    ens_ham, members, initial, costs, lindblad_data = _problem()
    forb = np.zeros((1, 1, 2, 2), dtype=complex)
    forb[0, 0, 0, 1] = forb[0, 0, 1, 0] = 0.5
    costs = costs + [ForbidDensities(forb, 21)]
    result = grape_lindblad_ensemble(
        1, 7, costs, 5.0, ens_ham, members, initial, 21,
        complex_controls=True, iteration_count=4,
        lindblad_data=lindblad_data, log_iteration_step=0,
        method=LindbladMethod.MAGNUS_EXPM,
        optimizer=Adam(learning_rate=0.05), mesh=make_mesh(4))
    _winner_oracle(result, members=members, forb=forb)


def test_lindblad_ensemble_h5_saving(tmp_path):
    """Member-extended schema: final_densities rows carry the leading member
    axis and match per-member evolve recomputation."""
    import h5py
    ens_ham, members, initial, costs, lindblad_data = _problem()
    path = str(tmp_path / "00000_lens.h5")
    result = grape_lindblad_ensemble(
        1, 7, costs, 5.0, ens_ham, members, initial, 2,
        complex_controls=True, iteration_count=4,
        lindblad_data=lindblad_data, log_iteration_step=0,
        optimizer=Adam(learning_rate=0.05), mesh=make_mesh(4),
        save_file_path=path, save_iteration_step=2)
    with h5py.File(path, "r") as f:
        finals = np.asarray(f["final_densities"])
        controls_rows = np.asarray(f["controls"])
        errors = np.asarray(f["error"])
        saved_members = np.asarray(f["hamiltonian_params"])
    assert finals.shape == (2, 4, 1, 2, 2)
    assert np.allclose(saved_members, members)
    # Recompute each member's final density from the saved controls.
    for m in range(4):
        row = members[m]
        ev = evolve_lindblad_discrete(
            5.0, initial, 2, controls=controls_rows[0],
            hamiltonian=ens_ham.member(row), lindblad_data=lindblad_data)
        assert np.allclose(ev.final_densities, finals[0, m], atol=1e-8)
    assert np.isfinite(errors).all()
    assert result.best_error <= errors[-1] + 1e-12


def test_lindblad_density_batch_mesh_matches_single():
    """mesh= on evolve_lindblad_discrete shards the density-batch axis K
    without changing the result (SURVEY.md §2.4 row 1, Lindblad analog)."""
    rng = np.random.default_rng(5)
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    lindblad_data = ConstantLindblad(np.array([0.05]), np.stack([a]))
    rhos = []
    for _ in range(8):
        s = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
        rho = s @ s.conj().T
        rhos.append(rho / np.trace(rho))
    rhos = np.stack(rhos)
    hamiltonian = lambda c, t: jnp.asarray(h0)
    sharded = evolve_lindblad_discrete(
        2.0, rhos, 2, hamiltonian=hamiltonian, lindblad_data=lindblad_data,
        mesh=make_mesh(8, axis_name="density"))
    single = evolve_lindblad_discrete(
        2.0, rhos, 2, hamiltonian=hamiltonian, lindblad_data=lindblad_data)
    assert np.allclose(sharded.final_densities, single.final_densities,
                       atol=1e-10)
    assert abs(sharded.error - single.error) < 1e-12


def test_lindblad_multistart_sharded_matches_single():
    _, _, initial, costs, lindblad_data = _problem()
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    hamiltonian = LinearHamiltonian(h0, np.stack((a,)))
    kwargs = dict(n_starts=8, complex_controls=True, iteration_count=8,
                  hamiltonian=hamiltonian, lindblad_data=lindblad_data,
                  log_iteration_step=0, optimizer=Adam(learning_rate=0.05),
                  method=LindbladMethod.MAGNUS_EXPM, fused_chunk=4)
    sharded = grape_lindblad_multistart(
        1, 7, costs, 5.0, initial, 21,
        mesh=make_mesh(8, axis_name="candidate"), **kwargs)
    single = grape_lindblad_multistart(
        1, 7, costs, 5.0, initial, 21,
        mesh=make_mesh(1, axis_name="candidate"), **kwargs)
    assert sharded.errors.shape == (8,)
    assert np.allclose(sharded.errors, single.errors, atol=1e-9)
    assert np.allclose(sharded.best_controls, single.best_controls,
                       atol=1e-9)
    assert sharded.best_error == sharded.errors.min()
    assert sharded.best_final_densities.shape == (1, 2, 2)


def test_lindblad_multistart_winner_matches_scipy():
    _, _, initial, costs, lindblad_data = _problem()
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    result = grape_lindblad_multistart(
        1, 7, costs, 5.0, initial, 21, n_starts=4, complex_controls=True,
        iteration_count=5, hamiltonian=LinearHamiltonian(h0, np.stack((a,))),
        lindblad_data=lindblad_data, log_iteration_step=0,
        optimizer=Adam(learning_rate=0.05),
        method=LindbladMethod.MAGNUS_EXPM, fused_chunk=3,
        mesh=make_mesh(4, axis_name="candidate"))
    assert result.best_error == result.errors.min()
    _winner_oracle(result)


def test_lindblad_multistart_ensemble_2d_mesh():
    from jax.sharding import Mesh
    ens_ham, members, initial, costs, lindblad_data = _problem()
    devices = np.asarray(jax.devices())
    kwargs = dict(n_starts=4, complex_controls=True, iteration_count=5,
                  hamiltonian=ens_ham, hamiltonian_params=members,
                  lindblad_data=lindblad_data, log_iteration_step=0,
                  optimizer=Adam(learning_rate=0.05),
                  method=LindbladMethod.MAGNUS_EXPM, fused_chunk=5)
    r2d = grape_lindblad_multistart(
        1, 7, costs, 5.0, initial, 21,
        mesh=Mesh(devices.reshape(4, 2), ("candidate", "ensemble")),
        **kwargs)
    r1d = grape_lindblad_multistart(
        1, 7, costs, 5.0, initial, 21,
        mesh=Mesh(devices.reshape(8, 1)[:4], ("candidate", "ensemble")),
        **kwargs)
    assert np.allclose(r2d.errors, r1d.errors, atol=1e-9)
    assert r2d.best_final_densities.shape == (4, 1, 2, 2)


def test_lindblad_multistart_rejects_host_only_optimizer():
    from qoc_tpu.optim import LBFGSB
    _, _, initial, costs, lindblad_data = _problem()
    with pytest.raises(ValueError, match="LBFGSB is host-loop only"):
        grape_lindblad_multistart(
            1, 7, costs, 5.0, initial, 2, n_starts=4,
            lindblad_data=lindblad_data, optimizer=LBFGSB())


def test_lindblad_multistart_ensemble_h5_winner_rows(tmp_path):
    """Ensemble Lindblad multistart writes member-extended winner rows;
    each row's member-stacked final densities match per-member evolve
    recomputation at the saved winner controls."""
    import h5py
    ens_ham, members, initial, costs, lindblad_data = _problem()
    path = str(tmp_path / "00000_ms_lens.h5")
    result = grape_lindblad_multistart(
        1, 7, costs, 5.0, initial, 21, n_starts=8, complex_controls=True,
        hamiltonian=ens_ham, hamiltonian_params=members,
        lindblad_data=lindblad_data, iteration_count=4,
        log_iteration_step=0, method=LindbladMethod.MAGNUS_EXPM,
        optimizer=Adam(learning_rate=0.05), save_file_path=path,
        save_iteration_step=2)
    with h5py.File(path, "r") as f:
        finals = np.asarray(f["final_densities"])
        controls_rows = np.asarray(f["controls"])
        saved_members = np.asarray(f["hamiltonian_params"])
        errors = np.asarray(f["error"])
    assert finals.shape == (2, 4, 1, 2, 2)
    assert np.allclose(saved_members, members)
    assert np.isfinite(errors).all()
    for m in range(4):
        ev = evolve_lindblad_discrete(
            5.0, initial, 21, controls=controls_rows[1],
            hamiltonian=ens_ham.member(members[m]),
            lindblad_data=lindblad_data,
            method=LindbladMethod.MAGNUS_EXPM)
        assert np.allclose(ev.final_densities, finals[1, m], atol=1e-7)
    assert result.best_final_densities.shape == (4, 1, 2, 2)


def test_lindblad_multistart_resume_reproduces_uninterrupted(tmp_path):
    """Kill-at-chunk-boundary + resume_from on the Lindblad multistart
    reproduces the uninterrupted run exactly (shared _msrunner checkpoint
    machinery, exercised through the open-system driver)."""
    ens_ham, members, initial, costs, lindblad_data = _problem()
    kwargs = dict(n_starts=8, complex_controls=True,
                  hamiltonian=ens_ham, hamiltonian_params=members,
                  lindblad_data=lindblad_data, log_iteration_step=0,
                  method=LindbladMethod.MAGNUS_EXPM,
                  optimizer=Adam(learning_rate=0.05), fused_chunk=3)
    full = grape_lindblad_multistart(
        1, 7, costs, 5.0, initial, 21, iteration_count=9,
        save_file_path=str(tmp_path / "00000_full.h5"),
        save_iteration_step=3, **kwargs)
    killed = str(tmp_path / "00000_killed.h5")
    grape_lindblad_multistart(
        1, 7, costs, 5.0, initial, 21, iteration_count=6,
        save_file_path=killed, **kwargs)
    resumed = grape_lindblad_multistart(
        1, 7, costs, 5.0, initial, 21, iteration_count=9,
        resume_from=killed, **kwargs)
    assert resumed.iteration_count_ran == 3
    assert np.array_equal(resumed.errors, full.errors)
    assert np.array_equal(resumed.best_controls, full.best_controls)
    assert resumed.best_error == full.best_error


def test_lindblad_ensemble_intermediate_densities(tmp_path):
    """save_intermediate_densities on the ensemble driver writes the
    member-extended (S, M, K, d, d) layout; rows match per-member evolve
    recomputation at the saved controls."""
    import h5py
    ens_ham, members, initial, costs, lindblad_data = _problem()
    path = str(tmp_path / "00000_lint.h5")
    grape_lindblad_ensemble(
        1, 7, costs, 5.0, ens_ham, members, initial, 5,
        complex_controls=True, iteration_count=2,
        lindblad_data=lindblad_data, log_iteration_step=0,
        method=LindbladMethod.MAGNUS_EXPM, mesh=make_mesh(4),
        optimizer=Adam(learning_rate=0.05), save_file_path=path,
        save_iteration_step=1, save_intermediate_densities=True)
    with h5py.File(path, "r") as f:
        inters = np.asarray(f["intermediate_densities"])
        controls_rows = np.asarray(f["controls"])
    assert inters.shape == (2, 5, 4, 1, 2, 2)
    for m in range(4):
        ev = evolve_lindblad_discrete(
            5.0, initial, 5, controls=controls_rows[1],
            hamiltonian=ens_ham.member(members[m]),
            lindblad_data=lindblad_data,
            method=LindbladMethod.MAGNUS_EXPM,
            save_intermediate_densities=True,
            save_file_path=str(tmp_path / "{:05d}_ev.h5".format(m + 1)))
        with h5py.File(str(tmp_path / "{:05d}_ev.h5".format(m + 1)),
                       "r") as f:
            ev_inters = np.asarray(f["intermediate_densities"])
        assert np.allclose(inters[1, :, m], ev_inters, atol=1e-8)


def test_lindblad_ensemble_resume_reproduces_uninterrupted(tmp_path):
    """resume_from on the Lindblad ensemble driver restores params + Adam
    moments + iteration numbering; the extended run's member-extended H5
    rows must equal the uninterrupted run's."""
    import h5py
    ens_ham, members, initial, costs, lindblad_data = _problem()
    kwargs = dict(complex_controls=True, lindblad_data=lindblad_data,
                  log_iteration_step=0, mesh=make_mesh(4),
                  method=LindbladMethod.MAGNUS_EXPM, save_iteration_step=1,
                  fused_chunk=3)

    def run(path, iteration_count, **extra):
        return grape_lindblad_ensemble(
            1, 7, costs, 5.0, ens_ham, members, initial, 5,
            iteration_count=iteration_count, save_file_path=path,
            optimizer=Adam(learning_rate=0.05), **kwargs, **extra)

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
        assert np.asarray(f_res["final_densities"]).shape == (10, 4, 1, 2, 2)


@pytest.mark.xfail(
    strict=True,
    reason="JAX 0.9.0 varying-axis checker rejects the RKDP5 bounded-scan "
           "stepper under vmap inside shard_map; when a JAX upgrade makes "
           "this pass, delete parallel/lindblad._RKDP5_FORCE_LEGACY_VMA "
           "and both check_vma downgrades keyed on it.")
def test_rkdp5_check_vma_workaround_still_needed(monkeypatch):
    """Tripwire for the check_vma=False workaround (VERDICT r3 Weak #3):
    runs the sharded RKDP5 ensemble loss with the downgrade disabled, i.e.
    check_vma=True all the way through shard_map."""
    import qoc_tpu.parallel.lindblad as pl
    monkeypatch.setattr(pl, "_RKDP5_FORCE_LEGACY_VMA", False)
    ens_ham, members, initial, costs, lindblad_data = _problem()
    result = grape_lindblad_ensemble(
        1, 7, costs, 5.0, ens_ham, members, initial, 2,
        complex_controls=True, iteration_count=2,
        lindblad_data=lindblad_data, log_iteration_step=0,
        optimizer=Adam(learning_rate=0.05), mesh=make_mesh(4))
    assert np.isfinite(result.best_error)
