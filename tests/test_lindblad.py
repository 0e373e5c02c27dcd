"""Lindblad solver tests: analytic amplitude damping (reference
test_core.py:119-148), scipy solve_ivp oracle (replacing qutip.mesolve),
method cross-checks, and GRAPE plumbing smoke tests.
"""

import numpy as np
from scipy.integrate import solve_ivp

import jax.numpy as jnp

from qoc_tpu import evolve_lindblad_discrete, grape_lindblad_discrete
from qoc_tpu.models import LindbladMethod, MagnusPolicy
from qoc_tpu.optim import Adam
from qoc_tpu.standard import (
    SIGMA_Z,
    TargetDensityInfidelity,
    get_annihilation_operator,
    get_creation_operator,
)

RNG = np.random.default_rng(13)


def _random_hermitian(d):
    h = RNG.normal(size=(d, d)) + 1j * RNG.normal(size=(d, d))
    return (h + h.conj().T) / 2


def _random_density(d):
    s = RNG.normal(size=(d, d)) + 1j * RNG.normal(size=(d, d))
    rho = s @ s.conj().T
    return rho / np.trace(rho)


def test_amplitude_damping_analytic():
    # T1 decay of the excited population: p11(t) = p11(0) exp(-gamma t)
    # (textbook channel, reference test_core.py:119-148).
    gamma = 0.08
    a = get_annihilation_operator(2)
    lindblad_data = lambda t: (np.array([gamma]), np.stack([a]))
    rho0 = np.array([[[0.0, 0.0], [0.0, 1.0]]], dtype=complex)
    t = 7.0
    result = evolve_lindblad_discrete(t, rho0, 2,
                                      lindblad_data=lindblad_data)
    assert np.isclose(result.final_densities[0, 1, 1].real,
                      np.exp(-gamma * t), atol=1e-9)
    assert np.isclose(np.trace(result.final_densities[0]).real, 1.0,
                      atol=1e-9)


def _manual_lindblad_rhs(h, gammas, ops):
    def rhs(t, y):
        rho = y.reshape(h.shape)
        out = -1j * (h @ rho - rho @ h)
        for g, l_op in zip(gammas, ops):
            ld = l_op.conj().T
            p = ld @ l_op
            out = out + g * (l_op @ rho @ ld - 0.5 * p @ rho - 0.5 * rho @ p)
        return out.ravel()
    return rhs


def test_evolve_against_solve_ivp_random_system():
    d = 3
    h = _random_hermitian(d)
    ops = np.stack([RNG.normal(size=(d, d)) + 1j * RNG.normal(size=(d, d))])
    gammas = np.array([0.15])
    rho0 = _random_density(d)
    t_final = 1.5

    hamiltonian = lambda c, t: jnp.asarray(h)
    lindblad_data = lambda t: (gammas, ops)
    result = evolve_lindblad_discrete(
        t_final, rho0[None], 2, hamiltonian=hamiltonian,
        lindblad_data=lindblad_data)

    sol = solve_ivp(_manual_lindblad_rhs(h, gammas, ops), (0, t_final),
                    rho0.ravel(), rtol=1e-12, atol=1e-12)
    expected = sol.y[:, -1].reshape(d, d)
    assert np.allclose(result.final_densities[0], expected, atol=1e-8)


def test_magnus_expm_method_matches_rkdp5_on_fine_mesh():
    d = 2
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    ad = get_creation_operator(2)
    controls = (RNG.normal(size=(5, 1)) + 1j * RNG.normal(size=(5, 1))) * 0.3
    gammas = np.array([0.02])
    ops = np.stack([a])

    def hamiltonian(c, t):
        return (jnp.asarray(h0) + c[0] * jnp.asarray(a)
                + jnp.conjugate(c[0]) * jnp.asarray(ad))

    lindblad_data = lambda t: (gammas, ops)
    rho0 = np.array([[[1.0, 0.0], [0.0, 0.0]]], dtype=complex)

    ref = evolve_lindblad_discrete(
        2.0, rho0, 2, controls=controls, hamiltonian=hamiltonian,
        lindblad_data=lindblad_data)
    fast = evolve_lindblad_discrete(
        2.0, rho0, 101, controls=controls, hamiltonian=hamiltonian,
        lindblad_data=lindblad_data, method=LindbladMethod.MAGNUS_EXPM,
        magnus_policy=MagnusPolicy.M4)
    assert np.allclose(fast.final_densities, ref.final_densities, atol=1e-6)


def test_evolve_intermediate_densities(tmp_path):
    gamma = 0.1
    a = get_annihilation_operator(2)
    lindblad_data = lambda t: (np.array([gamma]), np.stack([a]))
    rho0 = np.array([[[0.0, 0.0], [0.0, 1.0]]], dtype=complex)
    result = evolve_lindblad_discrete(
        1.0, rho0, 5, lindblad_data=lindblad_data,
        save_file_path=str(tmp_path / "lind.h5"),
        save_intermediate_densities=True)
    assert result.intermediate_densities.shape == (5, 1, 2, 2)
    assert np.allclose(result.intermediate_densities[0], rho0)


def _transmon_density_setup():
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    ad = get_creation_operator(2)

    def hamiltonian(c, t):
        return (jnp.asarray(h0) + c[0] * jnp.asarray(a)
                + jnp.conjugate(c[0]) * jnp.asarray(ad))

    initial = np.array([[[1.0, 0.0], [0.0, 0.0]]], dtype=complex)
    target = np.array([[[0.0, 0.0], [0.0, 1.0]]], dtype=complex)
    lindblad_data = lambda t: (np.array([1e-3]),
                               np.stack([get_annihilation_operator(2)]))
    return hamiltonian, initial, target, lindblad_data


def test_grape_lindblad_adam_improves():
    hamiltonian, initial, target, lindblad_data = _transmon_density_setup()
    result = grape_lindblad_discrete(
        1, 11, [TargetDensityInfidelity(target)], 10, initial, 2,
        complex_controls=True, hamiltonian=hamiltonian, iteration_count=30,
        lindblad_data=lindblad_data, log_iteration_step=0,
        max_control_norms=np.array([5.0]),
        optimizer=Adam(learning_rate=0.05))
    assert result.best_error < 0.8747  # initial error for this problem
    assert np.isfinite(result.best_error)


def test_grape_lindblad_respects_max_control_norms():
    hamiltonian, initial, target, lindblad_data = _transmon_density_setup()
    result = grape_lindblad_discrete(
        1, 7, [TargetDensityInfidelity(target)], 5, initial, 2,
        complex_controls=True, hamiltonian=hamiltonian, iteration_count=10,
        lindblad_data=lindblad_data, log_iteration_step=0,
        max_control_norms=np.array([1e-10]))
    assert (np.abs(result.best_controls) <= 1e-10 + 1e-16).all()


def test_grape_lindblad_magnus_expm_method():
    hamiltonian, initial, target, lindblad_data = _transmon_density_setup()
    result = grape_lindblad_discrete(
        1, 11, [TargetDensityInfidelity(target)], 10, initial, 11,
        complex_controls=True, hamiltonian=hamiltonian, iteration_count=40,
        lindblad_data=lindblad_data, log_iteration_step=0,
        max_control_norms=np.array([5.0]),
        method=LindbladMethod.MAGNUS_EXPM,
        optimizer=Adam(learning_rate=0.05))
    # Frobenius density infidelity floor for pure states at d=2 is 0.5.
    assert result.best_error < 0.6


def test_memory_plan_covers_the_vmapped_batch(capsys):
    """Superoperator blocks shrink with the number of copies vmapped side by
    side (ensemble members, multistart candidates)."""
    from qoc_tpu.core.lindblad import build_lindblad_loss
    from qoc_tpu.models import (GrapeLindbladDiscreteState,
                                InterpolationPolicy, LindbladMethod,
                                MagnusPolicy)
    from qoc_tpu.optim import Adam
    from qoc_tpu.standard import TargetDensityInfidelity
    d, n_steps = 20, 100
    rho = np.zeros((1, d, d)); rho[0, 0, 0] = 1
    pstate = GrapeLindbladDiscreteState(
        True, 1, n_steps, 1, [TargetDensityInfidelity(rho)], 10.0,
        lambda c, t: np.zeros((d, d)), None, np.zeros((n_steps, 1), complex),
        rho, InterpolationPolicy.LINEAR, 1, None, 0, [1.0], 0, Adam(), None,
        False, 0, n_steps + 1)
    pstate.method_ = LindbladMethod.MAGNUS_EXPM
    pstate.magnus_policy_ = MagnusPolicy.M2
    build_lindblad_loss(pstate, log_path=True)
    build_lindblad_loss(pstate, log_path=True, batch_size=64)
    single, batched = capsys.readouterr().out.strip().splitlines()
    assert "block=52, remat=False" in single
    assert "block=1, remat=True" in batched
