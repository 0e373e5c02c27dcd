"""Schrödinger solver tests: scipy solve_ivp as oracle (the reference used
qutip.mesolve, test_core.py:471-560), analytic closed forms, GRAPE plumbing
smoke tests, and fused-vs-host path equivalence.
"""

import numpy as np
from scipy.integrate import solve_ivp

import jax
import jax.numpy as jnp

from qoc_tpu import evolve_schroedinger_discrete, grape_schroedinger_discrete
from qoc_tpu.models import MagnusPolicy
from qoc_tpu.optim import Adam, SGD
from qoc_tpu.standard import (
    SIGMA_X,
    SIGMA_Y,
    SIGMA_Z,
    TargetStateInfidelity,
    TargetStateInfidelityTime,
    get_annihilation_operator,
    get_creation_operator,
    krons,
)

RNG = np.random.default_rng(5)


def _random_hermitian(d):
    h = RNG.normal(size=(d, d)) + 1j * RNG.normal(size=(d, d))
    return (h + h.conj().T) / 2


def _random_states(k, d):
    s = RNG.normal(size=(k, d, 1)) + 1j * RNG.normal(size=(k, d, 1))
    return s / np.linalg.norm(s, axis=1, keepdims=True)


def _interp_controls_np(t, times, controls):
    """The linear interpolation the framework applies, replicated with numpy
    for the oracle (clamped-bracket linear, extrapolating at the ends)."""
    idx = np.searchsorted(times, t, side="left")
    idx = min(max(idx, 1), len(times) - 1)
    x1, x2 = times[idx - 1], times[idx]
    y1, y2 = controls[idx - 1], controls[idx]
    return y1 + (y2 - y1) / (x2 - x1) * (t - x1)


def test_evolve_against_solve_ivp_random_system():
    d, k = 4, 2
    h0 = _random_hermitian(d)
    hc = _random_hermitian(d)
    evolution_time = 2.0
    control_eval_count = 9
    controls = (RNG.normal(size=(control_eval_count, 1))
                + 1j * RNG.normal(size=(control_eval_count, 1)))
    times = np.linspace(0, evolution_time, control_eval_count)
    states0 = _random_states(k, d)

    def hamiltonian(c, t):
        return (jnp.asarray(h0) + c[0] * jnp.asarray(hc)
                + jnp.conjugate(c[0]) * jnp.asarray(hc).conj().T)

    result = evolve_schroedinger_discrete(
        evolution_time, hamiltonian, states0, 201, controls=controls,
        magnus_policy=MagnusPolicy.M4)

    def rhs(t, y):
        c = _interp_controls_np(t, times, controls)
        h = h0 + c[0] * hc + np.conjugate(c[0]) * hc.conj().T
        return (-1j * h @ y.reshape(d, k)).ravel()

    y0 = states0[:, :, 0].T.astype(complex)  # (d, k)
    sol = solve_ivp(rhs, (0, evolution_time), y0.ravel(), rtol=1e-12,
                    atol=1e-12)
    expected = sol.y[:, -1].reshape(d, k).T[:, :, None]
    assert np.allclose(result.final_states, expected, atol=1e-6)


def test_evolve_iswap_closed_form():
    # H = (XX + YY) / 2 at t = pi/2 realizes the iSWAP mixing
    # |01> -> -i |10> (analytic pattern of reference test_core.py:85-106).
    xx = np.asarray(krons(jnp.asarray(SIGMA_X), jnp.asarray(SIGMA_X)))
    yy = np.asarray(krons(jnp.asarray(SIGMA_Y), jnp.asarray(SIGMA_Y)))
    h = (xx + yy) / 2
    hamiltonian = lambda c, t: jnp.asarray(h)
    s01 = np.zeros((4, 1)); s01[1] = 1
    s10 = np.zeros((4, 1)); s10[2] = 1
    result = evolve_schroedinger_discrete(np.pi / 2, hamiltonian,
                                          np.stack((s01, s10)), 60)
    assert np.allclose(result.final_states[0], -1j * s10, atol=1e-7)
    assert np.allclose(result.final_states[1], -1j * s01, atol=1e-7)


def test_evolve_magnus_policies_agree_on_constant_h():
    h = _random_hermitian(3)
    hamiltonian = lambda c, t: jnp.asarray(h)
    states0 = _random_states(2, 3)
    results = [
        evolve_schroedinger_discrete(1.0, hamiltonian, states0, 11,
                                     magnus_policy=mp).final_states
        for mp in (MagnusPolicy.M2, MagnusPolicy.M4, MagnusPolicy.M6)
    ]
    assert np.allclose(results[0], results[1], atol=1e-10)
    assert np.allclose(results[0], results[2], atol=1e-10)


def test_evolve_intermediate_states_shape(tmp_path):
    h = _random_hermitian(2)
    hamiltonian = lambda c, t: jnp.asarray(h)
    states0 = _random_states(1, 2)
    save_path = str(tmp_path / "evolve.h5")
    result = evolve_schroedinger_discrete(1.0, hamiltonian, states0, 5,
                                          save_file_path=save_path,
                                          save_intermediate_states=True)
    assert result.intermediate_states.shape == (5, 1, 2, 1)
    assert np.allclose(result.intermediate_states[0], states0)
    assert np.allclose(result.intermediate_states[-1], result.final_states)


def _transmon_setup():
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    ad = get_creation_operator(2)

    def hamiltonian(c, t):
        return (jnp.asarray(h0) + c[0] * jnp.asarray(a)
                + jnp.conjugate(c[0]) * jnp.asarray(ad))

    initial_states = np.array([[[1.0], [0.0]]])
    target_states = np.array([[[0.0], [1.0]]])
    return hamiltonian, initial_states, target_states


def test_grape_transmon_pi_converges():
    hamiltonian, initial_states, target_states = _transmon_setup()
    result = grape_schroedinger_discrete(
        1, 11, [TargetStateInfidelity(target_states)], 10, hamiltonian,
        initial_states, 11, complex_controls=True, iteration_count=300,
        log_iteration_step=0)
    assert result.best_error < 1e-4
    assert result.best_controls.shape == (11, 1)


def test_grape_respects_max_control_norms():
    # Plumbing smoke test (reference test_core.py:563-602): tiny max norm,
    # best controls must respect the clip.
    hamiltonian, initial_states, target_states = _transmon_setup()
    result = grape_schroedinger_discrete(
        1, 7, [TargetStateInfidelity(target_states)], 5, hamiltonian,
        initial_states, 7, complex_controls=True, iteration_count=20,
        log_iteration_step=0, max_control_norms=np.array([1e-10]))
    assert (np.abs(result.best_controls) <= 1e-10 + 1e-16).all()


def test_grape_fused_matches_host_loop():
    # The fused on-device scan must produce the same trajectory as the
    # reference-style per-iteration host loop (forced via an identity
    # impose_control_conditions hook).
    hamiltonian, initial_states, target_states = _transmon_setup()
    costs = [TargetStateInfidelity(target_states)]
    kwargs = dict(complex_controls=True, iteration_count=25,
                  log_iteration_step=0)
    fused = grape_schroedinger_discrete(
        1, 11, costs, 10, hamiltonian, initial_states, 11, **kwargs)
    host = grape_schroedinger_discrete(
        1, 11, costs, 10, hamiltonian, initial_states, 11,
        impose_control_conditions=lambda c: c, **kwargs)
    assert np.isclose(fused.best_error, host.best_error, rtol=1e-10)
    assert np.allclose(fused.best_controls, host.best_controls, atol=1e-10)


def test_grape_min_error_terminates_early():
    hamiltonian, initial_states, target_states = _transmon_setup()
    result = grape_schroedinger_discrete(
        1, 11, [TargetStateInfidelity(target_states)], 10, hamiltonian,
        initial_states, 11, complex_controls=True, iteration_count=10000,
        log_iteration_step=0, min_error=1e-3)
    assert result.best_error <= 1e-3
    assert result.iteration_count_ran < 10000


def test_grape_step_cost_path():
    hamiltonian, initial_states, target_states = _transmon_setup()
    costs = [TargetStateInfidelityTime(11, target_states)]
    result = grape_schroedinger_discrete(
        1, 11, costs, 10, hamiltonian, initial_states, 11,
        complex_controls=True, iteration_count=50, log_iteration_step=0)
    assert np.isfinite(result.best_error)
    assert result.best_error < 1.0


def test_grape_sgd_and_real_controls():
    hamiltonian, initial_states, target_states = _transmon_setup()
    result = grape_schroedinger_discrete(
        1, 7, [TargetStateInfidelity(target_states)], 5, hamiltonian,
        initial_states, 7, complex_controls=False, iteration_count=10,
        log_iteration_step=0, optimizer=SGD(learning_rate=1e-2))
    assert result.best_controls.dtype.kind == "f"
    assert np.isfinite(result.best_error)


def test_grape_impose_control_conditions_applied():
    hamiltonian, initial_states, target_states = _transmon_setup()

    def impose(controls):
        controls = np.array(controls)
        controls[0] = 0
        controls[-1] = 0
        return controls

    result = grape_schroedinger_discrete(
        1, 7, [TargetStateInfidelity(target_states)], 5, hamiltonian,
        initial_states, 7, complex_controls=True, iteration_count=8,
        log_iteration_step=0, impose_control_conditions=impose)
    assert result.best_controls[0, 0] == 0
    assert result.best_controls[-1, 0] == 0


def test_time_block_size_does_not_change_results():
    hamiltonian, initial_states, target_states = _transmon_setup()
    costs = [TargetStateInfidelity(target_states)]
    kwargs = dict(complex_controls=True, iteration_count=15,
                  log_iteration_step=0)
    default = grape_schroedinger_discrete(
        1, 11, costs, 10, hamiltonian, initial_states, 11, **kwargs)
    tiny_blocks = grape_schroedinger_discrete(
        1, 11, costs, 10, hamiltonian, initial_states, 11,
        time_block_size=3, **kwargs)
    assert np.isclose(default.best_error, tiny_blocks.best_error, atol=1e-10)
    assert np.allclose(default.best_controls, tiny_blocks.best_controls,
                       atol=1e-9)


def test_grape_unitary_synthesizes_x_gate():
    from qoc_tpu import grape_unitary
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    ad = get_creation_operator(2)
    hamiltonian = lambda c, t: (h0 + c[0] * a + jnp.conjugate(c[0]) * ad)
    target = np.asarray(SIGMA_X, dtype=complex)
    result = grape_unitary(1, 11, 10, hamiltonian, target, 11,
                           complex_controls=True, iteration_count=400,
                           log_iteration_step=0)
    assert result.best_error < 1e-3
    assert result.best_final_states.shape == (2, 2, 1)


def test_cost_eval_step_thinning_matches_manual():
    # Step costs must be evaluated only at system steps divisible by
    # cost_eval_step (and never at step 0) — reference
    # schroedingerdiscrete.py:404-415.
    from qoc_tpu.standard import ForbidStates
    h = _random_hermitian(3)
    hamiltonian = lambda c, t: jnp.asarray(h)
    states0 = _random_states(1, 3)
    forbidden = _random_states(1, 3)[None]  # (1, 1, 3, 1)
    system_eval_count = 9
    cost_eval_step = 2
    cost = ForbidStates(forbidden, system_eval_count,
                        cost_eval_step=cost_eval_step)
    result = evolve_schroedinger_discrete(
        1.0, hamiltonian, states0, system_eval_count, costs=[cost],
        cost_eval_step=cost_eval_step, save_intermediate_states=True,
        save_file_path=None)
    # Manual: the same cost applied to the recorded trajectory at steps
    # k in {2, 4, 6, 8}.
    expected = 0.0
    for k in range(1, system_eval_count):
        if k % cost_eval_step == 0:
            states_k = jnp.asarray(result.intermediate_states[k])
            expected += float(cost.cost(None, states_k, k))
    assert np.isclose(result.error, expected, atol=1e-10)


def test_full_grape_loss_gradient_matches_finite_differences():
    # End-to-end gradient check of the jitted propagation loss (not just
    # expm): interpolation -> Magnus -> expm -> costs, vs central
    # differences on the stripped real parameters.
    from qoc_tpu.core.common import (initialize_controls, strip_controls,
                                     slap_controls_jax)
    from qoc_tpu.core.schroedinger import build_schroedinger_loss
    from qoc_tpu.models import (GrapeSchroedingerDiscreteState,
                                InterpolationPolicy, MagnusPolicy)

    hamiltonian, initial_states, target_states = _transmon_setup()
    costs = [TargetStateInfidelity(target_states)]
    ic, mcn = initialize_controls(True, 1, 7, 5.0, None, None)
    pstate = GrapeSchroedingerDiscreteState(
        True, 1, 7, 1, costs, 5.0, hamiltonian, None, ic, initial_states,
        InterpolationPolicy.LINEAR, 1, 0, mcn, MagnusPolicy.M4, 0, Adam(),
        None, False, 0, 9)
    loss = build_schroedinger_loss(pstate)

    def loss_flat(p):
        return loss(slap_controls_jax(True, p, (7, 1)))[0]

    x0 = jnp.asarray(strip_controls(True, ic))
    grad = np.asarray(jax.grad(loss_flat)(x0))
    rng = np.random.default_rng(2)
    eps = 1e-6
    for idx in rng.choice(x0.size, size=5, replace=False):
        e = np.zeros(x0.size)
        e[idx] = 1.0
        fd = (float(loss_flat(x0 + eps * e))
              - float(loss_flat(x0 - eps * e))) / (2 * eps)
        assert abs(fd - grad[idx]) < 1e-6, (idx, fd, grad[idx])


def test_linear_hamiltonian_callable_formula():
    from qoc_tpu.models import LinearHamiltonian
    rng = np.random.default_rng(9)
    d, n_c = 6, 3
    h0 = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    h0 = (h0 + h0.conj().T) / 2
    ops = rng.normal(size=(n_c, d, d)) + 1j * rng.normal(size=(n_c, d, d))
    ham = LinearHamiltonian(h0, ops)
    c = (rng.normal(size=(n_c,)) + 1j * rng.normal(size=(n_c,)))
    got = np.asarray(ham(jnp.asarray(c.astype(np.complex128)), 0.3))
    want = h0.copy()
    for i in range(n_c):
        want = want + c[i] * ops[i] + np.conj(c[i]) * ops[i].conj().T
    assert np.allclose(got, want, atol=1e-10)
    # Hermitian basis reconstruction: H == 1*h0 + sum Re(c) P + Im(c) Q
    basis = ham.hermitian_basis()
    w = np.concatenate([[1.0], np.stack([c.real, c.imag], -1).ravel()])
    recon = np.tensordot(w, basis, axes=(0, 0))
    assert np.allclose(recon, want, atol=1e-10)


def test_memory_plan_covers_the_vmapped_batch(capsys):
    """The block size and remat decision budget memory for every copy of
    the loss that runs side by side under vmap (512 multistart candidates
    at d=64 would otherwise store ~34 GB of residuals)."""
    from qoc_tpu.core.schroedinger import build_schroedinger_loss
    from qoc_tpu.models import (GrapeSchroedingerDiscreteState,
                                InterpolationPolicy)
    d, n_steps = 64, 200
    initial = np.zeros((1, d, 1)); initial[0, 0] = 1
    pstate = GrapeSchroedingerDiscreteState(
        True, 1, n_steps, 1, [TargetStateInfidelity(initial)], 2.0,
        lambda c, t: jnp.zeros((d, d)), None,
        np.zeros((n_steps, 1), complex), initial, InterpolationPolicy.LINEAR,
        1, 0, [1.0], MagnusPolicy.M2, 0, Adam(), None, False, 0, n_steps + 1)
    build_schroedinger_loss(pstate, log_path=True)
    build_schroedinger_loss(pstate, log_path=True, batch_size=512)
    single, batched = capsys.readouterr().out.strip().splitlines()
    assert "block=200, remat=False" in single
    assert "block=4, remat=True" in batched


def test_chunk_length_does_not_change_the_run():
    """The fused loop compiles one scan per chunk length; a run split into
    chunks of 2 (with a tail of 1) equals one split into chunks of 5."""
    h0 = np.asarray(SIGMA_Z) / 2
    a = get_annihilation_operator(2)
    ad = get_creation_operator(2)
    hamiltonian = lambda c, t: (h0 + c[0] * a + jnp.conjugate(c[0]) * ad)
    costs = [TargetStateInfidelity(np.array([[[0.0], [1.0]]]))]
    runs = [grape_schroedinger_discrete(
        1, 6, costs, 5.0, hamiltonian, np.array([[[1.0], [0.0]]]), 11,
        complex_controls=True, iteration_count=5, log_iteration_step=0,
        optimizer=Adam(learning_rate=0.05), fused_chunk=chunk)
        for chunk in (2, 5)]
    assert np.array_equal(runs[0].errors, runs[1].errors)
    assert np.array_equal(runs[0].best_controls, runs[1].best_controls)
