"""Driver-level propagation against float64 numpy/scipy oracles.

Each case builds a loss through the public loss builders (Schrödinger or
Lindblad, any Magnus order, step costs, recorded trajectories) and checks
its value and its gradient against the independent float64 reference of
tests/oracles.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from oracles import (EVOLUTION_TIME, basis_states, check_value_and_grad,
                     density_fidelity, lindblad_traj, linear_h,
                     random_problem, schroedinger_traj, state_fidelity)
from qoc_tpu.core.common import slap_controls_jax
from qoc_tpu.models import (ConstantLindblad, GrapeLindbladDiscreteState,
                            GrapeSchroedingerDiscreteState,
                            InterpolationPolicy, LindbladMethod,
                            LinearHamiltonian, MagnusPolicy)
from qoc_tpu.optim import Adam
from qoc_tpu.standard import (ForbidDensities, ForbidStates,
                              TargetDensityInfidelity,
                              TargetDensityInfidelityTime,
                              TargetStateInfidelity,
                              TargetStateInfidelityTime)

def _schro_pstate(ham, costs, n_c, n_steps, initial,
                  policy=MagnusPolicy.M2, cost_eval_step=1):
    return GrapeSchroedingerDiscreteState(
        True, n_c, n_steps, cost_eval_step, costs, EVOLUTION_TIME, ham,
        None, np.zeros((n_steps, n_c), dtype=complex), initial,
        InterpolationPolicy.LINEAR, 1, 0, [10.0] * n_c, policy, 0, Adam(),
        None, False, 0, n_steps + 1)


# -- Schrödinger -------------------------------------------------------------

def test_schroedinger_loss_and_grad_match_scipy():
    from qoc_tpu.core.schroedinger import build_schroedinger_loss
    rng = np.random.default_rng(11)
    d, n_c, n_steps = 4, 2, 25
    h0, ops = random_problem(rng, d, n_c)
    initial, target = basis_states(d, [0]), basis_states(d, [d - 1])
    pstate = _schro_pstate(LinearHamiltonian(h0, ops),
                           [TargetStateInfidelity(target)], n_c, n_steps,
                           initial)

    def oracle(flat):
        states = schroedinger_traj(linear_h(h0, ops), flat,
                                    pstate.controls_shape, n_steps,
                                    MagnusPolicy.M2, initial)[-1]
        return 1 - state_fidelity(target, states)

    check_value_and_grad(build_schroedinger_loss(pstate, time_block_size=10), oracle,
           pstate.controls_shape, rng)


def test_step_costs_match_scipy():
    """ForbidStates + TargetStateInfidelityTime accumulate at every step."""
    from qoc_tpu.core.schroedinger import build_schroedinger_loss
    rng = np.random.default_rng(41)
    d, n_c, n_steps = 4, 2, 25
    h0, ops = random_problem(rng, d, n_c)
    initial, target = basis_states(d, [0]), basis_states(d, [d - 1])
    forb = basis_states(d, [1])[:, None]
    pstate = _schro_pstate(
        LinearHamiltonian(h0, ops),
        [TargetStateInfidelity(target),
         TargetStateInfidelityTime(n_steps + 1, target),
         ForbidStates(forb, n_steps + 1)], n_c, n_steps, initial)

    def oracle(flat):
        traj = schroedinger_traj(linear_h(h0, ops), flat,
                                  pstate.controls_shape, n_steps,
                                  MagnusPolicy.M2, initial)
        step = sum((1 - state_fidelity(target, s)) / n_steps
                   + abs(np.vdot(forb[0, 0], s[0])) ** 2 / n_steps
                   for s in traj)
        return 1 - state_fidelity(target, traj[-1]) + step

    check_value_and_grad(build_schroedinger_loss(pstate, time_block_size=16), oracle,
           pstate.controls_shape, rng)


def test_step_cost_thinning_matches_scipy():
    """cost_eval_step > 1: step costs only on every third step (reference
    schroedingerdiscrete.py:61-63)."""
    from qoc_tpu.core.schroedinger import build_schroedinger_loss
    rng = np.random.default_rng(49)
    d, n_c, n_steps = 4, 1, 25
    h0, ops = random_problem(rng, d, n_c)
    initial, target = basis_states(d, [0]), basis_states(d, [d - 1])
    forb = basis_states(d, [1])[:, None]
    pstate = _schro_pstate(
        LinearHamiltonian(h0, ops),
        [TargetStateInfidelity(target),
         ForbidStates(forb, n_steps + 1, cost_eval_step=3)], n_c, n_steps,
        initial, cost_eval_step=3)

    def oracle(flat):
        traj = schroedinger_traj(linear_h(h0, ops), flat,
                                  pstate.controls_shape, n_steps,
                                  MagnusPolicy.M2, initial)
        step = sum(abs(np.vdot(forb[0, 0], traj[k - 1][0])) ** 2
                   for k in range(3, n_steps + 1, 3)) / (n_steps // 3)
        return 1 - state_fidelity(target, traj[-1]) + step

    check_value_and_grad(build_schroedinger_loss(pstate, time_block_size=16), oracle,
           pstate.controls_shape, rng)


def test_collect_intermediates_match_scipy():
    """The recorded (system_eval_count, K, d, 1) trajectory equals the
    reference states at every step, the initial states first."""
    from qoc_tpu.core.schroedinger import build_schroedinger_loss
    rng = np.random.default_rng(43)
    d, n_c, n_steps = 4, 1, 20
    h0, ops = random_problem(rng, d, n_c)
    initial, target = basis_states(d, [0, 1]), basis_states(d, [d - 1, 0])
    pstate = _schro_pstate(LinearHamiltonian(h0, ops),
                           [TargetStateInfidelity(target)], n_c, n_steps,
                           initial)
    loss = build_schroedinger_loss(pstate, collect_intermediates=True,
                                   remat=False, time_block_size=16)
    flat = 0.3 * rng.normal(size=(2 * n_steps * n_c,))
    _, _, inter = loss(slap_controls_jax(True, jnp.asarray(flat),
                                         pstate.controls_shape))
    want = [initial] + schroedinger_traj(
        linear_h(h0, ops), flat, pstate.controls_shape, n_steps,
        MagnusPolicy.M2, initial)
    assert inter.shape == (n_steps + 1, 2, d, 1)
    assert np.abs(np.asarray(inter) - np.stack(want)).max() < 1e-10


@pytest.mark.parametrize("policy_name", ["M4", "M6"])
def test_magnus_high_order_matches_scipy(policy_name):
    from qoc_tpu.core.schroedinger import build_schroedinger_loss
    policy = getattr(MagnusPolicy, policy_name)
    rng = np.random.default_rng(61)
    d, n_c, n_steps = 4, 2, 25
    h0, ops = random_problem(rng, d, n_c)
    initial, target = basis_states(d, [0]), basis_states(d, [d - 1])
    pstate = _schro_pstate(LinearHamiltonian(h0, ops),
                           [TargetStateInfidelity(target)], n_c, n_steps,
                           initial, policy=policy)

    def oracle(flat):
        states = schroedinger_traj(linear_h(h0, ops), flat,
                                    pstate.controls_shape, n_steps, policy,
                                    initial)[-1]
        return 1 - state_fidelity(target, states)

    check_value_and_grad(build_schroedinger_loss(pstate), oracle, pstate.controls_shape,
           rng)


def test_arbitrary_hamiltonian_matches_scipy():
    """A plain, time-dependent callable Hamiltonian (no declared linear
    structure) through the same propagation."""
    from qoc_tpu.core.schroedinger import build_schroedinger_loss
    rng = np.random.default_rng(63)
    d, n_c, n_steps = 4, 1, 25
    h0, _ = random_problem(rng, d, n_c)
    v, _ = random_problem(rng, d, n_c)

    def ham(c, t):
        return (jnp.asarray(h0) * jnp.cos(0.3 * t)
                + jnp.real(c[0]) * jnp.asarray(v))

    initial, target = basis_states(d, [0]), basis_states(d, [d - 1])
    pstate = _schro_pstate(ham, [TargetStateInfidelity(target)], n_c,
                           n_steps, initial)

    def oracle(flat):
        states = schroedinger_traj(
            lambda c, t: h0 * np.cos(0.3 * t) + np.real(c[0]) * v, flat,
            pstate.controls_shape, n_steps, MagnusPolicy.M2, initial)[-1]
        return 1 - state_fidelity(target, states)

    check_value_and_grad(build_schroedinger_loss(pstate), oracle, pstate.controls_shape,
           rng)


# -- Lindblad ----------------------------------------------------------------

def _lindblad_pstate(ham, lind, costs, n_c, n_steps, rho0, policy):
    p = GrapeLindbladDiscreteState(
        True, n_c, n_steps, 1, costs, EVOLUTION_TIME, ham, None,
        np.zeros((n_steps, n_c), dtype=complex), rho0,
        InterpolationPolicy.LINEAR, 1, lind, 0, [10.0] * n_c, 0, Adam(),
        None, False, 0, n_steps + 1)
    p.method_ = LindbladMethod.MAGNUS_EXPM
    p.magnus_policy_ = policy
    return p


def _lindblad_case(seed, n_c, n_ops, policy, step_costs):
    from qoc_tpu.core.lindblad import build_lindblad_loss
    rng = np.random.default_rng(seed)
    d, n_steps = 3, 20
    h0, ops = random_problem(rng, d, n_c)
    ops = 0.8 * ops
    gammas = np.array([0.05, 0.02][:n_ops])
    lops = 0.3 * (rng.normal(size=(n_ops, d, d))
                  + 1j * rng.normal(size=(n_ops, d, d)))
    rho0 = np.zeros((1, d, d), dtype=complex); rho0[0, 0, 0] = 1
    target = np.zeros((1, d, d), dtype=complex); target[0, -1, -1] = 1
    forb = np.zeros((1, 1, d, d), dtype=complex); forb[0, 0, 1, 1] = 1
    costs = [TargetDensityInfidelity(target)]
    if step_costs:
        costs += [TargetDensityInfidelityTime(n_steps + 1, target),
                  ForbidDensities(forb, n_steps + 1)]
    pstate = _lindblad_pstate(LinearHamiltonian(h0, ops),
                              ConstantLindblad(gammas, lops), costs, n_c,
                              n_steps, rho0, policy)

    def oracle(flat):
        traj = lindblad_traj(linear_h(h0, ops), gammas, lops, flat,
                              pstate.controls_shape, n_steps, policy, rho0)
        total = 1 - density_fidelity(target, traj[-1])
        if step_costs:
            for rho in traj:
                total += (1 - density_fidelity(target, rho)) / n_steps
                total += abs(np.trace(forb[0, 0].conj().T @ rho[0])
                             / d) ** 2 / n_steps
        return total

    check_value_and_grad(build_lindblad_loss(pstate), oracle, pstate.controls_shape, rng)


def test_lindblad_magnus_matches_scipy():
    _lindblad_case(17, 2, 2, MagnusPolicy.M2, step_costs=False)


def test_lindblad_m4_matches_scipy():
    _lindblad_case(67, 1, 1, MagnusPolicy.M4, step_costs=False)


def test_lindblad_step_costs_match_scipy():
    _lindblad_case(47, 1, 1, MagnusPolicy.M2, step_costs=True)
