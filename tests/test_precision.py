"""Precision audit: every matrix product on the float32 path asks for HIGHEST.

A GPU may run a float32 ``dot_general`` of DEFAULT precision as TF32 (about
three decimal digits), which GRAPE fidelities cannot afford. Each case lowers
one path's float32 loss and gradient, as the accelerator runs it (Taylor
expm), and checks every ``dot_general`` in the StableHLO.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qoc_tpu.core.common import slap_controls_jax
from qoc_tpu.models import (ConstantLindblad, EnsembleLinearHamiltonian,
                            GrapeLindbladDiscreteState,
                            GrapeSchroedingerDiscreteState,
                            InterpolationPolicy, LindbladMethod,
                            LinearHamiltonian, MagnusPolicy)
from qoc_tpu.ops.expm import set_expm_forward
from qoc_tpu.optim import Adam
from qoc_tpu.standard import (ForbidDensities, ForbidStates,
                              TargetDensityInfidelity,
                              TargetDensityInfidelityTime,
                              TargetStateInfidelity,
                              TargetStateInfidelityTime)

D, N_C, STEPS = 4, 2, 9


def _hamiltonian(rng):
    h0 = rng.normal(size=(D, D)) + 1j * rng.normal(size=(D, D))
    ops = rng.normal(size=(N_C, D, D)) + 1j * rng.normal(size=(N_C, D, D))
    return (h0 + h0.conj().T) / 2, 0.3 * ops


def _schroedinger_loss(policy=MagnusPolicy.M2, step_costs=False):
    from qoc_tpu.core.schroedinger import build_schroedinger_loss
    h0, ops = _hamiltonian(np.random.default_rng(0))
    initial = np.eye(D)[:2, :, None]
    costs = [TargetStateInfidelity(initial[::-1])]
    if step_costs:
        costs += [TargetStateInfidelityTime(STEPS + 1, initial[::-1]),
                  ForbidStates(initial[:, None], STEPS + 1)]
    pstate = GrapeSchroedingerDiscreteState(
        True, N_C, STEPS, 1, costs, 1.0, LinearHamiltonian(h0, ops), None,
        np.zeros((STEPS, N_C), complex), initial, InterpolationPolicy.LINEAR,
        1, 0, np.ones(N_C), policy, 0, Adam(), None, False, 0, STEPS + 1)
    return build_schroedinger_loss(pstate), pstate.controls_shape


def _lindblad_loss(method):
    from qoc_tpu.core.lindblad import build_lindblad_loss
    h0, ops = _hamiltonian(np.random.default_rng(1))
    rho0 = np.zeros((1, D, D), complex); rho0[0, 0, 0] = 1
    target = np.zeros_like(rho0); target[0, -1, -1] = 1
    costs = [TargetDensityInfidelity(target),
             TargetDensityInfidelityTime(STEPS + 1, target),
             ForbidDensities(rho0[:, None], STEPS + 1)]
    pstate = GrapeLindbladDiscreteState(
        True, N_C, STEPS, 1, costs, 1.0, LinearHamiltonian(h0, ops), None,
        np.zeros((STEPS, N_C), complex), rho0, InterpolationPolicy.LINEAR, 1,
        ConstantLindblad(np.array([0.1]), ops[:1]), 0, np.ones(N_C), 0,
        Adam(), None, False, 0, STEPS + 1)
    pstate.method_ = method
    pstate.atol, pstate.rtol, pstate.rkdp5_max_steps = 1e-6, 0.0, 8
    pstate.magnus_policy_ = MagnusPolicy.M2
    return build_lindblad_loss(pstate), pstate.controls_shape


def _ensemble_loss():
    from qoc_tpu.parallel import build_ensemble_loss, make_mesh
    h0, ops = _hamiltonian(np.random.default_rng(2))
    initial = np.eye(D)[:1, :, None]
    pstate = GrapeSchroedingerDiscreteState(
        True, N_C, STEPS, 1, [TargetStateInfidelity(initial[:, ::-1])], 1.0,
        None, None, np.zeros((STEPS, N_C), complex), initial,
        InterpolationPolicy.LINEAR, 1, 0, np.ones(N_C), MagnusPolicy.M2, 0,
        Adam(), None, False, 0, STEPS + 1)
    ham = EnsembleLinearHamiltonian(h0, ops, h0[None])
    loss = build_ensemble_loss(pstate, ham, np.linspace(-0.1, 0.1, 4)[:, None],
                               make_mesh(4))
    return loss, pstate.controls_shape


def _multistart_loss():
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from qoc_tpu.parallel import make_mesh
    from qoc_tpu.parallel._msrunner import CANDIDATE_AXIS
    from qoc_tpu.parallel.multistart import _make_shard_loss
    h0, ops = _hamiltonian(np.random.default_rng(3))
    initial = np.eye(D)[:1, :, None]
    pstate = GrapeSchroedingerDiscreteState(
        True, N_C, STEPS, 1, [TargetStateInfidelity(initial[:, ::-1])], 1.0,
        LinearHamiltonian(h0, ops), None, np.zeros((STEPS, N_C), complex),
        initial, InterpolationPolicy.LINEAR, 1, 0, np.ones(N_C),
        MagnusPolicy.M2, 0, Adam(), None, False, 0, STEPS + 1)
    shape = pstate.controls_shape
    shard_loss = _make_shard_loss(pstate, pstate.hamiltonian, None, False,
                                  True, shape, 2, 1, (CANDIDATE_AXIS,), True)
    sharded = shard_map(lambda f: jax.lax.psum(shard_loss(f)[0],
                                               CANDIDATE_AXIS),
                        mesh=make_mesh(2, axis_name=CANDIDATE_AXIS),
                        in_specs=P(CANDIDATE_AXIS), out_specs=P())
    flat_size = 2 * shape[0] * shape[1]
    return (lambda f: (sharded(f.reshape(4, flat_size)), None)), None


PATHS = {
    "schroedinger_m2": lambda: _schroedinger_loss(),
    "schroedinger_m4": lambda: _schroedinger_loss(MagnusPolicy.M4),
    "schroedinger_m6": lambda: _schroedinger_loss(MagnusPolicy.M6),
    "step_costs": lambda: _schroedinger_loss(step_costs=True),
    "lindblad_magnus": lambda: _lindblad_loss(LindbladMethod.MAGNUS_EXPM),
    "lindblad_rkdp5": lambda: _lindblad_loss(LindbladMethod.RKDP5),
    "ensemble": _ensemble_loss,
    "multistart": _multistart_loss,
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_float32_products_request_highest(path):
    set_expm_forward("taylor")
    try:
        with jax.enable_x64(False):
            loss, shape = PATHS[path]()
            if shape is None:
                flat = jnp.zeros((4 * 2 * STEPS * N_C,), jnp.float32)

                def scalar(f):
                    return loss(f)[0]
            else:
                flat = jnp.zeros((2 * shape[0] * shape[1],), jnp.float32)

                def scalar(f):
                    return loss(slap_controls_jax(True, f, shape))[0]

            text = jax.jit(jax.value_and_grad(scalar)).lower(flat).as_text()
    finally:
        set_expm_forward("auto")
    dots = [line.strip() for line in text.splitlines()
            if "dot_general" in line]
    assert dots, "no matrix products found in the {} loss".format(path)
    assert "f32" in text or "complex<f32>" in text
    loose = [line for line in dots if "HIGHEST" not in line]
    assert not loose, "{} product(s) without HIGHEST:\n{}".format(
        len(loose), "\n".join(loose[:5]))
