"""State-vector cost functions.

Parity with /root/reference/qoc/standard/costs/{targetstateinfidelity,
targetstateinfidelitytime,forbidstates}.py — same formulas and normalization
constants, with the per-state Python loops replaced by batched einsum
contractions.
"""

import numpy as np

import jax.numpy as jnp

from qoc_tpu.config import MATMUL_PRECISION, np_complex_dtype
from qoc_tpu.models import Cost

__all__ = ["TargetStateInfidelity", "TargetStateInfidelityTime",
           "ForbidStates"]


def _pop_phase_kwarg(kwargs):
    """Accept both the correct spelling and the reference's public (typo'd)
    keyword ``neglect_relative_pahse`` (targetstateinfidelity.py:27)."""
    if "neglect_relative_pahse" in kwargs:
        return kwargs.pop("neglect_relative_pahse")
    return kwargs.pop("neglect_relative_phase", False)


def _state_inner_products(target_states_dagger, states):
    """<target_k|psi_k> for each k: (K, 1, d) x (K, d, 1) -> (K,)."""
    return jnp.matmul(target_states_dagger, states,
                      precision=MATMUL_PRECISION)[:, 0, 0]


class TargetStateInfidelity(Cost):
    """Infidelity of the evolved states w.r.t. target states at the final
    step.

    Default: coherent sum 1 - |sum_k <t_k|psi_k>|^2 / K^2
    (reference targetstateinfidelity.py:53-56); with
    ``neglect_relative_phase=True``: incoherent 1 - sum_k |<t_k|psi_k>|^2 / K
    (reference :58-61).
    """
    name = "target_state_infidelity"
    requires_step_evaluation = False

    def __init__(self, target_states, cost_multiplier=1.0, **kwargs):
        neglect_relative_phase = _pop_phase_kwarg(kwargs)
        if kwargs:
            raise TypeError("Unexpected kwargs: {}".format(sorted(kwargs)))
        super().__init__(cost_multiplier=cost_multiplier)
        target_states = np.asarray(target_states).astype(np_complex_dtype())
        self.state_count = target_states.shape[0]
        self.target_states_dagger = np.conjugate(
            np.swapaxes(target_states, -1, -2))
        self.neglect_relative_phase = neglect_relative_phase

    def cost(self, controls, states, system_eval_step):
        inner_products = _state_inner_products(self.target_states_dagger,
                                               states)
        if not self.neglect_relative_phase:
            inner_products_sum = jnp.sum(inner_products)
            fidelity = (jnp.real(inner_products_sum
                                 * jnp.conjugate(inner_products_sum))
                        / self.state_count ** 2)
        else:
            fidelities = jnp.real(inner_products
                                  * jnp.conjugate(inner_products))
            fidelity = jnp.sum(fidelities) / self.state_count
        return (1 - fidelity) * self.cost_multiplier


class TargetStateInfidelityTime(Cost):
    """Same infidelity evaluated at every cost step, each normalized by the
    number of cost evaluations (reference targetstateinfidelitytime.py:13-73).
    """
    name = "target_state_infidelity_time"
    requires_step_evaluation = True

    def __init__(self, system_eval_count, target_states, cost_eval_step=1,
                 cost_multiplier=1.0, **kwargs):
        neglect_relative_phase = _pop_phase_kwarg(kwargs)
        if kwargs:
            raise TypeError("Unexpected kwargs: {}".format(sorted(kwargs)))
        super().__init__(cost_multiplier=cost_multiplier)
        self.cost_eval_count = (system_eval_count - 1) // cost_eval_step
        target_states = np.asarray(target_states).astype(np_complex_dtype())
        self.state_count = target_states.shape[0]
        self.target_states_dagger = np.conjugate(
            np.swapaxes(target_states, -1, -2))
        self.neglect_relative_phase = neglect_relative_phase

    def cost(self, controls, states, system_eval_step):
        inner_products = _state_inner_products(self.target_states_dagger,
                                               states)
        if not self.neglect_relative_phase:
            inner_products_sum = jnp.sum(inner_products)
            fidelity = (jnp.real(inner_products_sum
                                 * jnp.conjugate(inner_products_sum))
                        / self.state_count ** 2)
        else:
            fidelities = jnp.real(inner_products
                                  * jnp.conjugate(inner_products))
            fidelity = jnp.sum(fidelities) / self.state_count
        infidelity = 1 - fidelity
        return (infidelity / self.cost_eval_count) * self.cost_multiplier


class ForbidStates(Cost):
    """Penalize occupation of forbidden states at every cost step.

    For evolving state k with forbidden set {f_kj}: mean_j |<f_kj|psi_k>|^2,
    summed over k, normalized by cost_eval_count * state_count
    (reference forbidstates.py:12-81).

    ``forbidden_states`` may be a uniform array (K, F, d, 1) or a ragged
    list/tuple of per-state arrays (F_k, d, 1); the per-state structure is
    static so ragged sets unroll at trace time.
    """
    name = "forbid_states"
    requires_step_evaluation = True

    def __init__(self, forbidden_states, system_eval_count, cost_eval_step=1,
                 cost_multiplier=1.0):
        super().__init__(cost_multiplier=cost_multiplier)
        cdt = np_complex_dtype()
        if isinstance(forbidden_states, (list, tuple)):
            per_state = [np.asarray(f).astype(cdt) for f in forbidden_states]
        else:
            forbidden_states = np.asarray(forbidden_states).astype(cdt)
            per_state = [forbidden_states[i]
                         for i in range(forbidden_states.shape[0])]
        state_count = len(per_state)
        cost_evaluation_count = (system_eval_count - 1) // cost_eval_step
        self.cost_normalization_constant = (cost_evaluation_count
                                            * state_count)
        self.forbidden_states_count = np.array(
            [f.shape[0] for f in per_state])
        self.forbidden_states_dagger = [
            np.conjugate(np.swapaxes(f, -1, -2)) for f in per_state]

    def cost(self, controls, states, system_eval_step):
        total = 0.0
        for i, forbidden_dagger in enumerate(self.forbidden_states_dagger):
            # (F, 1, d) x (d, 1) -> (F, 1, 1) -> (F,)
            inner_products = jnp.matmul(forbidden_dagger, states[i],
                                        precision=MATMUL_PRECISION)[:, 0, 0]
            fidelities = jnp.real(inner_products
                                  * jnp.conjugate(inner_products))
            total = total + (jnp.sum(fidelities)
                             / self.forbidden_states_count[i])
        cost_normalized = total / self.cost_normalization_constant
        return cost_normalized * self.cost_multiplier
