"""Density-matrix cost functions.

Parity with /root/reference/qoc/standard/costs/{targetdensityinfidelity,
targetdensityinfidelitytime,forbiddensities}.py. The reference loops over
densities because autograd lacks a batched-trace VJP
(targetdensityinfidelity.py:54-66); JAX differentiates ``einsum('...ii->...')``
natively, so the traces are batched.

Deliberate divergence from a reference defect (SURVEY.md §2.6):
``TargetDensityInfidelityTime.requires_step_evaluation`` is True here — the
reference sets it False (targetdensityinfidelitytime.py:30), contradicting
the class docstring and the "Time" contract.
"""

import numpy as np

import jax.numpy as jnp

from qoc_tpu.config import MATMUL_PRECISION, np_complex_dtype
from qoc_tpu.models import Cost

__all__ = ["TargetDensityInfidelity", "TargetDensityInfidelityTime",
           "ForbidDensities"]


def _batched_trace(matrices):
    return jnp.einsum("...ii->...", matrices)


class TargetDensityInfidelity(Cost):
    """1 - sum_k |Tr(rho_target_k^dag rho_k)| / (K * d) at the final step
    (Frobenius inner product; reference targetdensityinfidelity.py:12-69)."""
    name = "target_density_infidelity"
    requires_step_evaluation = False

    def __init__(self, target_densities, cost_multiplier=1.0):
        super().__init__(cost_multiplier=cost_multiplier)
        target_densities = np.asarray(target_densities).astype(
            np_complex_dtype())
        self.density_count = target_densities.shape[0]
        self.hilbert_size = target_densities.shape[1]
        self.target_densities_dagger = np.conjugate(
            np.swapaxes(target_densities, -1, -2))

    def cost(self, controls, densities, system_eval_step):
        prods = jnp.matmul(self.target_densities_dagger, densities,
                           precision=MATMUL_PRECISION)
        fidelities = jnp.abs(_batched_trace(prods))
        fidelity_normalized = (jnp.sum(fidelities)
                               / (self.density_count * self.hilbert_size))
        return (1 - fidelity_normalized) * self.cost_multiplier


class TargetDensityInfidelityTime(Cost):
    """Target-density infidelity at every cost step, normalized by the cost
    evaluation count (reference targetdensityinfidelitytime.py:13-76)."""
    name = "target_density_infidelity_time"
    requires_step_evaluation = True  # divergence: reference has False (bug)

    def __init__(self, system_eval_count, target_densities, cost_eval_step=1,
                 cost_multiplier=1.0):
        super().__init__(cost_multiplier=cost_multiplier)
        self.cost_eval_count = (system_eval_count - 1) // cost_eval_step
        target_densities = np.asarray(target_densities).astype(
            np_complex_dtype())
        self.density_count = target_densities.shape[0]
        self.hilbert_size = target_densities.shape[1]
        self.target_densities_dagger = np.conjugate(
            np.swapaxes(target_densities, -1, -2))

    def cost(self, controls, densities, system_eval_step):
        prods = jnp.matmul(self.target_densities_dagger, densities,
                           precision=MATMUL_PRECISION)
        fidelities = jnp.abs(_batched_trace(prods))
        fidelity_normalized = (jnp.sum(fidelities)
                               / (self.density_count * self.hilbert_size))
        infidelity = 1 - fidelity_normalized
        return (infidelity / self.cost_eval_count) * self.cost_multiplier


class ForbidDensities(Cost):
    """Penalize overlap with forbidden densities at every cost step.

    For density k with forbidden set {F_kj}: mean_j |Tr(F_kj^dag rho_k)/d|^2,
    summed over k, normalized by cost_eval_count * density_count
    (reference forbiddensities.py:12-85). Accepts a uniform array
    (K, F, d, d) or a ragged list of per-density arrays.
    """
    name = "forbid_densities"
    requires_step_evaluation = True

    def __init__(self, forbidden_densities, system_eval_count,
                 cost_eval_step=1, cost_multiplier=1.0):
        super().__init__(cost_multiplier=cost_multiplier)
        cdt = np_complex_dtype()
        if isinstance(forbidden_densities, (list, tuple)):
            per_density = [np.asarray(f).astype(cdt)
                           for f in forbidden_densities]
            self.hilbert_size = per_density[0].shape[-1]
        else:
            forbidden_densities = np.asarray(forbidden_densities).astype(cdt)
            self.hilbert_size = forbidden_densities.shape[3]
            per_density = [forbidden_densities[i]
                           for i in range(forbidden_densities.shape[0])]
        density_count = len(per_density)
        cost_evaluation_count = (system_eval_count - 1) // cost_eval_step
        self.cost_normalization_constant = (cost_evaluation_count
                                            * density_count)
        self.forbidden_densities_count = np.array(
            [f.shape[0] for f in per_density])
        self.forbidden_densities_dagger = [
            np.conjugate(np.swapaxes(f, -1, -2)) for f in per_density]

    def cost(self, controls, densities, system_eval_step):
        total = 0.0
        for i, forbidden_dagger in enumerate(self.forbidden_densities_dagger):
            # (F, d, d) x (d, d) -> (F, d, d), trace -> (F,)
            inner_products = (_batched_trace(
                jnp.matmul(forbidden_dagger, densities[i],
                           precision=MATMUL_PRECISION))
                / self.hilbert_size)
            fidelities = jnp.real(inner_products
                                  * jnp.conjugate(inner_products))
            total = total + (jnp.sum(fidelities)
                             / self.forbidden_densities_count[i])
        cost_normalized = total / self.cost_normalization_constant
        return cost_normalized * self.cost_multiplier
