"""Open-system robust GRAPE: a transmon π pulse under T1 decay, optimized
against a detuning ensemble — then the same problem through the
Lindblad multistart driver.

The open-system twin of example 3: each ensemble member integrates the full
master equation (reference lindbladdiscrete.py dynamics) on its mesh shard;
the psum-reduced ensemble-mean infidelity drives one Adam update on the
shared pulse. With ``method=LindbladMethod.MAGNUS_EXPM`` all members'
vectorized (d², d²) superoperator chains propagate in one vmapped batch.
"""

import numpy as np

from qoc_tpu import ConstantLindblad, EnsembleLinearHamiltonian
from qoc_tpu.models import LindbladMethod
from qoc_tpu.optim import Adam
from qoc_tpu.parallel import (grape_lindblad_ensemble,
                              grape_lindblad_multistart, make_mesh)
from qoc_tpu.standard import (
    SIGMA_Z,
    TargetDensityInfidelity,
    get_annihilation_operator,
)

H0 = np.asarray(SIGMA_Z) / 2
A = get_annihilation_operator(2)

# H(δ, c) = (1+δ)·σz/2 + c·a + conj(c)·a†  — affine in [1, δ, Re c, Im c].
HAMILTONIAN = EnsembleLinearHamiltonian(H0, np.stack((A,)), [H0])
hamiltonian = HAMILTONIAN  # callable (params_row, controls, time) -> (d, d)
DETUNINGS = np.linspace(-0.02, 0.02, 8).reshape(-1, 1)

T1 = 1000.0
LINDBLAD_DATA = ConstantLindblad(np.array([1.0 / T1]), np.stack((A,)))

INITIAL_DENSITIES = np.array([[[1.0, 0.0], [0.0, 0.0]]], dtype=complex)
TARGET_DENSITIES = np.array([[[0.0, 0.0], [0.0, 1.0]]], dtype=complex)
COSTS = [TargetDensityInfidelity(TARGET_DENSITIES)]

EVOLUTION_TIME = 10.0
CONTROL_EVAL_COUNT = 11
SYSTEM_EVAL_COUNT = 21


def main(iteration_count=300, log_iteration_step=50, n_starts=8):
    mesh = make_mesh()  # all local devices on the "ensemble" axis
    result = grape_lindblad_ensemble(
        1, CONTROL_EVAL_COUNT, COSTS, EVOLUTION_TIME, HAMILTONIAN,
        DETUNINGS, INITIAL_DENSITIES, SYSTEM_EVAL_COUNT,
        complex_controls=True, iteration_count=iteration_count,
        lindblad_data=LINDBLAD_DATA,
        log_iteration_step=log_iteration_step,
        method=LindbladMethod.MAGNUS_EXPM, mesh=mesh,
        optimizer=Adam(learning_rate=0.02))
    print("ensemble-mean best error: {} at iteration {}"
          "".format(result.best_error, result.best_iteration))
    print("per-member final densities shape:",
          result.best_final_densities.shape)

    # Multistart over the same robust problem: n_starts independent pulse
    # candidates, each optimizing the ensemble-mean error, on a
    # candidate x ensemble mesh.
    ms = grape_lindblad_multistart(
        1, CONTROL_EVAL_COUNT, COSTS, EVOLUTION_TIME, INITIAL_DENSITIES,
        SYSTEM_EVAL_COUNT, n_starts=n_starts, complex_controls=True,
        hamiltonian=HAMILTONIAN, hamiltonian_params=DETUNINGS,
        iteration_count=iteration_count, lindblad_data=LINDBLAD_DATA,
        log_iteration_step=log_iteration_step,
        method=LindbladMethod.MAGNUS_EXPM,
        optimizer=Adam(learning_rate=0.02))
    print("multistart winner: {} ({} candidates, spread {:.2e} - {:.2e})"
          "".format(ms.best_error, n_starts, ms.errors.min(),
                    ms.errors.max()))
    return ms


if __name__ == "__main__":
    main()
