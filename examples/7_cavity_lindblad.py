"""Open-system photon injection into a lossy 20-level cavity (d = 20,
superoperator dimension 400).

Real open-system scale: the Lindblad master equation is propagated through
(400, 400) superoperators — far beyond the d=2 decoherence example — with
``LindbladMethod.MAGNUS_EXPM``: each time block's superoperator
exponentials are computed batched and multiplied in log depth.

Physics: drive a cavity with single-photon loss (T1 = kappa^-1) from
vacuum toward the one-photon Fock state; the optimizer must fight the
decay channel. (The reference's only open-system example is the d=2
transmon, /root/reference/examples/1_transmon_pi_dechoerence.py —
this extends the same contract to a cavity-scale problem.)

``main(cavity_levels=...)`` scales the cavity: 20 is the showcase size
(GPU); the CI smoke tier runs a smaller cavity so the CPU suite stays
fast.
"""

import numpy as np

from qoc_tpu import LinearHamiltonian, grape_lindblad_discrete
from qoc_tpu.models import ConstantLindblad, LindbladMethod
from qoc_tpu.optim import Adam
from qoc_tpu.standard import (
    TargetDensityInfidelity,
    get_annihilation_operator,
)

CAVITY_LEVELS = 20
KERR = -2 * np.pi * 1e-3          # self-Kerr, GHz
KAPPA = 1.0 / 2000.0              # photon loss rate, 1/ns (T1 = 2 us)

EVOLUTION_TIME = 50.0             # ns
CONTROL_EVAL_COUNT = 26
SYSTEM_EVAL_COUNT = 51
ITERATION_COUNT = 200


def build_problem(cavity_levels=CAVITY_LEVELS):
    """(hamiltonian, lindblad_data, initial, target) for a lossy cavity of
    the given size."""
    d = cavity_levels
    a = get_annihilation_operator(d)
    n_c = a.conj().T @ a
    h0 = ((KERR / 2) * n_c @ (n_c - np.eye(d))).astype(np.complex64)
    hamiltonian = LinearHamiltonian(h0, np.stack((a.astype(np.complex64),)))
    lindblad_data = ConstantLindblad(np.array([KAPPA]),
                                     np.stack((a.astype(np.complex64),)))

    def fock(n):
        rho = np.zeros((1, d, d), dtype=complex)
        rho[0, n, n] = 1
        return rho

    return hamiltonian, lindblad_data, fock(0), fock(1)


# Module-level showcase problem (mirrors the other examples' layout).
hamiltonian, LINDBLAD_DATA, INITIAL_DENSITIES, TARGET_DENSITIES = \
    build_problem()
COSTS = [TargetDensityInfidelity(TARGET_DENSITIES)]


def main(iteration_count=ITERATION_COUNT, log_iteration_step=20,
         cavity_levels=CAVITY_LEVELS):
    ham, lindblad_data, initial, target = build_problem(cavity_levels)
    result = grape_lindblad_discrete(
        1, CONTROL_EVAL_COUNT, [TargetDensityInfidelity(target)],
        EVOLUTION_TIME, initial, SYSTEM_EVAL_COUNT, complex_controls=True,
        hamiltonian=ham, iteration_count=iteration_count,
        lindblad_data=lindblad_data,
        log_iteration_step=log_iteration_step,
        method=LindbladMethod.MAGNUS_EXPM, optimizer=Adam(learning_rate=0.01))
    print("best error: {} at iteration {}".format(result.best_error,
                                                  result.best_iteration))
    return result


if __name__ == "__main__":
    main()
