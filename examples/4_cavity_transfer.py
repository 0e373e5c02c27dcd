"""Cavity-qubit state transfer: transmon + 20-level resonator (d = 40),
the large-dim expm stress test.

BASELINE.json config #5: "cavity-qubit (transmon + 20-level resonator)
state transfer, large-dim expm stress test". Injects a photon into the
cavity through the dispersive interaction, |g,0> -> |g,1>.
"""

import numpy as np

from qoc_tpu import grape_schroedinger_discrete
from qoc_tpu.standard import (
    TargetStateInfidelity,
    get_annihilation_operator,
    get_creation_operator,
)

TRANSMON_LEVELS = 2
CAVITY_LEVELS = 20
D = TRANSMON_LEVELS * CAVITY_LEVELS

B = np.kron(get_annihilation_operator(TRANSMON_LEVELS),
            np.eye(CAVITY_LEVELS))
A = np.kron(np.eye(TRANSMON_LEVELS),
            get_annihilation_operator(CAVITY_LEVELS))
N_T = B.conj().T @ B
N_C = A.conj().T @ A

CHI = -2 * np.pi * 2.194e-3  # dispersive shift, GHz
H0 = (CHI * N_C @ N_T).astype(np.complex64)
A_C = A.astype(np.complex64)
B_C = B.astype(np.complex64)


# Declaring the linear control structure H = H0 + c0 A + c1 B + h.c.
# (rather than an opaque callable) keeps the structure as data (A and B are
# real, so A^T == A^H and the LinearHamiltonian contract matches the formula
# above exactly).
from qoc_tpu import LinearHamiltonian  # noqa: E402  (after constants)

hamiltonian = LinearHamiltonian(H0, np.stack((A_C, B_C)))


def _state(transmon, cavity):
    v = np.zeros((D, 1))
    v[transmon * CAVITY_LEVELS + cavity] = 1
    return v


INITIAL_STATES = np.stack([_state(0, 0)])
TARGET_STATES = np.stack([_state(0, 1)])
COSTS = [TargetStateInfidelity(TARGET_STATES)]

EVOLUTION_TIME = 250.0  # ns
CONTROL_EVAL_COUNT = SYSTEM_EVAL_COUNT = 501
ITERATION_COUNT = 200


def main(iteration_count=ITERATION_COUNT, log_iteration_step=20):
    result = grape_schroedinger_discrete(
        2, CONTROL_EVAL_COUNT, COSTS, EVOLUTION_TIME, hamiltonian,
        INITIAL_STATES, SYSTEM_EVAL_COUNT, complex_controls=True,
        iteration_count=iteration_count,
        log_iteration_step=log_iteration_step,
        max_control_norms=np.array([2 * np.pi * 0.03, 2 * np.pi * 0.03]))
    print("best error: {} at iteration {}".format(result.best_error,
                                                  result.best_iteration))
    return result


if __name__ == "__main__":
    main()
