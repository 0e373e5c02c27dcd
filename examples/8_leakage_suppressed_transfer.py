"""Leakage-suppressed qutrit pi pulse: a ForbidStates step cost.

The classic step-cost GRAPE use case (reference
qoc/standard/costs/forbidstates.py): drive a weakly-anharmonic
three-level transmon |0> -> |1> while PENALIZING population of the leakage
level |2> at every time step. Step costs need every step's states, which
the propagation takes from its prefix scan instead of a tree product.

Run with a larger ``anharmonicity`` to see the leakage penalty matter
less; at the default weak anharmonicity the optimizer must actively
shape the pulse spectrum away from the 1->2 transition.
"""

import numpy as np

from qoc_tpu import LinearHamiltonian, grape_schroedinger_discrete
from qoc_tpu.standard import (
    ForbidStates,
    TargetStateInfidelity,
    get_annihilation_operator,
)

D = 3
ANHARMONICITY = -2 * np.pi * 0.1  # GHz; weak, so |2> is easy to leak into

A = get_annihilation_operator(D).astype(np.complex64)
N = (A.conj().T @ A).astype(np.complex64)
H0 = (ANHARMONICITY / 2 * (N @ N - N)).astype(np.complex64)

# H = H0 + c a + conj(c) a^H: one complex drive on the ladder operator.
hamiltonian = LinearHamiltonian(H0, np.stack((A,)))


def _state(level):
    v = np.zeros((D, 1))
    v[level] = 1
    return v


INITIAL_STATES = np.stack([_state(0)])
TARGET_STATES = np.stack([_state(1)])
# Forbidden set for evolving state 0: the leakage level |2>.
FORBIDDEN_STATES = np.stack([np.stack([_state(2)])])

EVOLUTION_TIME = 40.0  # ns
CONTROL_EVAL_COUNT = SYSTEM_EVAL_COUNT = 81
ITERATION_COUNT = 300
LEAKAGE_WEIGHT = 2.0


def main(iteration_count=ITERATION_COUNT, log_iteration_step=20,
         system_eval_count=SYSTEM_EVAL_COUNT):
    costs = [
        TargetStateInfidelity(TARGET_STATES),
        ForbidStates(FORBIDDEN_STATES, system_eval_count,
                     cost_multiplier=LEAKAGE_WEIGHT),
    ]
    result = grape_schroedinger_discrete(
        1, CONTROL_EVAL_COUNT, costs, EVOLUTION_TIME, hamiltonian,
        INITIAL_STATES, system_eval_count, complex_controls=True,
        iteration_count=iteration_count,
        log_iteration_step=log_iteration_step,
        max_control_norms=np.array([2 * np.pi * 0.05]))
    print("best error (infidelity + leakage penalty): {} at iteration {}"
          "".format(result.best_error, result.best_iteration))
    return result


if __name__ == "__main__":
    main()
