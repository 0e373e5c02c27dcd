"""Robust multistart GRAPE: 64 pulse candidates x 8 detuned Hamiltonians.

qoc_tpu extension workload (no reference counterpart — the reference's
answer to non-convexity is rerunning by hand with new ``initial_controls``,
and it has no ensemble capability at all). Here:

- ``EnsembleLinearHamiltonian`` declares the affine detuning structure
  H_m = (1 + delta_m) H0 + c a + conj(c) a^H, and every
  (candidate x member) trajectory propagates in one vmapped batch;
- 64 white-noise pulse candidates each carry their own Adam state and
  optimize the psum-reduced ensemble-mean infidelity, sharded over a
  ("candidate", "ensemble") device mesh;
- the lowest-error candidate wins; ``result.errors`` ranks all of them.
"""

import numpy as np
import jax.numpy as jnp

from qoc_tpu import EnsembleLinearHamiltonian
from qoc_tpu.parallel import grape_schroedinger_multistart
from qoc_tpu.standard import (
    SIGMA_Z,
    TargetStateInfidelity,
    get_annihilation_operator,
    get_creation_operator,
)

H0 = np.asarray(SIGMA_Z) / 2
A = get_annihilation_operator(2)
A_DAGGER = get_creation_operator(2)

# H_m(c, t) = (1 + delta_m) H0 + c0 a + conj(c0) a^dagger.
ENSEMBLE_HAMILTONIAN = EnsembleLinearHamiltonian(H0, np.stack((A,)), [H0])
DETUNINGS = np.linspace(-0.05, 0.05, 8).reshape(-1, 1)

# Plain-callable twin for tooling that expects the (controls, time) contract.
hamiltonian = ENSEMBLE_HAMILTONIAN.member(np.zeros(1))

INITIAL_STATES = np.array([[[1.0], [0.0]]])
TARGET_STATES = np.array([[[0.0], [1.0]]])
COSTS = [TargetStateInfidelity(TARGET_STATES)]

CONTROL_COUNT = 1
CONTROL_EVAL_COUNT = SYSTEM_EVAL_COUNT = 21
EVOLUTION_TIME = 10  # ns
N_STARTS = 64
ITERATION_COUNT = 200


def main(iteration_count=ITERATION_COUNT, n_starts=N_STARTS,
         log_iteration_step=20):
    result = grape_schroedinger_multistart(
        CONTROL_COUNT, CONTROL_EVAL_COUNT, COSTS, EVOLUTION_TIME,
        ENSEMBLE_HAMILTONIAN, INITIAL_STATES, SYSTEM_EVAL_COUNT,
        n_starts=n_starts, complex_controls=True,
        hamiltonian_params=DETUNINGS, iteration_count=iteration_count,
        log_iteration_step=log_iteration_step, min_error=1e-4)
    print("winner: ensemble-mean error {} ({} candidates, spread {:.2e} - "
          "{:.2e})".format(result.best_error, n_starts,
                           result.errors.min(), result.errors.max()))
    return result


if __name__ == "__main__":
    main()
