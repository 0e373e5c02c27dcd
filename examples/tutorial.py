"""Cavity-transmon photon transfer: the qoc_tpu walkthrough.

qoc_tpu port of the reference tutorial workload
(/root/reference/examples/tutorial.py: 2-level cavity x 2-level transmon,
two complex charge drives, T=15 ns, 100 control/system steps, L-BFGS-B).
The task: swap a photon from the transmon into the cavity,
|0, e> -> |1, g>.

Everything in ``qoc_tpu.standard`` operates on numpy/jax.numpy arrays; write
your Hamiltonian with numpy constants and jax.numpy operations on the traced
``controls``/``time`` arguments.
"""

import numpy as np
import jax.numpy as jnp

from qoc_tpu import grape_schroedinger_discrete
from qoc_tpu.standard import (
    LBFGSB,
    TargetStateInfidelity,
    generate_save_file_path,
    get_annihilation_operator,
    get_creation_operator,
    plot_controls,
)

# Experimental constants (arXiv:1904.06560 pp. 7), in GHz / ns.
PI_2 = 2 * np.pi
W_T = PI_2 * 5.6640
W_C = PI_2 * 4.4526
CHI = PI_2 * -2.194
ALPHA_BY_2 = PI_2 * -2.36e-1
KAPPA_BY_2 = PI_2 * -3.7e-6
CHIP_BY_2 = PI_2 * -1.9e-6

# The system: cavity (A) tensor transmon (B).
CAVITY_STATE_COUNT = 2
TRANSMON_STATE_COUNT = 2
A = get_annihilation_operator(CAVITY_STATE_COUNT)
A_DAGGER = get_creation_operator(CAVITY_STATE_COUNT)
A_ID = np.eye(CAVITY_STATE_COUNT)
B = get_annihilation_operator(TRANSMON_STATE_COUNT)
B_DAGGER = get_creation_operator(TRANSMON_STATE_COUNT)
B_ID = np.eye(TRANSMON_STATE_COUNT)

CAVITY_ZERO = np.array([[1.0], [0.0]])
CAVITY_ONE = np.array([[0.0], [1.0]])
TRANSMON_G = np.array([[1.0], [0.0]])
TRANSMON_E = np.array([[0.0], [1.0]])

import functools
_k = np.kron
_m = lambda *ms: functools.reduce(np.matmul, ms)

SYSTEM_HAMILTONIAN = (
    W_C * _k(_m(A_DAGGER, A), B_ID)
    + KAPPA_BY_2 * _k(_m(A_DAGGER, A_DAGGER, A, A), B_ID)
    + W_T * _k(A_ID, _m(B_DAGGER, B))
    + ALPHA_BY_2 * _k(A_ID, _m(B_DAGGER, B_DAGGER, B, B))
    + CHI * _k(_m(A_DAGGER, A), _m(B_DAGGER, B))
    + CHIP_BY_2 * _k(_m(A_DAGGER, A_DAGGER, A, A), _m(B_DAGGER, B)))
CONTROL_0 = _k(A, B_ID)
CONTROL_0_DAGGER = _k(A_DAGGER, B_ID)
CONTROL_1 = _k(A_ID, B)
CONTROL_1_DAGGER = _k(A_ID, B_DAGGER)


def hamiltonian(controls, time):
    return (SYSTEM_HAMILTONIAN
            + controls[0] * CONTROL_0
            + jnp.conjugate(controls[0]) * CONTROL_0_DAGGER
            + controls[1] * CONTROL_1
            + jnp.conjugate(controls[1]) * CONTROL_1_DAGGER)


# The problem: |cavity 0, transmon e> -> |cavity 1, transmon g>.
INITIAL_STATE = np.kron(CAVITY_ZERO, TRANSMON_E)
TARGET_STATE = np.kron(CAVITY_ONE, TRANSMON_G)
INITIAL_STATES = np.stack((INITIAL_STATE,))
TARGET_STATES = np.stack((TARGET_STATE,))
COSTS = [TargetStateInfidelity(TARGET_STATES)]

EVOLUTION_TIME = 15  # ns
CONTROL_COUNT = 2
COMPLEX_CONTROLS = True
CONTROL_EVAL_COUNT = SYSTEM_EVAL_COUNT = 100
ITERATION_COUNT = 30

SAVE_PATH = "./out"
SAVE_FILE_NAME = "tutorial"


def main(iteration_count=ITERATION_COUNT, save_path=SAVE_PATH,
         log_iteration_step=1):
    save_file_path = generate_save_file_path(SAVE_FILE_NAME, save_path)
    result = grape_schroedinger_discrete(
        CONTROL_COUNT, CONTROL_EVAL_COUNT, COSTS, EVOLUTION_TIME,
        hamiltonian, INITIAL_STATES, SYSTEM_EVAL_COUNT,
        complex_controls=COMPLEX_CONTROLS, iteration_count=iteration_count,
        # LBFGSB() = the reference's scipy host path, kept for parity.
        # qoc_tpu.optim.LBFGS() is the device-resident quasi-Newton twin:
        # it stays inside the fused on-device loop (and supports min_error,
        # resume, ensembles, multistart) — prefer it on an accelerator.
        log_iteration_step=log_iteration_step, optimizer=LBFGSB(),
        save_file_path=save_file_path, save_iteration_step=1)
    print("best error: {} at iteration {}".format(result.best_error,
                                                  result.best_iteration))
    # Render the optimized pulses (works live from a second process too).
    plot_controls(save_file_path,
                  save_file_path=save_file_path.replace(".h5",
                                                        "_controls.png"))
    return result


if __name__ == "__main__":
    main()
