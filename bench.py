"""qoc_tpu benchmark suite (one NVIDIA GPU).

Headline workload: the reference's published backprop benchmark config
(BASELINE.md / report/report/report.tex:107-111, Table 3): d = 2^6 Hilbert
space, 10 controls, 10^4 time steps, one target-state infidelity — one full
GRAPE iteration = loss + exact gradient + Adam update, as one jitted device
step. Baseline: 55.46 s per iteration (autograd+numpy, i7-6700K,
report.tex:111); ``vs_baseline`` is the speedup of the iteration rate over
1/55.46 it/s.

The ``extra`` field carries the rest of the BASELINE table:

- ``stepcost_grape_it_s``: the headline config with a ForbidStates step
  cost, which needs every step's states (prefix-scan composition).
- ``m4_grape_it_s``: Magnus-M4 GRAPE on d=64 / 2001 steps.
- ``backprop_d1024_s``: Table 1 (report.tex:53-62) — single-step
  infidelity backprop at d = 2^10, 10 controls. Baseline 9.452 s; ``x`` is
  the speedup.
- ``lindblad_magnus_it_s`` (+ ``_range``) / ``lindblad_rkdp5_it_s``: GRAPE
  iteration rate on the example-1 workload (d=2 transmon with T1
  dissipation, BASELINE.md workload 2) under both integrators; the MAGNUS
  number is the median of 5 warm windows with their range, since a d=2
  step is bound by dispatch, not by the device.
- ``lindblad_magnus_d20_it_s``: open-system GRAPE at Hilbert d=20
  (400 x 400 superoperators).
- ``multistart_cand_iter_s`` (+ ``_1024_`` / ``_2048_``): candidate
  iterations/s for 512 / 1024 / 2048 pulse candidates (d=2^6, 10 controls,
  201 steps) through ``grape_schroedinger_multistart``.

Every rate is timed over warm iterations that end in ``block_until_ready``.
The JSON line names the device (platform, kind, count) and the card's name
and power limit; without a GPU the script exits non-zero, and a phase that
fails fails the run.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"card", "extra"}.
"""

import json
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

BASELINE_TABLE3_S = 55.46   # report.tex:111 (autograd, 1 CPU, 10^4 steps)
BASELINE_TABLE1_S = 9.452   # report.tex:62  (autograd, 1 CPU, d=2^10)

D = 64                # 2^6 Hilbert dimension
CONTROL_COUNT = 10
SYSTEM_EVAL_COUNT = 10_000
CONTROL_EVAL_COUNT = 10_000
EVOLUTION_TIME = 100.0
WARMUP_ITERATIONS = 2
TIMED_ITERATIONS = 20


def _random_hermitian(rng, d):
    h = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    return ((h + h.conj().T) / 2).astype(np.complex64)


def _bench_problem(d, control_count, control_eval_count, system_eval_count,
                   evolution_time, extra_costs=(), magnus_policy=None):
    from qoc_tpu.core.common import initialize_controls
    from qoc_tpu.models import (GrapeSchroedingerDiscreteState,
                                InterpolationPolicy, LinearHamiltonian,
                                MagnusPolicy)
    from qoc_tpu.optim import Adam
    from qoc_tpu.standard import TargetStateInfidelity

    rng = np.random.default_rng(0)
    h0 = _random_hermitian(rng, d)
    control_ops = np.stack(
        [_random_hermitian(rng, d) for _ in range(control_count)])
    hamiltonian = LinearHamiltonian(h0, control_ops)
    initial = np.zeros((1, d, 1)); initial[0, 0] = 1
    target = np.zeros((1, d, 1)); target[0, -1] = 1
    costs = [TargetStateInfidelity(target)] + list(extra_costs)
    initial_controls, max_norms = initialize_controls(
        True, control_count, control_eval_count, evolution_time, None, None)
    pstate = GrapeSchroedingerDiscreteState(
        True, control_count, control_eval_count, 1, costs, evolution_time,
        hamiltonian, None, initial_controls, initial,
        InterpolationPolicy.LINEAR, TIMED_ITERATIONS, 0, max_norms,
        magnus_policy or MagnusPolicy.M2, 0, Adam(), None, False, 0,
        system_eval_count)
    return pstate, hamiltonian, initial, costs


def _adam_step(loss_controls, controls_shape, initial_controls):
    """(jitted loss+grad+Adam step, params, opt_state)."""
    from qoc_tpu.core.common import slap_controls_jax, strip_controls
    from qoc_tpu.optim import Adam

    optimizer = Adam()

    def loss_flat(flat_params):
        return loss_controls(slap_controls_jax(True, flat_params,
                                               controls_shape))

    @jax.jit
    def step(params, opt_state):
        (error, _), grads = jax.value_and_grad(loss_flat,
                                               has_aux=True)(params)
        opt_state, params = optimizer.update_jax(opt_state, grads, params)
        return params, opt_state, error

    params = jnp.asarray(strip_controls(True, initial_controls))
    return step, params, optimizer.init_state(params)


def _time_steps(step, params, opt_state, windows=1):
    """Seconds per warm iteration over ``windows`` windows of
    ``TIMED_ITERATIONS`` iterations each."""
    for _ in range(WARMUP_ITERATIONS):
        params, opt_state, error = step(params, opt_state)
    jax.block_until_ready(error)
    times = []
    for _ in range(windows):
        start = time.perf_counter()
        for _ in range(TIMED_ITERATIONS):
            params, opt_state, error = step(params, opt_state)
        jax.block_until_ready(error)
        times.append((time.perf_counter() - start) / TIMED_ITERATIONS)
    return times


def _schroedinger_seconds(pstate):
    from qoc_tpu.core.schroedinger import build_schroedinger_loss
    step, params, opt_state = _adam_step(build_schroedinger_loss(pstate),
                                         pstate.controls_shape,
                                         pstate.initial_controls)
    return _time_steps(step, params, opt_state)[0]


def bench_headline():
    """Table-3 config GRAPE iteration rate."""
    pstate, *_ = _bench_problem(D, CONTROL_COUNT, CONTROL_EVAL_COUNT,
                                SYSTEM_EVAL_COUNT, EVOLUTION_TIME)
    return 1.0 / _schroedinger_seconds(pstate)


def bench_stepcost():
    """Headline-config GRAPE iteration rate with a ForbidStates step cost."""
    from qoc_tpu.standard import ForbidStates
    forb = np.zeros((1, 1, D, 1), dtype=complex)
    forb[0, 0, 1] = 1
    pstate, *_ = _bench_problem(
        D, CONTROL_COUNT, CONTROL_EVAL_COUNT, SYSTEM_EVAL_COUNT,
        EVOLUTION_TIME, extra_costs=[ForbidStates(
            forb, SYSTEM_EVAL_COUNT, cost_multiplier=0.1)])
    return 1.0 / _schroedinger_seconds(pstate)


def bench_m4():
    """Magnus-M4 GRAPE iteration rate on d=64 / 10 controls / 2001 steps."""
    from qoc_tpu.models import MagnusPolicy
    pstate, *_ = _bench_problem(D, CONTROL_COUNT, 2001, 2001, 20.0,
                                magnus_policy=MagnusPolicy.M4)
    return 1.0 / _schroedinger_seconds(pstate)


def bench_d1024_backprop():
    """Table-1 config: single-step infidelity backprop at d = 2^10."""
    pstate, *_ = _bench_problem(1024, 10, 2, 2, 0.05)
    return _schroedinger_seconds(pstate)


def _lindblad_pstate(d, control_eval_count, system_eval_count,
                     evolution_time, method, hamiltonian, lindblad_data,
                     initial, target):
    from qoc_tpu.core.common import initialize_controls
    from qoc_tpu.models import (GrapeLindbladDiscreteState,
                                InterpolationPolicy, MagnusPolicy)
    from qoc_tpu.optim import Adam
    from qoc_tpu.standard import TargetDensityInfidelity

    ic, mn = initialize_controls(True, 1, control_eval_count, evolution_time,
                                 None, None)
    pstate = GrapeLindbladDiscreteState(
        True, 1, control_eval_count, 1, [TargetDensityInfidelity(target)],
        evolution_time, hamiltonian, None, ic, initial,
        InterpolationPolicy.LINEAR, TIMED_ITERATIONS, lindblad_data, 0, mn,
        0, Adam(), None, False, 0, system_eval_count)
    pstate.method_ = method
    # atol 1e-7 is about the finest float32 reaches with RKDP5.
    pstate.atol = 1e-7
    pstate.rtol = 0.0
    pstate.rkdp5_max_steps = 256
    pstate.magnus_policy_ = MagnusPolicy.M2
    return pstate


def _lindblad_seconds(pstate, windows=1):
    from qoc_tpu.core.lindblad import build_lindblad_loss
    step, params, opt_state = _adam_step(build_lindblad_loss(pstate),
                                         pstate.controls_shape,
                                         pstate.initial_controls)
    return _time_steps(step, params, opt_state, windows)


def bench_lindblad(method, windows=1):
    """Example-1 GRAPE seconds per iteration under ``method`` (d=2
    transmon, T1 = 1000 ns, 11 control steps;
    /root/reference/examples/1_transmon_pi_dechoerence.py:21-60)."""
    from qoc_tpu.models import (ConstantLindblad, LindbladMethod,
                                LinearHamiltonian)
    from qoc_tpu.standard import get_annihilation_operator

    h0 = (np.asarray([[1, 0], [0, -1]]) / 2).astype(np.complex64)
    a = get_annihilation_operator(2).astype(np.complex64)
    pstate = _lindblad_pstate(
        2, 11, 21 if method == LindbladMethod.MAGNUS_EXPM else 2, 10.0,
        method, LinearHamiltonian(h0, a[None]),
        ConstantLindblad(np.array([1.0 / 1000.0]), a[None]),
        np.array([[[1.0, 0.0], [0.0, 0.0]]], dtype=complex),
        np.array([[[0.0, 0.0], [0.0, 1.0]]], dtype=complex))
    return _lindblad_seconds(pstate, windows)


def bench_lindblad_d20():
    """Open-system GRAPE at Hilbert d=20 (400 x 400 superoperators)."""
    from qoc_tpu.models import (ConstantLindblad, LindbladMethod,
                                LinearHamiltonian)
    from qoc_tpu.standard import get_annihilation_operator

    d = 20
    a = get_annihilation_operator(d).astype(np.complex64)
    n_op = (a.conj().T @ a).astype(np.complex64)
    ini = np.zeros((1, d, d), dtype=complex); ini[0, 0, 0] = 1
    tgt = np.zeros((1, d, d), dtype=complex); tgt[0, 1, 1] = 1
    pstate = _lindblad_pstate(
        d, 101, 101, 10.0, LindbladMethod.MAGNUS_EXPM,
        LinearHamiltonian(0.1 * n_op, a[None]),
        ConstantLindblad(np.array([1e-3]), a[None]), ini, tgt)
    return _lindblad_seconds(pstate)[0]


def bench_multistart(n_starts=512):
    """Candidate-iterations/s: ``n_starts`` simultaneous candidates on a
    d=64 / 10-control / 201-step problem. One run, timed at steady state:
    the driver's rate drops its first chunk (tracing and compilation)."""
    from qoc_tpu.parallel import grape_schroedinger_multistart
    from qoc_tpu.optim import Adam

    _, hamiltonian, initial, costs = _bench_problem(
        D, CONTROL_COUNT, 201, 201, 2.0)
    result = grape_schroedinger_multistart(
        CONTROL_COUNT, 201, costs, 2.0, hamiltonian, initial, 201,
        n_starts=n_starts, complex_controls=True, iteration_count=48,
        log_iteration_step=0, optimizer=Adam(), fused_chunk=12)
    return result.iterations_per_s


def card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main():
    device = jax.devices()[0]
    if device.platform != "gpu":
        print("bench: no GPU: JAX's first device is {!r} on platform {!r}"
              "".format(device.device_kind, device.platform),
              file=sys.stderr)
        return 1
    from qoc_tpu.config import use_compile_cache
    from qoc_tpu.models import LindbladMethod
    use_compile_cache()

    headline_rate = bench_headline()
    extra = {"stepcost_grape_it_s": bench_stepcost(),
             "m4_grape_it_s": bench_m4()}
    t1024 = bench_d1024_backprop()
    extra["backprop_d1024_s"] = t1024
    extra["backprop_d1024_x"] = BASELINE_TABLE1_S / t1024
    rates = sorted(1.0 / t for t in bench_lindblad(
        LindbladMethod.MAGNUS_EXPM, windows=5))
    extra["lindblad_magnus_it_s"] = rates[len(rates) // 2]
    extra["lindblad_magnus_range"] = [rates[0], rates[-1]]
    extra["lindblad_rkdp5_it_s"] = 1.0 / bench_lindblad(
        LindbladMethod.RKDP5)[0]
    extra["lindblad_magnus_d20_it_s"] = 1.0 / bench_lindblad_d20()
    extra["multistart_cand_iter_s"] = bench_multistart()
    for n in (1024, 2048):
        extra["multistart_{}_cand_iter_s".format(n)] = bench_multistart(n)

    print(json.dumps({
        "metric": "grape_iterations_per_s_d64_c10_t10k",
        "value": headline_rate,
        "unit": "iterations/s",
        "vs_baseline": headline_rate * BASELINE_TABLE3_S,
        "device": {"platform": device.platform,
                   "kind": device.device_kind,
                   "count": len(jax.devices())},
        "card": card(),
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
