"""Run the GRAPE main path once on an NVIDIA GPU, at full size, and check it.

Usage (from the repository root):

    python chip_smoke.py          # one GPU: the four single-card phases
    python chip_smoke.py --four   # four GPUs: sharded ensemble vs one card

Phases, each through the public entry points a user calls:

- ``closed``: ``grape_schroedinger_discrete`` at the reference's published
  Table-3 size (d=64, 10 complex controls, 10^4 steps,
  ``TargetStateInfidelity``, Adam); ``evolve_schroedinger_discrete`` against
  a float64 product of ``scipy.linalg.expm`` factors; one loss and gradient
  against the same jitted function on the CPU backend.
- ``open``: ``grape_lindblad_discrete`` with ``LindbladMethod.MAGNUS_EXPM`` on
  the 20-level lossy cavity of ``examples/7_cavity_lindblad.py`` (400 x 400
  superoperators); ``evolve_lindblad_discrete`` against a float64 scipy
  superoperator product.
- ``rkdp5``: ``grape_lindblad_discrete`` with ``LindbladMethod.RKDP5`` on the
  decaying transmon of ``examples/1_transmon_pi_decoherence.py``; the
  adaptive evolution against ``scipy.integrate.solve_ivp``.
- ``multistart``: ``grape_schroedinger_multistart`` with 512 candidates at
  d=64, 10 controls, 201 steps; the winner's error against a single-run
  evaluation of its controls.
- ``four`` (``--four`` only): ``grape_schroedinger_ensemble`` on a 4-GPU mesh
  against the same ensemble on one GPU.

Every phase prints one ``PHASE {...}`` line: its compile time (the first
optimizer chunk, tracing and compilation included), its steady time per
iteration, each oracle error beside its tolerance, and the device's
``peak_bytes_in_use``. The card's name and power limit come from
``nvidia-smi``. A phase that fails is reported and makes the script exit
non-zero; so does a machine without a GPU. On success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Float32 tolerances: products on the propagation path run at
``Precision.HIGHEST`` (full float32, not TF32), so each step's expm carries
a relative error of a few 1e-7; a product of N steps drifts by about
sqrt(N) times that and at worst N times it. TF32 products (about 5e-4 per
product) would miss every bound below by orders of magnitude.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

# Closed-system oracle: 10^4 float32 steps drift ~1e-5 (random walk) and at
# worst ~1e-2 (linear); 1e-3 leaves room for the first and fails TF32.
CLOSED_STATE_TOL = 1e-3
# Same float32 function on two backends: only the summation order differs.
# The float32 gradient of this problem (final fidelity ~1e-3) is good to
# ~1e-2 of its largest entry on either backend (H100 vs CPU, both against
# the float64 gradient: 6.9e-3 and 8.5e-3; against each other 1.4e-2);
# TF32 products would put it off by order one.
CPU_LOSS_TOL = 1e-4
CPU_GRAD_TOL = 5e-2
FLOAT64_GRAD_TOL = 3e-2
# 50 float32 superoperator steps (with squarings) drift ~1e-6 .. 1e-5.
OPEN_DENSITY_TOL = 1e-4
# Per-step absolute tolerance of the adaptive integrator: 1e-7 is about the
# finest float32 reaches (at 1e-8 the step controller never accepts); it
# lands ~1e-5 from the float64 solution.
RKDP5_ATOL = 1e-7
RKDP5_DENSITY_TOL = 1e-4
# Winner error re-evaluated by the single-run loss: float32 rounding only.
MULTISTART_ERROR_TOL = 1e-4
# One card vs four: the member sum is reduced in another order.
FOUR_LOSS_TOL = 1e-5
FOUR_GRAD_TOL = 1e-4


# ---------------------------------------------------------------------------
# Independent float64 references (numpy / scipy only)
# ---------------------------------------------------------------------------

def _random_hermitian(rng, d):
    h = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    return (h + h.conj().T) / 2


def _interp(t, xs, ys):
    """Piecewise-linear controls at time ``t``, extrapolated linearly from
    the two boundary samples (the reference's interpolation rule)."""
    i = int(np.clip(np.searchsorted(xs, t, side="left"), 1, len(xs) - 1))
    return ys[i - 1] + (ys[i] - ys[i - 1]) / (xs[i] - xs[i - 1]) * (
        t - xs[i - 1])


def _linear_h(h0, ops, c):
    drive = np.tensordot(c, ops, axes=(0, 0))
    return h0 + drive + drive.conj().T


def oracle_schroedinger(h0, ops, controls, evolution_time, n_steps, psi0,
                        chunk=1000):
    """Final states of the Magnus-M2 time mesh, in float64: one
    ``scipy.linalg.expm`` of -i dt H(midpoint) per step."""
    import scipy.linalg
    cet = np.linspace(0, evolution_time, controls.shape[0])
    dt = evolution_time / n_steps
    psi = np.asarray(psi0, dtype=np.complex128)
    for start in range(0, n_steps, chunk):
        ks = range(start, min(n_steps, start + chunk))
        gens = np.stack([-1j * dt * _linear_h(
            h0, ops, _interp((k + 0.5) * dt, cet, controls)) for k in ks])
        for u in scipy.linalg.expm(gens):
            psi = u @ psi
    return psi


def _superoperator(h, gamma, lop):
    """Row-major vec superoperator of -i[H, rho] + gamma D[L] rho."""
    d = h.shape[0]
    eye = np.eye(d)
    p = lop.conj().T @ lop
    return (-1j * (np.kron(h, eye) - np.kron(eye, h.T))
            + gamma * (np.kron(lop, lop.conj()) - 0.5 * np.kron(p, eye)
                       - 0.5 * np.kron(eye, p.T)))


def oracle_lindblad_magnus(h0, ops, gamma, lop, controls, evolution_time,
                           n_steps, rho0):
    """Final densities of the Magnus-M2 superoperator mesh, in float64."""
    import scipy.linalg
    cet = np.linspace(0, evolution_time, controls.shape[0])
    dt = evolution_time / n_steps
    vecs = np.asarray(rho0, dtype=np.complex128).reshape(rho0.shape[0], -1)
    gens = np.stack([dt * _superoperator(
        _linear_h(h0, ops, _interp((k + 0.5) * dt, cet, controls)), gamma,
        lop) for k in range(n_steps)])
    for s in scipy.linalg.expm(gens):
        vecs = vecs @ s.T
    return vecs.reshape(rho0.shape)


def oracle_lindblad_ode(h0, ops, gamma, lop, controls, evolution_time, rho0):
    """Final densities of the continuous-time master equation with linearly
    interpolated controls, by ``scipy.integrate.solve_ivp`` in float64."""
    from scipy.integrate import solve_ivp
    cet = np.linspace(0, evolution_time, controls.shape[0])
    out = []
    for rho in np.asarray(rho0, dtype=np.complex128):
        def rhs(t, v):
            s = _superoperator(_linear_h(h0, ops, _interp(t, cet, controls)),
                               gamma, lop)
            return s @ v
        sol = solve_ivp(rhs, (0.0, evolution_time), rho.reshape(-1),
                        method="DOP853", rtol=1e-11, atol=1e-12)
        out.append(sol.y[:, -1].reshape(rho.shape))
    return np.stack(out)


# ---------------------------------------------------------------------------
# Phase plumbing
# ---------------------------------------------------------------------------

def _peak_bytes(device=None):
    import jax
    stats = (device or jax.devices()[0]).memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _check(report, name, err, tol):
    err = float(err)
    report["checks"][name] = {"err": err, "tol": tol}
    if not np.isfinite(err) or err > tol:
        raise AssertionError("{}: {} error {} exceeds {}".format(
            report["phase"], name, err, tol))


def _timed(report, key, call, iterations_per_step=1):
    """Run one GRAPE driver call; record its first-chunk time (tracing and
    compilation included) and its steady seconds per iteration."""
    start = time.perf_counter()
    result = call()
    wall = time.perf_counter() - start
    steady = iterations_per_step / result.iterations_per_s
    ran = result.iteration_count_ran
    report[key] = {"compile_s": wall - ran * steady, "steady_s_per_it": steady,
                   "wall_s": wall, "iterations": ran}
    return result


def _errors_fall(report, name, errors):
    errors = np.asarray(errors)
    report["checks"][name] = {"first": float(errors[0]),
                              "last": float(errors[-1])}
    if not (np.all(np.isfinite(errors)) and errors[-1] < errors[0]):
        raise AssertionError("{}: GRAPE error did not fall: {}".format(
            report["phase"], errors))


def _closed_problem(d, n_controls, seed):
    from qoc_tpu import LinearHamiltonian
    from qoc_tpu.standard import TargetStateInfidelity
    rng = np.random.default_rng(seed)
    h0 = _random_hermitian(rng, d)
    ops = np.stack([_random_hermitian(rng, d) for _ in range(n_controls)])
    initial = np.zeros((1, d, 1)); initial[0, 0] = 1
    target = np.zeros((1, d, 1)); target[0, -1] = 1
    return (h0, ops, LinearHamiltonian(h0, ops), initial,
            [TargetStateInfidelity(target)], rng)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_closed(d=64, n_controls=10, n_steps=10_000, evolution_time=100.0,
                 chunk=4, chunks=3, seed=0):
    """Closed system at the reference's Table-3 size."""
    import jax
    import jax.numpy as jnp
    from qoc_tpu import (evolve_schroedinger_discrete,
                         grape_schroedinger_discrete)
    from qoc_tpu.core.common import slap_controls_jax, strip_controls
    from qoc_tpu.core.schroedinger import build_schroedinger_loss
    from qoc_tpu.models import (GrapeSchroedingerDiscreteState,
                                InterpolationPolicy, MagnusPolicy)
    from qoc_tpu.optim import Adam

    report = {"phase": "closed", "d": d, "controls": n_controls,
              "steps": n_steps, "checks": {}}
    h0, ops, ham, initial, costs, rng = _closed_problem(d, n_controls, seed)
    system_eval_count = n_steps + 1
    controls = 0.1 * (rng.normal(size=(n_steps, n_controls))
                      + 1j * rng.normal(size=(n_steps, n_controls)))

    evolved = evolve_schroedinger_discrete(
        evolution_time, ham, initial, system_eval_count, controls=controls)
    want = oracle_schroedinger(h0, ops, controls, evolution_time, n_steps,
                               initial[0])
    _check(report, "final_state_vs_scipy",
           np.abs(evolved.final_states[0] - want).max(), CLOSED_STATE_TOL)

    def loss_and_grad(device, x64=False):
        """One jitted loss and gradient on ``device``; float64 if asked."""
        with (jax.enable_x64(True) if x64 else contextlib.nullcontext()), \
                jax.default_device(device):
            pstate = GrapeSchroedingerDiscreteState(
                True, n_controls, n_steps, 1, costs, evolution_time, ham,
                None, controls, initial, InterpolationPolicy.LINEAR, 1, 0,
                np.ones(n_controls), MagnusPolicy.M2, 0, Adam(), None, False,
                0, system_eval_count)
            loss = build_schroedinger_loss(pstate)
            flat = strip_controls(True, controls).astype(
                np.float64 if x64 else np.float32)
            err, grad = jax.jit(jax.value_and_grad(lambda p: loss(
                slap_controls_jax(True, p, pstate.controls_shape))[0]))(
                    jnp.asarray(flat))
            return float(err), np.asarray(grad, dtype=np.float64)

    dev_err, dev_grad = loss_and_grad(jax.devices()[0])
    cpu_err, cpu_grad = loss_and_grad(jax.devices("cpu")[0])
    _, ref_grad = loss_and_grad(jax.devices()[0], x64=True)
    _check(report, "loss_vs_cpu", abs(dev_err - cpu_err), CPU_LOSS_TOL)
    _check(report, "grad_vs_cpu", np.abs(dev_grad - cpu_grad).max()
           / np.abs(cpu_grad).max(), CPU_GRAD_TOL)
    _check(report, "grad_vs_float64", np.abs(dev_grad - ref_grad).max()
           / np.abs(ref_grad).max(), FLOAT64_GRAD_TOL)

    result = _timed(report, "grape", lambda: grape_schroedinger_discrete(
        n_controls, n_steps, costs, evolution_time, ham, initial,
        system_eval_count, complex_controls=True,
        iteration_count=chunk * chunks, log_iteration_step=0,
        optimizer=Adam(), fused_chunk=chunk))
    _errors_fall(report, "grape_error_falls", result.errors)
    report["peak_bytes_in_use"] = _peak_bytes()
    return report


def _cavity(levels):
    from qoc_tpu.standard import get_annihilation_operator
    a = get_annihilation_operator(levels)
    n = a.conj().T @ a
    kerr = -2 * np.pi * 1e-3
    h0 = (kerr / 2) * n @ (n - np.eye(levels))
    return h0, a


def phase_open(levels=20, control_eval_count=26, system_eval_count=51,
               evolution_time=50.0, chunk=4, chunks=3, seed=1):
    """Open system: the lossy cavity of examples/7_cavity_lindblad.py."""
    from qoc_tpu import (LinearHamiltonian, evolve_lindblad_discrete,
                         grape_lindblad_discrete)
    from qoc_tpu.models import ConstantLindblad, LindbladMethod
    from qoc_tpu.optim import Adam
    from qoc_tpu.standard import TargetDensityInfidelity

    report = {"phase": "open", "d": levels, "superoperator": levels ** 2,
              "steps": system_eval_count - 1, "checks": {}}
    kappa = 1.0 / 2000.0
    h0, a = _cavity(levels)
    ham = LinearHamiltonian(h0.astype(np.complex64),
                            a[None].astype(np.complex64))
    lindblad = ConstantLindblad(np.array([kappa]),
                                a[None].astype(np.complex64))
    rho0 = np.zeros((1, levels, levels), dtype=complex); rho0[0, 0, 0] = 1
    target = np.zeros_like(rho0); target[0, 1, 1] = 1
    rng = np.random.default_rng(seed)
    controls = 0.05 * (rng.normal(size=(control_eval_count, 1))
                       + 1j * rng.normal(size=(control_eval_count, 1)))

    evolved = evolve_lindblad_discrete(
        evolution_time, rho0, system_eval_count, controls=controls,
        hamiltonian=ham, lindblad_data=lindblad,
        method=LindbladMethod.MAGNUS_EXPM)
    want = oracle_lindblad_magnus(h0, a[None], kappa, a, controls,
                                  evolution_time, system_eval_count - 1, rho0)
    _check(report, "final_density_vs_scipy",
           np.abs(evolved.final_densities - want).max(), OPEN_DENSITY_TOL)

    # A drive of 0.01 displaces the vacuum to |alpha| ~ 0.5 in 50 ns, where
    # the one-photon population (and the float32 error) visibly responds.
    result = _timed(report, "grape", lambda: grape_lindblad_discrete(
        1, control_eval_count, [TargetDensityInfidelity(target)],
        evolution_time, rho0, system_eval_count, complex_controls=True,
        hamiltonian=ham, initial_controls=np.full(
            (control_eval_count, 1), 0.01 + 0j),
        iteration_count=chunk * chunks, lindblad_data=lindblad,
        log_iteration_step=0, max_control_norms=np.array([0.05]),
        method=LindbladMethod.MAGNUS_EXPM,
        optimizer=Adam(learning_rate=0.005), fused_chunk=chunk))
    _errors_fall(report, "grape_error_falls", result.errors)
    report["peak_bytes_in_use"] = _peak_bytes()
    return report


def phase_rkdp5(chunk=4, chunks=3, seed=2):
    """Adaptive RKDP5: the decaying transmon of example 1 (d=2, T1=1 us,
    11 control steps over 10 ns, one system_eval interval)."""
    import jax.numpy as jnp
    from qoc_tpu import evolve_lindblad_discrete, grape_lindblad_discrete
    from qoc_tpu.models import LindbladMethod
    from qoc_tpu.optim import Adam
    from qoc_tpu.standard import (SIGMA_Z, TargetDensityInfidelity,
                                  get_annihilation_operator)

    report = {"phase": "rkdp5", "d": 2, "checks": {}}
    a = get_annihilation_operator(2)
    h0 = np.asarray(SIGMA_Z) / 2
    gamma = 1e-3

    def hamiltonian(controls, time):
        return h0 + controls[0] * a + jnp.conjugate(controls[0]) * a.T

    def lindblad_data(time):
        return np.array([gamma]), a[None]

    rho0 = np.array([[[1.0, 0.0], [0.0, 0.0]]], dtype=complex)
    target = np.array([[[0.0, 0.0], [0.0, 1.0]]], dtype=complex)
    rng = np.random.default_rng(seed)
    controls = 0.3 * (rng.normal(size=(11, 1)) + 1j * rng.normal(size=(11, 1)))

    evolved = evolve_lindblad_discrete(
        10.0, rho0, 2, controls=controls, hamiltonian=hamiltonian,
        lindblad_data=lindblad_data, method=LindbladMethod.RKDP5,
        atol=RKDP5_ATOL)
    want = oracle_lindblad_ode(h0, a[None], gamma, a, controls, 10.0, rho0)
    _check(report, "final_density_vs_solve_ivp",
           np.abs(evolved.final_densities - want).max(), RKDP5_DENSITY_TOL)

    result = _timed(report, "grape", lambda: grape_lindblad_discrete(
        1, 11, [TargetDensityInfidelity(target)], 10.0, rho0, 2,
        complex_controls=True, hamiltonian=hamiltonian,
        iteration_count=chunk * chunks, lindblad_data=lindblad_data,
        log_iteration_step=0, max_control_norms=np.array([5.0]),
        optimizer=Adam(learning_rate=0.05), method=LindbladMethod.RKDP5,
        atol=RKDP5_ATOL, rkdp5_max_steps=256, fused_chunk=chunk))
    _errors_fall(report, "grape_error_falls", result.errors)
    report["peak_bytes_in_use"] = _peak_bytes()
    return report


def phase_multistart(n_starts=512, d=64, n_controls=10, n_steps=200,
                     evolution_time=2.0, chunk=4, chunks=3, seed=3):
    """Many-candidate search: 512 candidates of a d=64 / 10-control /
    201-step problem, candidates batched on one card."""
    import jax
    import jax.numpy as jnp
    from qoc_tpu import grape_schroedinger_multistart
    from qoc_tpu.core.common import (initialize_controls, slap_controls_jax,
                                     strip_controls)
    from qoc_tpu.core.schroedinger import build_schroedinger_loss
    from qoc_tpu.models import (GrapeSchroedingerDiscreteState,
                                InterpolationPolicy, MagnusPolicy)
    from qoc_tpu.optim import Adam

    report = {"phase": "multistart", "candidates": n_starts, "d": d,
              "controls": n_controls, "steps": n_steps, "checks": {}}
    _, _, ham, initial, costs, _ = _closed_problem(d, n_controls, seed)
    system_eval_count = n_steps + 1
    result = _timed(report, "grape", lambda: grape_schroedinger_multistart(
        n_controls, system_eval_count, costs, evolution_time, ham, initial,
        system_eval_count, n_starts=n_starts, complex_controls=True,
        iteration_count=chunk * chunks, log_iteration_step=0,
        optimizer=Adam(), fused_chunk=chunk), iterations_per_step=n_starts)
    report["grape"]["candidate_iterations_per_s"] = result.iterations_per_s
    if not np.all(np.isfinite(result.errors)):
        raise AssertionError("multistart: non-finite candidate errors")
    report["checks"]["winner_best_iteration"] = result.best_iteration
    if result.best_iteration < 1:
        raise AssertionError("multistart: the winner's error never fell")

    _, max_norms = initialize_controls(True, n_controls, system_eval_count,
                                       evolution_time, None, None)
    pstate = GrapeSchroedingerDiscreteState(
        True, n_controls, system_eval_count, 1, costs, evolution_time, ham,
        None, result.best_controls, initial, InterpolationPolicy.LINEAR, 1,
        0, max_norms, MagnusPolicy.M2, 0, Adam(), None, False, 0,
        system_eval_count)
    loss = build_schroedinger_loss(pstate)
    single = jax.jit(lambda f: loss(slap_controls_jax(
        True, f, pstate.controls_shape))[0])(jnp.asarray(strip_controls(
            True, result.best_controls).astype(np.float32)))
    _check(report, "winner_error_vs_single_run",
           abs(float(single) - result.best_error), MULTISTART_ERROR_TOL)
    report["peak_bytes_in_use"] = _peak_bytes()
    return report


def phase_four(n_devices=4, n_members=16, d=64, n_controls=10,
               n_steps=2000, evolution_time=20.0, chunk=4, chunks=3, seed=4):
    """Ensemble-robust GRAPE with the members sharded over ``n_devices``
    cards, against the same ensemble on one card."""
    import jax
    import jax.numpy as jnp
    from qoc_tpu import EnsembleLinearHamiltonian
    from qoc_tpu.core.common import slap_controls_jax, strip_controls
    from qoc_tpu.models import (GrapeSchroedingerDiscreteState,
                                InterpolationPolicy, MagnusPolicy)
    from qoc_tpu.optim import Adam
    from qoc_tpu.parallel import (build_ensemble_loss,
                                  grape_schroedinger_ensemble, make_mesh)

    devices = jax.devices()
    if len(devices) < n_devices:
        raise RuntimeError("four: needs {} devices, found {}".format(
            n_devices, len(devices)))
    report = {"phase": "four", "devices": n_devices, "members": n_members,
              "d": d, "controls": n_controls, "steps": n_steps,
              "checks": {}}
    h0, ops, _, initial, costs, rng = _closed_problem(d, n_controls, seed)
    ham = EnsembleLinearHamiltonian(h0, ops, h0[None])
    members = np.linspace(-0.05, 0.05, n_members).reshape(-1, 1)
    system_eval_count = n_steps + 1
    controls = 0.1 * (rng.normal(size=(n_steps, n_controls))
                      + 1j * rng.normal(size=(n_steps, n_controls)))
    pstate = GrapeSchroedingerDiscreteState(
        True, n_controls, n_steps, 1, costs, evolution_time, None, None,
        controls, initial, InterpolationPolicy.LINEAR, 1, 0,
        np.ones(n_controls), MagnusPolicy.M2, 0, Adam(), None, False, 0,
        system_eval_count)
    flat = jnp.asarray(strip_controls(True, controls).astype(np.float32))

    def value_and_grad(mesh):
        # One time blocking for both meshes, so that only the order of the
        # member sum differs between them.
        loss = build_ensemble_loss(pstate, ham, members, mesh,
                                   time_block_size=max(1, n_steps // 16))
        return jax.jit(jax.value_and_grad(lambda p: loss(slap_controls_jax(
            True, p, pstate.controls_shape))[0]))(flat)

    err_n, grad_n = value_and_grad(make_mesh(n_devices))
    err_1, grad_1 = value_and_grad(make_mesh(1))
    for name, out in (("loss", err_n), ("grad", grad_n)):
        placed = {dev.id for dev in out.sharding.device_set}
        report["checks"][name + "_devices"] = sorted(placed)
        if len(placed) != n_devices:
            raise AssertionError("four: {} lives on devices {}, not on all "
                                 "{}".format(name, sorted(placed), n_devices))
    grad_1 = np.asarray(grad_1)
    _check(report, "loss_vs_one_card", abs(float(err_n) - float(err_1)),
           FOUR_LOSS_TOL)
    _check(report, "grad_vs_one_card", np.abs(np.asarray(grad_n) - grad_1)
           .max() / np.abs(grad_1).max(), FOUR_GRAD_TOL)

    result = _timed(report, "grape", lambda: grape_schroedinger_ensemble(
        n_controls, n_steps, costs, evolution_time, ham, members, initial,
        system_eval_count, complex_controls=True, mesh=make_mesh(n_devices),
        iteration_count=chunk * chunks, log_iteration_step=0,
        optimizer=Adam(), fused_chunk=chunk))
    _errors_fall(report, "grape_error_falls", result.errors)
    peaks = [_peak_bytes(dev) for dev in devices[:n_devices]]
    report["peak_bytes_in_use"] = peaks
    if None not in peaks and not all(peaks):
        raise AssertionError("four: a device did no work: {}".format(peaks))
    return report


def card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-GPU sharded ensemble phase")
    args = parser.parse_args(argv)
    # Keep the CPU backend beside the GPU one: the closed phase compares
    # against the same function compiled for the CPU.
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"

    import jax
    device = jax.devices()[0]
    if device.platform != "gpu":
        print("chip_smoke: no GPU: JAX's first device is {!r} on platform "
              "{!r}".format(device.device_kind, device.platform),
              file=sys.stderr)
        return 1
    from qoc_tpu.config import use_compile_cache
    print("compile cache: {}".format(use_compile_cache()))
    for line in card().splitlines():
        print("card: {}".format(line))

    phases = ([phase_four] if args.four else
              [phase_closed, phase_open, phase_rkdp5, phase_multistart])
    failed = []
    for phase in phases:
        name = phase.__name__[len("phase_"):]
        try:
            report = phase()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
            print("PHASE {} FAILED".format(name), flush=True)
            continue
        print("PHASE " + json.dumps(report), flush=True)
    if failed:
        print("chip_smoke: failed phases: {}".format(", ".join(failed)),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
