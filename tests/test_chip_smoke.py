"""chip_smoke.py: every phase at a tiny size on the CPU, its float64
oracles, and its refusal to run anywhere but on a GPU.

The script itself runs on the card (``python chip_smoke.py``); the test
marked ``gpu`` runs it there and skips elsewhere.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _load_chip_smoke()


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(extra)
    return env


def _checked(report, names):
    assert set(names) <= set(report["checks"]), report["checks"]
    for name in names:
        check = report["checks"][name]
        if "tol" in check:
            assert check["err"] <= check["tol"]
    return report


def test_phase_closed_tiny():
    report = cs.phase_closed(d=4, n_controls=2, n_steps=60,
                             evolution_time=2.0, chunk=2)
    _checked(report, ["final_state_vs_scipy", "loss_vs_cpu", "grad_vs_cpu",
                      "grad_vs_float64", "grape_error_falls"])
    assert report["grape"]["iterations"] == 6
    assert report["grape"]["steady_s_per_it"] > 0


def test_phase_open_tiny():
    report = cs.phase_open(levels=4, control_eval_count=6,
                           system_eval_count=11, evolution_time=10.0,
                           chunk=2)
    _checked(report, ["final_density_vs_scipy", "grape_error_falls"])
    assert report["superoperator"] == 16


def test_phase_rkdp5():
    report = cs.phase_rkdp5(chunk=2)
    _checked(report, ["final_density_vs_solve_ivp", "grape_error_falls"])


def test_phase_multistart_tiny():
    report = cs.phase_multistart(n_starts=8, d=4, n_controls=2, n_steps=20,
                                 chunk=2)
    _checked(report, ["winner_error_vs_single_run"])
    assert report["checks"]["winner_best_iteration"] >= 1
    assert report["grape"]["candidate_iterations_per_s"] > 0


def test_phase_four_tiny():
    """The 4-device ensemble against one device, on 4 of the suite's
    virtual CPU devices."""
    report = cs.phase_four(n_devices=4, n_members=8, d=4, n_controls=2,
                           n_steps=40, evolution_time=2.0, chunk=2)
    _checked(report, ["loss_vs_one_card", "grad_vs_one_card",
                      "grape_error_falls"])
    assert report["checks"]["loss_devices"] == [0, 1, 2, 3]


def test_oracle_schroedinger_pi_pulse():
    """A constant resonant drive H = c sigma_x with c T = pi/2 flips |0>
    to -i|1>."""
    sigma_x = np.array([[0, 1], [1, 0]], dtype=complex)
    controls = np.full((5, 1), np.pi / 2)       # drive + h.c. = c sigma_x
    psi = cs.oracle_schroedinger(np.zeros((2, 2)), sigma_x[None] / 2,
                                 controls, 1.0, 40, np.array([[1], [0]]))
    assert np.allclose(psi, [[0], [-1j]], atol=1e-12)


def test_oracle_lindblad_magnus_matches_ode():
    """With constant controls the Magnus-M2 superoperator product is exact,
    so it equals the ODE oracle; T1 decay matches exp(-gamma t)."""
    a = np.array([[0, 1], [0, 0]], dtype=complex)
    h0 = np.diag([0.5, -0.5]).astype(complex)
    rho0 = np.array([[[0, 0], [0, 1]]], dtype=complex)
    controls = np.full((4, 1), 0.2 + 0.1j)
    magnus = cs.oracle_lindblad_magnus(h0, a[None], 0.3, a, controls, 2.0,
                                       8, rho0)
    ode = cs.oracle_lindblad_ode(h0, a[None], 0.3, a, controls, 2.0, rho0)
    assert np.abs(magnus - ode).max() < 1e-9
    free = cs.oracle_lindblad_ode(h0, a[None], 0.3, a, np.zeros((4, 1)),
                                  2.0, rho0)
    assert abs(free[0, 1, 1].real - np.exp(-0.6)) < 1e-9


def test_refuses_without_gpu():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=_child_env(JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_fails_without_the_repository(tmp_path):
    """Alone in a directory, the script prints no result and fails."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300,
        env=_child_env(JAX_PLATFORMS="cpu", PYTHONPATH=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture()
def gpu():
    """Skip unless an NVIDIA GPU answers; decided here, never at import."""
    try:
        found = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                               text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        pytest.skip("no nvidia-smi: no GPU on this machine")
    if found.returncode != 0 or "GPU" not in found.stdout:
        pytest.skip("nvidia-smi finds no GPU")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=1200, env=_child_env())
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
