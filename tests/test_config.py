"""Host transfers, the compile-cache helper, and the save-file packages that
only saving needs."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qoc_tpu import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_left_to_the_environment(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and nothing
    sets another directory in code."""
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda *args: calls.append(args))
    assert config.use_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *args: calls.append(args))
    path = config.use_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


@pytest.mark.parametrize("value", [
    np.array([1 + 2j, -3.5j], dtype=np.complex128),
    np.array([True, False, True]),
    np.array([[7, -2], [2 ** 40, 0]], dtype=np.int64),
], ids=["complex", "bool", "int"])
def test_device_get_round_trips(value):
    got = config.device_get(jnp.asarray(value))
    assert isinstance(got, np.ndarray)
    assert got.dtype == value.dtype
    assert np.array_equal(got, value)


def test_device_get_pytree():
    tree = {"a": jnp.arange(3), "b": (jnp.ones(2, jnp.complex64), 1.5)}
    got = config.device_get(tree)
    assert np.array_equal(got["a"], [0, 1, 2])
    assert got["b"][0].dtype == np.complex64
    assert float(got["b"][1]) == 1.5


def test_as_complex_keeps_host_data_on_the_host():
    host = config.as_complex(np.eye(2))
    assert isinstance(host, np.ndarray)
    assert host.dtype == config.np_complex_dtype()
    traced = jax.jit(lambda x: config.as_complex(x))(jnp.eye(2))
    assert traced.dtype == config.complex_dtype()


_NO_H5 = """
import sys
sys.modules["h5py"] = None
sys.modules["filelock"] = None
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import qoc_tpu
from qoc_tpu.standard import TargetStateInfidelity
h = np.diag([0.5, -0.5]).astype(complex)
a = np.array([[0, 1], [0, 0]], dtype=complex)
result = qoc_tpu.grape_schroedinger_discrete(
    1, 5, [TargetStateInfidelity(np.array([[[0.0], [1.0]]]))], 4.0,
    qoc_tpu.LinearHamiltonian(h, a[None]), np.array([[[1.0], [0.0]]]), 5,
    complex_controls=True, iteration_count=3, log_iteration_step=0,
    save_file_path={save!r}, save_iteration_step={step})
print("best", result.best_error)
"""


def _run_without_h5(save=None, step=0):
    return subprocess.run(
        [sys.executable, "-c", _NO_H5.format(save=save, step=step)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "XLA_FLAGS"})


def test_grape_runs_without_h5py_and_filelock():
    out = _run_without_h5()
    assert out.returncode == 0, out.stderr[-2000:]
    assert "best" in out.stdout


def test_saving_without_h5py_names_the_missing_package(tmp_path):
    out = _run_without_h5(save=str(tmp_path / "run.h5"), step=1)
    assert out.returncode != 0
    assert "save files need h5py and filelock" in out.stderr
