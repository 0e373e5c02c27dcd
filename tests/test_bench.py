"""bench.py measures only on a GPU: anywhere else it exits non-zero and
prints no result."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_refuses_without_gpu():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**{k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
             "JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no GPU" in out.stderr
