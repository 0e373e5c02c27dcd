"""Test configuration: CPU backend, float64 parity mode, 8 virtual devices.

The test suite runs against the CPU backend in x64 mode so numerics can be
compared to scipy oracles at double precision (the reference is
float64/complex128 throughout). The 8 virtual host devices exercise the
multi-device sharding paths (SURVEY.md §4: sharded psum result ==
single-device result) without several GPUs. The platform is set through
jax.config before any backend initializes, so the suite stays on the CPU
even on a machine with a GPU; tests marked ``gpu`` reach the card through a
child process.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
