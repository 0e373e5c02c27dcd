"""Global numerics configuration for qoc_tpu.

The reference implementation (/root/reference/qoc) is float64/complex128
throughout (numpy defaults). GPUs run float32 far faster than float64, so
qoc_tpu derives its working dtypes from JAX's x64 mode:

- ``jax.config.jax_enable_x64 == True``  -> float64 / complex128 (parity mode,
  used by the CPU test-suite against scipy oracles)
- ``jax.config.jax_enable_x64 == False`` -> float32 / complex64 (speed mode;
  every product on the propagation and cost path requests
  ``MATMUL_PRECISION`` so that no float32 product runs as TF32)
"""

import os

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "as_complex",
    "real_dtype",
    "complex_dtype",
    "np_real_dtype",
    "np_complex_dtype",
    "device_get",
    "use_compile_cache",
    "MATMUL_PRECISION",
]

# Precision of every matrix product on the propagation and cost path.
# HIGHEST keeps float32 products in full float32 (a GPU would otherwise be
# free to run them as TF32, about three decimal digits, which fidelity-grade
# GRAPE cannot afford); float64 products are unaffected.
MATMUL_PRECISION = lax.Precision.HIGHEST


def real_dtype():
    """The working real dtype (float64 under x64 mode, else float32)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def complex_dtype():
    """The working complex dtype (complex128 under x64 mode, else complex64)."""
    return jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64


def np_real_dtype():
    return np.float64 if jax.config.jax_enable_x64 else np.float32


def np_complex_dtype():
    return np.complex128 if jax.config.jax_enable_x64 else np.complex64


def as_complex(x):
    """``x`` in the working complex dtype (numpy stays numpy, so jitted code
    embeds host data as a constant)."""
    if isinstance(x, (jax.Array, jax.core.Tracer)):
        return x.astype(complex_dtype())
    return np.asarray(x).astype(np_complex_dtype())


def device_get(tree):
    """Pull a pytree of device arrays to host numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def use_compile_cache():
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, names the directory and JAX
    reads it itself; otherwise the cache lives in ``.jax_cache`` at the root
    of this checkout, a fixed path, so that later runs find it again.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def is_io_process():
    """True on the process that owns stdout logging and H5 writes.

    Single-host runs are trivially the I/O process. Under
    ``jax.distributed`` every process executes the same SPMD program, but
    only process 0 may talk to the save file and the terminal — otherwise
    an N-host run prints N copies of every log row and races N writers on
    one H5 file (the FileLock in io/h5.py is per-host, not cross-host).
    Reads (``resume_from``) stay un-gated: the save file must live on a
    filesystem every process can read (shared FS), and each process loads
    the same checkpoint so the restored params agree everywhere.
    """
    return jax.process_index() == 0
