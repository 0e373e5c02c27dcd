"""Batched complex linear-algebra primitives.

Counterparts of the reference convenience ops
(/root/reference/qoc/standard/functions/convenience.py:16-104). All functions
are pure, jit-safe, and batched over arbitrary leading axes.
"""

import functools

import jax.numpy as jnp

from qoc_tpu.config import MATMUL_PRECISION

__all__ = [
    "commutator",
    "conjugate_transpose",
    "krons",
    "matmuls",
    "mul",
    "rms_norm",
    "column_vector_list_to_matrix",
    "matrix_to_column_vector_list",
]


def mul(a, b):
    """Matrix product on the trailing two axes at ``MATMUL_PRECISION``."""
    return jnp.matmul(a, b, precision=MATMUL_PRECISION)


def commutator(a, b):
    """[a, b] = ab - ba (batched over leading axes).

    Parity: reference convenience.py:16-29.
    """
    return mul(a, b) - mul(b, a)


def conjugate_transpose(matrix):
    """Conjugate transpose on the trailing two axes (batched).

    Parity: reference convenience.py:32-46.
    """
    return jnp.conjugate(jnp.swapaxes(matrix, -1, -2))


def krons(*matrices):
    """Kronecker product of all arguments, left to right.

    Parity: reference convenience.py:49-60.
    """
    return functools.reduce(jnp.kron, matrices)


def matmuls(*matrices):
    """Matrix product of all arguments, left to right.

    Parity: reference convenience.py:63-74.
    """
    return functools.reduce(mul, matrices)


def rms_norm(array):
    """Root-mean-square of the modulus of all entries.

    Parity: reference convenience.py:77-91. The sqrt is guarded with the
    double-where pattern so the reverse-mode derivative at an exactly-zero
    input is 0 rather than NaN (sqrt'(0) = inf would otherwise poison
    gradients through the RKDP5 error controller even on branches whose
    cotangent is zero).
    """
    square_norm = jnp.sum(jnp.real(array * jnp.conjugate(array)))
    mean_square = square_norm / array.size
    positive = mean_square > 0
    safe = jnp.where(positive, mean_square, 1.0)
    return jnp.where(positive, jnp.sqrt(safe), 0.0)


def column_vector_list_to_matrix(column_vector_list):
    """Stack of (d, 1) column vectors (K, d, 1) -> (d, K) matrix.

    The unitary <-> state-batch isomorphism used to pose gate synthesis as
    multi-state transfer. Parity: reference convenience.py:98-100.
    """
    return jnp.hstack(tuple(column_vector_list))


def matrix_to_column_vector_list(matrix):
    """(d, K) matrix -> stack of column vectors (K, d, 1).

    Parity: reference convenience.py:103-104.
    """
    return jnp.stack([matrix[:, i:i + 1] for i in range(matrix.shape[1])])


def one_norm(matrix):
    """Induced matrix 1-norm (max column sum of moduli), batched."""
    return jnp.max(jnp.sum(jnp.abs(matrix), axis=-2), axis=-1)
