"""Lindblad master-equation right-hand side.

Counterpart of /root/reference/qoc/core/mathmethods.py:169-206:
L(rho) = -i [H, rho] + sum_i g_i (L_i rho L_i^dag - 1/2 {L_i^dag L_i, rho}).

The reference loops over dissipation channels in Python; here the channel axis
is contracted with batched einsums so XLA fuses the whole superoperator
application, and the density batch axis batches the products. A vectorized
(column-stacked) superoperator builder is also provided so the Lindblad path
can reuse the Magnus + expm propagation machinery.
"""

import jax.numpy as jnp

from qoc_tpu.config import MATMUL_PRECISION
from qoc_tpu.ops.linalg import commutator, conjugate_transpose, mul

__all__ = ["get_lindbladian", "lindblad_superoperator"]


def get_lindbladian(densities, dissipators=None, hamiltonian=None,
                    operators=None):
    """Apply the Lindbladian to a batch of density matrices.

    Arguments:
    densities :: array (..., d, d) - density matrices (any leading batch).
    dissipators :: array (n_ops,) - dissipation rates g_i, or None.
    hamiltonian :: array (d, d) - Hamiltonian, or None.
    operators :: array (n_ops, d, d) - collapse operators L_i, or None.

    Parity: reference mathmethods.py:169-206 (channel loop replaced by einsum
    contractions over the operator axis).
    """
    if hamiltonian is not None:
        lindbladian = -1j * commutator(hamiltonian, densities)
    else:
        lindbladian = jnp.zeros_like(densities)

    if dissipators is not None and operators is not None:
        operators_dagger = conjugate_transpose(operators)
        # P = sum_i g_i L_i^dag L_i  (d, d)
        products = jnp.einsum(
            "n,nij,njk->ik", dissipators, operators_dagger, operators,
            precision=MATMUL_PRECISION,
        )
        # sum_i g_i L_i rho L_i^dag, batched over the density axes.
        jump = jnp.einsum(
            "n,nij,...jk,nkl->...il",
            dissipators, operators, densities, conjugate_transpose(operators),
            precision=MATMUL_PRECISION,
        )
        lindbladian = (
            lindbladian
            + jump
            - 0.5 * mul(products, densities)
            - 0.5 * mul(densities, products)
        )
    return lindbladian


def lindblad_superoperator(dissipators=None, hamiltonian=None, operators=None,
                           hilbert_size=None):
    """Column-stacking superoperator S with S @ vec(rho) = vec(L(rho)).

    Using vec(A X B) = (B^T kron A) vec(X) for column-major vec; this module
    uses row-major (C-order) ravel, for which vec(A X B) = (A kron B^T) vec(X).
    Enables propagating densities with expm(dt * S) through the same
    scaling-and-squaring expm as the Schrödinger path (an alternative the
    reference lacks; see SURVEY.md section 7).
    """
    if hilbert_size is None:
        if hamiltonian is not None:
            hilbert_size = hamiltonian.shape[-1]
        elif operators is not None:
            hilbert_size = operators.shape[-1]
        else:
            raise ValueError("Cannot infer hilbert_size.")
    d = hilbert_size
    eye = jnp.eye(d, dtype=jnp.complex64 if hamiltonian is None
                  else hamiltonian.dtype)

    s = jnp.zeros((d * d, d * d), dtype=eye.dtype)
    if hamiltonian is not None:
        h = hamiltonian
        # -i (H rho - rho H): row-major vec(H rho I) = H kron I^T, etc.
        s = s + (-1j) * (jnp.kron(h, eye) - jnp.kron(eye, h.T))
    if dissipators is not None and operators is not None:
        operators_dagger = conjugate_transpose(operators)
        for i in range(operators.shape[0]):
            g = dissipators[i]
            l_op = operators[i]
            ld = operators_dagger[i]
            p = mul(ld, l_op)
            s = s + g * (
                jnp.kron(l_op, jnp.conjugate(l_op))
                - 0.5 * jnp.kron(p, eye)
                - 0.5 * jnp.kron(eye, p.T)
            )
    return s
