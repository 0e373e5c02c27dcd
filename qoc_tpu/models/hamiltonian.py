"""Structured Hamiltonians.

The reference accepts an arbitrary Python callable ``hamiltonian(controls,
time)`` (qoc/core/schroedingerdiscrete.py:43-45), which qoc_tpu supports
unchanged (any jax-traceable callable). ``LinearHamiltonian`` additionally
declares the ubiquitous *linear control* structure

    H(c, t) = H0 + Σᵢ cᵢ Aᵢ + conj(cᵢ) Aᵢ^H

as data. It remains a plain callable with the standard contract, so every
driver accepts it, and it exposes the structure itself (Hermitian,
generator and superoperator bases) for code that exploits linearity.
"""

import numpy as np

import jax.numpy as jnp

from qoc_tpu.config import MATMUL_PRECISION, as_complex

__all__ = ["ConstantLindblad", "EnsembleLinearHamiltonian",
           "LinearHamiltonian"]


class LinearHamiltonian:
    """H(c, t) = h0 + Σᵢ cᵢ operatorsᵢ + conj(cᵢ) operatorsᵢ^H.

    Arguments:
    h0 :: numpy (d, d) - the static (drift) Hamiltonian; must be Hermitian
        for the evolution to be unitary (not enforced).
    operators :: numpy (control_count, d, d) - one drive operator per
        control channel. A Hermitian drive with a real control is the
        special case operators[i] = H_i / 2 (since H/2 + H^H/2 = H).

    The instance is callable with the reference contract
    ``(controls, time) -> (d, d)`` and is time-independent by construction.
    """

    def __init__(self, h0, operators):
        self.h0 = np.asarray(h0)
        self.operators = np.asarray(operators)
        if self.operators.ndim != 3:
            raise ValueError("operators must have shape "
                             "(control_count, d, d); got {}."
                             .format(self.operators.shape))
        if self.h0.shape != self.operators.shape[1:]:
            raise ValueError("h0 {} and operators {} dimension mismatch."
                             .format(self.h0.shape, self.operators.shape))

    @property
    def control_count(self):
        return self.operators.shape[0]

    def __call__(self, controls, time):
        h0 = as_complex(self.h0)
        if controls is None:
            return jnp.asarray(h0)
        ops = as_complex(self.operators)
        drive = jnp.einsum("...i,iab->...ab", as_complex(controls),
                           jnp.asarray(ops), precision=MATMUL_PRECISION)
        return h0 + drive + jnp.conjugate(jnp.swapaxes(drive, -1, -2))

    def hermitian_basis(self):
        """Real-coefficient Hermitian basis [h0, P_1, Q_1, ..., P_n, Q_n]
        with P = A + A^H, Q = i(A - A^H), so that
        H = 1·h0 + Σᵢ Re(cᵢ)·Pᵢ + Im(cᵢ)·Qᵢ  (numpy (1+2n, d, d))."""
        parts = [self.h0]
        for a in self.operators:
            ah = np.conjugate(a.T)
            parts.append(a + ah)
            parts.append(1j * (a - ah))
        return np.stack(parts)

    def generator_basis(self, dt):
        """Magnus-M2 generator basis G_k = -i·dt·basis_k (numpy complex):
        A_step = Σ_k W_k G_k with W = [1, Re c_1, Im c_1, ...] evaluated at
        the step midpoint."""
        return -1j * dt * self.hermitian_basis()

    def superoperator_basis(self, dt, dissipators=None, operators=None):
        """Magnus-M2 Lindblad-superoperator generator basis (numpy complex
        (1+2n, d², d²)): S_step = Σ_k W_k basis_k with the same weight
        layout, where S vec(ρ) = vec(L(ρ)) in row-major (C-order) vec
        convention — numerically identical to
        :func:`qoc_tpu.ops.lindblad.lindblad_superoperator`. The constant
        dissipator part folds into the k=0 term."""
        d = self.h0.shape[-1]
        eye = np.eye(d)

        def s_h(x):
            # -i (X rho - rho X) -> -i (X kron I - I kron X^T), row-major.
            return -1j * (np.kron(x, eye) - np.kron(eye, x.T))

        s0 = s_h(self.h0).astype(complex)
        if dissipators is not None and operators is not None:
            for g, l_op in zip(np.asarray(dissipators),
                               np.asarray(operators)):
                ld = np.conjugate(l_op.T)
                p = ld @ l_op
                s0 = s0 + g * (np.kron(l_op, np.conjugate(l_op))
                               - 0.5 * np.kron(p, eye)
                               - 0.5 * np.kron(eye, p.T))
        parts = [s0]
        for a in self.operators:
            ah = np.conjugate(a.T)
            parts.append(s_h(a + ah))
            parts.append(s_h(1j * (a - ah)))
        return dt * np.stack(parts)


class EnsembleLinearHamiltonian(LinearHamiltonian):
    """Affine ensemble of linear Hamiltonians (robust-GRAPE structure):

        H_m(c, t) = h0 + Σ_p δ_mp · param_operators[p]
                       + Σᵢ cᵢ operatorsᵢ + conj(cᵢ) operatorsᵢ^H

    where δ_m is member m's REAL parameter row (detuning, amplitude
    miscalibration, ...). ``param_operators`` must be Hermitian (they enter
    with real coefficients). The common case "(1+δ)·H0" is
    ``param_operators=[h0]``.

    The instance is callable with the ensemble contract
    ``(params_row, controls, time)`` of ``grape_schroedinger_ensemble`` and
    the robust multistart; its bases put the member parameters in extra
    weight columns beside the controls.
    """

    def __init__(self, h0, operators, param_operators):
        super().__init__(h0, operators)
        self.param_operators = np.asarray(param_operators)
        if self.param_operators.ndim != 3:
            raise ValueError("param_operators must have shape "
                             "(param_count, d, d); got {}."
                             .format(self.param_operators.shape))
        if self.param_operators.shape[1:] != self.h0.shape:
            raise ValueError("param_operators {} and h0 {} dimension "
                             "mismatch.".format(self.param_operators.shape,
                                                self.h0.shape))
        herm_err = np.abs(self.param_operators
                          - np.conjugate(np.swapaxes(self.param_operators,
                                                     -1, -2))).max()
        if herm_err > 1e-8:
            raise ValueError("param_operators must be Hermitian (they carry "
                             "real ensemble coefficients); max |P - P^H| = "
                             "{}.".format(herm_err))

    @property
    def param_count(self):
        return self.param_operators.shape[0]

    def __call__(self, params_row, controls, time):
        h = LinearHamiltonian.__call__(self, controls, time)
        pops = jnp.asarray(as_complex(self.param_operators))
        return h + jnp.einsum("p,pab->ab", as_complex(params_row), pops,
                              precision=MATMUL_PRECISION)

    def member(self, params_row):
        """Plain ``(controls, time) -> H`` callable for one member."""
        return lambda controls, time: self(params_row, controls, time)

    def hermitian_basis(self):
        """[h0, param_ops..., P_1, Q_1, ...] so that H_m = W_m · basis with
        W_m = [1, δ_m1..δ_mP, Re c_1, Im c_1, ...]."""
        base = LinearHamiltonian.hermitian_basis(self)
        return np.concatenate((base[:1], self.param_operators, base[1:]),
                              axis=0)

    def superoperator_basis(self, dt, dissipators=None, operators=None):
        """Lindblad-superoperator basis with the member layout
        [s0(+dissipators), s(param_ops)..., s(P_i), s(Q_i)...] matching the
        ensemble weight rows [1, δ_m, Re c, Im c] — the Hamiltonian
        commutator map is linear, so each Hermitian param operator
        contributes its own -i[·,ρ] superoperator column (the dissipator
        part stays in the constant k=0 term, shared by all members)."""
        base = LinearHamiltonian.superoperator_basis(self, dt, dissipators,
                                                     operators)
        d = self.h0.shape[-1]
        eye = np.eye(d)
        param_cols = np.stack([
            -1j * dt * (np.kron(p, eye) - np.kron(eye, p.T))
            for p in self.param_operators])
        return np.concatenate((base[:1], param_cols.astype(base.dtype),
                               base[1:]), axis=0)


class ConstantLindblad:
    """Time-independent Lindblad data: callable with the reference contract
    ``(time) -> (dissipation_rates, operators)``
    (reference lindbladdiscrete.py:76-79) that declares constancy as
    structure (``LinearHamiltonian.superoperator_basis`` folds it into the
    constant term).

    Arguments:
    dissipators :: numpy (n_ops,) - rates g_i.
    operators :: numpy (n_ops, d, d) - collapse operators L_i.
    """

    def __init__(self, dissipators, operators):
        self.dissipators = (None if dissipators is None
                            else np.asarray(dissipators))
        self.operators = (None if operators is None
                          else np.asarray(operators))

    def __call__(self, time):
        return self.dissipators, self.operators
