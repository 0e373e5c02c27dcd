"""Adaptive Dormand-Prince RKDP5(4) integrator with dense output.

Counterpart of /root/reference/qoc/core/mathmethods.py:209-480:
same Butcher tableau, FSAL reuse, Hairer automatic initial step size, accept/
reject controller (safety 0.9, factors [0.2, 10]), and quartic dense output.
Two execution strategies replace the reference's Python while-loops:

- :func:`integrate_rkdp5` — ``lax.while_loop``; data-dependent trip count,
  fastest, forward-only (use for evolution / inference).
- :func:`integrate_rkdp5_scan` — bounded ``lax.scan`` with a done-flag and
  ``lax.cond`` no-op guard; reverse-mode differentiable, so GRAPE gradients
  are the exact discretize-then-optimize gradients of the adaptive scheme
  (including the step-size controller), matching the reference's
  autograd-taped semantics.

State ``y`` may have any shape (the Lindblad path integrates a batch of
density matrices (K, d, d)).
"""

import jax.numpy as jnp
from jax import lax

from qoc_tpu.ops.linalg import rms_norm


def _promote_carry_vma(carry, f0):
    """Promote every adaptive-carry leaf to the varying-axis type of the RHS
    output ``f0``.

    The adaptive carry mixes leaves derived from the (member-varying) state
    with internally-created constants (the output buffer, the time cursor,
    the rejected flag); under ``shard_map(..., check_vma=True)`` the
    ``lax.cond`` joins inside the stepper need both branches at the same
    varying-axis type. Adding a varying scalar zero promotes by construction
    at any trace level (a direct ``pcast`` is brittle under ``vmap``, where
    the leaf's visible aval hides its varying axes)."""
    zero = jnp.real(jnp.sum(f0)) * 0
    return tuple((leaf | (zero > 0)) if leaf.dtype == jnp.bool_
                 else leaf + zero.astype(leaf.dtype)
                 for leaf in carry)

__all__ = ["integrate_rkdp5", "integrate_rkdp5_scan", "integrate_rkdp5_step",
           "rkdp5_dense"]

# Butcher tableau, Hairer-Norsett-Wanner table 5.2 (same constants as
# reference mathmethods.py:209-247).
_C2, _C3, _C4, _C5 = 1 / 5, 3 / 10, 4 / 5, 8 / 9
_A21 = 1 / 5
_A31, _A32 = 3 / 40, 9 / 40
_A41, _A42, _A43 = 44 / 45, -56 / 15, 32 / 9
_A51, _A52, _A53, _A54 = 19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729
_A61, _A62, _A63, _A64, _A65 = (9017 / 3168, -355 / 33, 46732 / 5247,
                                49 / 176, -5103 / 18656)
_B1, _B3, _B4, _B5, _B6 = 35 / 384, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84
_B1H, _B3H, _B4H, _B5H, _B6H, _B7H = (5179 / 57600, 7571 / 16695, 393 / 640,
                                      -92097 / 339200, 187 / 2100, 1 / 40)
# Dense-output coefficients (reference mathmethods.py:249-255).
_D1 = -12715105075 / 11282082432
_D3 = 87487479700 / 32700410799
_D4 = -10690763975 / 1880347072
_D5 = 701980252875 / 199316789632
_D6 = -1453857185 / 822651844
_D7 = 69997945 / 29380423
_ORDER = 5
_ERROR_EXP = -1 / 5  # -1/(min(p, p_hat) + 1)


def integrate_rkdp5_step(h, rhs, x0, y0, k1=None):
    """One RKDP5(4) step. Returns (ks, y1 (5th order), y1h (4th order)).

    Parity: reference mathmethods.py:307-349 (FSAL: pass ``k1`` = previous k7).
    """
    if k1 is None:
        k1 = rhs(x0, y0)
    k2 = rhs(x0 + _C2 * h, y0 + h * (_A21 * k1))
    k3 = rhs(x0 + _C3 * h, y0 + h * (_A31 * k1 + _A32 * k2))
    k4 = rhs(x0 + _C4 * h, y0 + h * (_A41 * k1 + _A42 * k2 + _A43 * k3))
    k5 = rhs(x0 + _C5 * h, y0 + h * (_A51 * k1 + _A52 * k2 + _A53 * k3
                                     + _A54 * k4))
    k6 = rhs(x0 + h, y0 + h * (_A61 * k1 + _A62 * k2 + _A63 * k3
                               + _A64 * k4 + _A65 * k5))
    y1 = y0 + h * (_B1 * k1 + _B3 * k3 + _B4 * k4 + _B5 * k5 + _B6 * k6)
    k7 = rhs(x0 + h, y1)
    y1h = y0 + h * (_B1H * k1 + _B3H * k3 + _B4H * k4 + _B5H * k5
                    + _B6H * k6 + _B7H * k7)
    return (k1, k2, k3, k4, k5, k6, k7), y1, y1h


def rkdp5_dense(ks, x0, x1, x_eval, y0, y1):
    """Quartic dense-output interpolation of one step onto ``x_eval`` points.

    ``x_eval`` :: array (n_eval,); returns shape (n_eval, *y0.shape).
    Parity: reference mathmethods.py:263-304.
    """
    h = x1 - x0
    r1 = y0
    r2 = y1 - y0
    r3 = y0 + h * ks[0] - y1
    r4 = 2 * (y1 - y0) - h * (ks[0] + ks[6])
    r5 = h * (_D1 * ks[0] + _D3 * ks[2] + _D4 * ks[3] + _D5 * ks[4]
              + _D6 * ks[5] + _D7 * ks[6])
    theta = (x_eval - x0) / h
    # Broadcast theta (n_eval,) against y-shaped residuals.
    extra = (1,) * y0.ndim
    theta = theta.reshape(theta.shape + extra)
    theta2 = theta ** 2
    theta3 = theta ** 3
    theta4 = theta2 ** 2
    return (r1
            + theta * (r2 + r3)
            - theta2 * (r3 - r4 - r5)
            - theta3 * (r4 + 2 * r5)
            + theta4 * r5)


def _initial_step(rhs, x_initial, y_initial):
    """Hairer's automatic initial step size (reference mathmethods.py:405-420).

    Returns (h_first, f0) where f0 = rhs(x_initial, y_initial) is reused as k1.
    """
    f0 = rhs(x_initial, y_initial)
    d0 = rms_norm(y_initial)
    d1 = rms_norm(f0)
    tiny = jnp.finfo(d1.dtype).tiny
    h0 = jnp.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6,
                   0.01 * d0 / jnp.maximum(d1, tiny))
    y1 = y_initial + h0 * f0
    f1 = rhs(x_initial + h0, y1)
    d2 = rms_norm(f1 - f0) / h0
    dmax = jnp.maximum(d1, d2)
    h1 = jnp.where(
        dmax <= 1e-15,
        jnp.maximum(1e-6, h0 * 1e-3),
        jnp.power(0.01 / jnp.where(dmax <= 1e-15, 1.0, dmax), 1 / (_ORDER + 1)),
    )
    # Detach the automatic initial step from the gradient (mesh quantities
    # are treated as constants of the realized discretization; see _attempt).
    return lax.stop_gradient(jnp.minimum(100 * h0, h1)), f0


def _safe_abs(y):
    """|y| with a zero (not NaN) reverse-mode derivative at y == 0."""
    mag2 = jnp.real(y * jnp.conjugate(y))
    positive = mag2 > 0
    safe = jnp.where(positive, mag2, 1.0)
    return jnp.where(positive, jnp.sqrt(safe), 0.0)


def _controller_factors(error_norm, step_rejected, safety, fac_max, fac_min):
    """Step-size multipliers for the accepted and rejected branches."""
    # NaN-safe power: guard the error_norm == 0 lane before the pow.
    err_safe = jnp.where(error_norm > 0, error_norm, 1.0)
    powed = safety * jnp.power(err_safe, _ERROR_EXP)
    fac_accept = jnp.where(error_norm > 0,
                           jnp.minimum(fac_max, powed), fac_max)
    # After a rejection, do not let the next step grow (reference :455-457).
    fac_accept = jnp.where(step_rejected, jnp.minimum(1.0, fac_accept),
                           fac_accept)
    fac_reject = jnp.maximum(fac_min, powed)
    return fac_accept, fac_reject


def _attempt(rhs, x, y, k1, h, step_rejected, atol, rtol, safety, fac_max,
             fac_min):
    """One accept/reject attempt. Returns (accept, ks, y1, x_new, h_next)."""
    ks, y1, y1h = integrate_rkdp5_step(h, rhs, x, y, k1=k1)
    x_new = x + h
    if isinstance(rtol, (int, float)) and rtol == 0:
        # Static fast path: skips |y| whose derivative at exact zeros is NaN
        # (0 cotangent x inf derivative still poisons reverse mode).
        scale = atol
    else:
        scale = atol + jnp.maximum(_safe_abs(y1), _safe_abs(y1h)) * rtol
    # The step-size controller is detached from the gradient: differentiating
    # through the h-update chain (thousands of coupled power-law factors)
    # explodes reverse-mode gradients, while the gradient of the solution on
    # the *realized* mesh is the exact discretize-then-optimize adjoint of
    # the scheme that actually ran (same convention as diffrax).
    error_norm = lax.stop_gradient(rms_norm((y1 - y1h) / scale))
    accept = error_norm < 1
    fac_accept, fac_reject = _controller_factors(error_norm, step_rejected,
                                                 safety, fac_max, fac_min)
    h_next = lax.stop_gradient(h * jnp.where(accept, fac_accept, fac_reject))
    return accept, ks, y1, x_new, h_next


def _collect(out, x, x_new, x_eval, ks, y, y1):
    """Fill dense outputs for eval points inside (x, x_new] (inclusive left,
    matching reference :467-469)."""
    mask = (x <= x_eval) & (x_eval <= x_new)
    dense = rkdp5_dense(ks, x, x_new, x_eval, y, y1)
    extra = (1,) * y.ndim
    return jnp.where(mask.reshape(mask.shape + extra), dense, out)


def integrate_rkdp5(rhs, x_eval, x_initial, y_initial, atol=1e-12, rtol=0.0,
                    step_safety_factor=0.9, step_update_factor_max=10.0,
                    step_update_factor_min=2e-1, pvary_axes=None):
    """Adaptive RKDP5(4) via ``lax.while_loop`` (forward-only).

    Arguments match the reference (mathmethods.py:352-480): ``x_eval`` is a
    sorted array of output abscissae (> x_initial), integration runs until the
    last accepted step covers ``x_eval[-1]``; outputs are quartic dense
    evaluations, shape (len(x_eval), *y_initial.shape).
    """
    x_eval = jnp.asarray(x_eval)
    x_final = x_eval[-1]
    h_first, f0 = _initial_step(rhs, x_initial, y_initial)
    out = jnp.zeros((x_eval.shape[0],) + y_initial.shape,
                    dtype=y_initial.dtype)

    def cond(carry):
        x, _, _, _, _, _ = carry
        return x <= x_final

    def body(carry):
        x, y, k1, h, rejected, out_ = carry
        accept, ks, y1, x_new, h_next = _attempt(
            rhs, x, y, k1, h, rejected, atol, rtol, step_safety_factor,
            step_update_factor_max, step_update_factor_min)
        out_ = lax.cond(
            accept,
            lambda: _collect(out_, x, x_new, x_eval, ks, y, y1),
            lambda: out_)
        x = jnp.where(accept, x_new, x)
        y = jnp.where(accept, y1, y)
        k1 = jnp.where(accept, ks[6], k1)
        rejected = ~accept
        return x, y, k1, h_next, rejected, out_

    carry = (jnp.asarray(x_initial, dtype=jnp.result_type(x_eval)),
             y_initial, f0, h_first, jnp.bool_(False), out)
    if pvary_axes:
        carry = _promote_carry_vma(carry, f0)
    _, _, _, _, _, out = lax.while_loop(cond, body, carry)
    return out


def integrate_rkdp5_scan(rhs, x_eval, x_initial, y_initial, atol=1e-12,
                         rtol=0.0, step_safety_factor=0.9,
                         step_update_factor_max=10.0,
                         step_update_factor_min=2e-1, max_steps=16384,
                         pvary_axes=None):
    """Adaptive RKDP5(4) as a bounded masked ``lax.scan`` (differentiable).

    Semantically identical to :func:`integrate_rkdp5` provided the adaptive
    loop finishes within ``max_steps`` attempts; iterations after completion
    are ``lax.cond``-guarded no-ops (a skipped branch in the lowered HLO
    conditional, so early convergence costs nothing). Reverse-mode
    differentiable, used by the Lindblad GRAPE path.

    If the loop does NOT reach ``x_eval[-1]`` within ``max_steps`` attempts,
    the result is filled with NaN so the failure is visible — raise
    ``max_steps`` (cost per attempt: 6 fresh RHS evaluations). At the default
    ``atol=1e-12`` an interval of length L with dynamics of scale ||L(t)||~1
    needs on the order of 150*L accepted steps.
    """
    x_eval = jnp.asarray(x_eval)
    x_final = x_eval[-1]
    h_first, f0 = _initial_step(rhs, x_initial, y_initial)
    out = jnp.zeros((x_eval.shape[0],) + y_initial.shape,
                    dtype=y_initial.dtype)

    def step(carry, _):
        x, y, k1, h, rejected, out_ = carry

        def do_step(args):
            x, y, k1, h, rejected, out_ = args
            accept, ks, y1, x_new, h_next = _attempt(
                rhs, x, y, k1, h, rejected, atol, rtol, step_safety_factor,
                step_update_factor_max, step_update_factor_min)
            out_ = lax.cond(
                accept,
                lambda: _collect(out_, x, x_new, x_eval, ks, y, y1),
                lambda: out_)
            x = jnp.where(accept, x_new, x)
            y = jnp.where(accept, y1, y)
            k1 = jnp.where(accept, ks[6], k1)
            return x, y, k1, h_next, ~accept, out_

        carry = lax.cond(x <= x_final, do_step, lambda args: args,
                         (x, y, k1, h, rejected, out_))
        return carry, None

    carry = (jnp.asarray(x_initial, dtype=jnp.result_type(x_eval)),
             y_initial, f0, h_first, jnp.bool_(False), out)
    if pvary_axes:
        carry = _promote_carry_vma(carry, f0)
    carry, _ = lax.scan(step, carry, None, length=max_steps)
    x_end, out = carry[0], carry[5]
    converged = x_end > x_final
    return jnp.where(converged, out, jnp.nan)
