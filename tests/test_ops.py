"""L0 ops tests: linalg conveniences, expm (vs scipy), interpolation, Magnus,
Lindbladian, RKDP5 (vs closed forms and scipy.solve_ivp).

Mirrors the reference test strategy (SURVEY.md §4): scipy as the numerical
oracle, analytic closed forms, property round trips, and gradient checks via
finite differences.
"""

import numpy as np
import pytest
import scipy.linalg as sla
from scipy.integrate import solve_ivp

import jax
import jax.numpy as jnp

from qoc_tpu.ops import (
    commutator,
    conjugate_transpose,
    column_vector_list_to_matrix,
    expm,
    expm_eigh,
    expm_frechet,
    expm_pade,
    get_lindbladian,
    integrate_rkdp5,
    integrate_rkdp5_scan,
    interpolate_linear_set,
    krons,
    lindblad_superoperator,
    magnus_m2,
    magnus_m4,
    magnus_m6,
    matmuls,
    matrix_to_column_vector_list,
    rms_norm,
)

RNG = np.random.default_rng(42)


def _random_complex(shape, scale=1.0):
    return scale * (RNG.normal(size=shape) + 1j * RNG.normal(size=shape))


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------

def test_conjugate_transpose_and_commutator():
    a = _random_complex((3, 4, 4))
    b = _random_complex((3, 4, 4))
    assert np.allclose(conjugate_transpose(jnp.asarray(a)),
                       np.conjugate(np.swapaxes(a, -1, -2)))
    assert np.allclose(commutator(jnp.asarray(a), jnp.asarray(b)),
                       a @ b - b @ a)


def test_krons_matmuls():
    a, b, c = (_random_complex((2, 2)) for _ in range(3))
    assert np.allclose(krons(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)),
                       np.kron(np.kron(a, b), c))
    assert np.allclose(matmuls(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(c)), a @ b @ c)


def test_rms_norm():
    a = _random_complex((5, 3))
    expected = np.sqrt(np.sum(np.abs(a) ** 2) / a.size)
    assert np.allclose(rms_norm(jnp.asarray(a)), expected)


def test_rms_norm_zero_gradient_safe():
    g = jax.grad(lambda x: rms_norm(x))(jnp.zeros(4))
    assert np.all(np.isfinite(np.asarray(g)))


def test_state_matrix_isomorphism_roundtrip():
    states = _random_complex((4, 3, 1))
    matrix = column_vector_list_to_matrix(jnp.asarray(states))
    assert matrix.shape == (3, 4)
    back = matrix_to_column_vector_list(matrix)
    assert np.allclose(back, states)


# ---------------------------------------------------------------------------
# expm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4, 16, 48])
def test_expm_matches_scipy(d):
    a = _random_complex((d, d), scale=2.0)
    got = np.asarray(expm(jnp.asarray(a)))
    ref = sla.expm(a)
    assert np.allclose(got, ref, atol=1e-9 * np.abs(ref).max())


def test_expm_batched():
    a = _random_complex((3, 2, 5, 5), scale=3.0)
    got = np.asarray(expm(jnp.asarray(a)))
    for i in range(3):
        for j in range(2):
            assert np.allclose(got[i, j], sla.expm(a[i, j]), atol=1e-8)


def test_expm_large_norm_requires_squaring():
    a = _random_complex((6, 6), scale=40.0)
    ref = sla.expm(a)
    got = np.asarray(expm(jnp.asarray(a)))
    assert np.allclose(got, ref, rtol=1e-8, atol=1e-8 * np.abs(ref).max())


def test_expm_skew_hermitian_unitary():
    h = _random_complex((8, 8))
    h = h + h.conj().T
    u = np.asarray(expm(jnp.asarray(-1j * h)))
    assert np.allclose(u @ u.conj().T, np.eye(8), atol=1e-10)


def test_expm_eigh_matches_scipy():
    h = _random_complex((6, 6))
    h = h + h.conj().T
    assert np.allclose(expm_eigh(jnp.asarray(h)), sla.expm(-1j * h),
                       atol=1e-10)


def test_expm_gradient_custom_vjp_matches_ad_through_pade():
    a = jnp.asarray(_random_complex((5, 5)))

    def loss_custom(x):
        return jnp.real(jnp.sum(jnp.abs(expm(x)) ** 2))

    def loss_pade(x):
        return jnp.real(jnp.sum(jnp.abs(expm_pade(x)) ** 2))

    g1 = jax.grad(loss_custom)(a)
    g2 = jax.grad(loss_pade)(a)
    assert np.allclose(np.asarray(g1), np.asarray(g2), atol=1e-9)


def test_expm_gradient_finite_difference():
    a = jnp.asarray(_random_complex((4, 4)))
    target = jnp.asarray(_random_complex((4, 4)))

    def loss(x):
        return jnp.real(jnp.sum(jnp.abs(expm(x) - target) ** 2))

    g = np.asarray(jax.grad(loss)(a))
    eps = 1e-7
    base = float(loss(a))
    fd_re = (float(loss(a.at[1, 2].add(eps))) - base) / eps
    fd_im = (float(loss(a.at[1, 2].add(1j * eps))) - base) / eps
    # jax.grad of a real loss returns du/dx - i du/dy.
    assert abs(np.real(g[1, 2]) - fd_re) < 1e-5
    assert abs(-np.imag(g[1, 2]) - fd_im) < 1e-5


def test_expm_gradient_diagonal_analytic():
    # Gradient check against the analytic Jacobian of expm on diagonal input
    # (reference test_standard.py:228-247, which is broken there).
    x = jnp.asarray(np.diag([0.3, -0.7, 1.1]))

    def loss(a):
        return jnp.sum(jnp.diagonal(expm(a)))

    g = np.asarray(jax.grad(loss)(x))
    assert np.allclose(np.diag(g), np.exp(np.array([0.3, -0.7, 1.1])),
                       atol=1e-9)


def test_expm_frechet_matches_scipy():
    a = _random_complex((5, 5))
    e = _random_complex((5, 5))
    got = np.asarray(expm_frechet(jnp.asarray(a), jnp.asarray(e)))
    eps = 1e-7
    fd = (sla.expm(a + eps * e) - sla.expm(a - eps * e)) / (2 * eps)
    assert np.allclose(got, fd, atol=1e-5)


def test_expm_under_jit_vmap_scan():
    a = jnp.asarray(_random_complex((4, 3, 3), scale=5.0))
    got = jax.jit(jax.vmap(expm))(a)
    for i in range(4):
        assert np.allclose(np.asarray(got[i]), sla.expm(np.asarray(a[i])),
                           atol=1e-8)


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------

def test_interpolate_reproduces_lines():
    xs = jnp.asarray(np.sort(RNG.uniform(0, 10, size=7)))
    slope, intercept = 2.5, -1.0
    ys = slope * xs + intercept
    for x in [-5.0, 0.0, 3.3, 9.99, 15.0]:
        got = float(interpolate_linear_set(jnp.asarray(x), xs, ys))
        assert abs(got - (slope * x + intercept)) < 1e-10


def test_interpolate_matches_numpy_interior():
    xs = np.sort(RNG.uniform(0, 1, size=9))
    ys = RNG.normal(size=(9, 3))
    for x in RNG.uniform(xs[0], xs[-1], size=10):
        got = np.asarray(interpolate_linear_set(jnp.asarray(x),
                                                jnp.asarray(xs),
                                                jnp.asarray(ys)))
        ref = np.stack([np.interp(x, xs, ys[:, i]) for i in range(3)])
        assert np.allclose(got, ref, atol=1e-12)


def test_interpolate_extrapolates_from_boundary_pairs():
    xs = jnp.asarray([0.0, 1.0, 3.0])
    ys = jnp.asarray([0.0, 2.0, 4.0])
    # Below: line through first two points (slope 2).
    assert np.isclose(float(interpolate_linear_set(-1.0, xs, ys)), -2.0)
    # Above: line through last two points (slope 1).
    assert np.isclose(float(interpolate_linear_set(4.0, xs, ys)), 5.0)


# ---------------------------------------------------------------------------
# magnus
# ---------------------------------------------------------------------------

def test_magnus_constant_generator_reduces_to_dt_a():
    m = jnp.asarray(_random_complex((4, 4)))
    a = lambda t: m
    dt = 0.37
    for fn in (magnus_m2, magnus_m4, magnus_m6):
        assert np.allclose(np.asarray(fn(a, dt, 1.2)), dt * np.asarray(m),
                           atol=1e-12)


def test_magnus_orders_converge():
    # For a time-dependent generator, higher Magnus orders should better
    # approximate the exact time-ordered propagator as dt^order.
    h0 = np.diag([1.0, -1.0])
    v = np.array([[0, 1], [1, 0]], dtype=complex)

    def a_np(t):
        return -1j * (h0 + np.cos(3 * t) * v)

    def a_jax(t):
        return jnp.asarray(-1j) * (jnp.asarray(h0)
                                   + jnp.cos(3 * t) * jnp.asarray(v))

    def exact_u(t0, dt):
        sol = solve_ivp(
            lambda t, y: (a_np(t) @ y.reshape(2, 2)).ravel(),
            (t0, t0 + dt), np.eye(2, dtype=complex).ravel(),
            rtol=1e-12, atol=1e-14)
        return sol.y[:, -1].reshape(2, 2)

    dt = 0.1
    u_exact = exact_u(0.0, dt)
    errors = []
    for fn in (magnus_m2, magnus_m4, magnus_m6):
        u = np.asarray(expm(fn(a_jax, dt, 0.0)))
        errors.append(np.abs(u - u_exact).max())
    assert errors[0] > errors[1] > errors[2]
    assert errors[2] < 1e-9


# ---------------------------------------------------------------------------
# lindbladian
# ---------------------------------------------------------------------------

def _manual_lindbladian(rho, gammas, h, ops):
    out = np.zeros_like(rho)
    if h is not None:
        out = out + -1j * (h @ rho - rho @ h)
    if ops is not None:
        for g, l_op in zip(gammas, ops):
            ld = l_op.conj().T
            p = ld @ l_op
            out = out + g * (l_op @ rho @ ld - 0.5 * p @ rho
                             - 0.5 * rho @ p)
    return out


def test_get_lindbladian_matches_manual():
    d, n_ops, k = 4, 3, 2
    rho = _random_complex((k, d, d))
    h = _random_complex((d, d))
    h = h + h.conj().T
    ops = _random_complex((n_ops, d, d))
    gammas = np.abs(RNG.normal(size=n_ops))
    got = np.asarray(get_lindbladian(jnp.asarray(rho), jnp.asarray(gammas),
                                     jnp.asarray(h), jnp.asarray(ops)))
    for i in range(k):
        ref = _manual_lindbladian(rho[i], gammas, h, ops)
        assert np.allclose(got[i], ref, atol=1e-10)


def test_get_lindbladian_hamiltonian_only():
    rho = _random_complex((2, 3, 3))
    h = _random_complex((3, 3))
    got = np.asarray(get_lindbladian(jnp.asarray(rho), hamiltonian=jnp.asarray(h)))
    for i in range(2):
        assert np.allclose(got[i], -1j * (h @ rho[i] - rho[i] @ h),
                           atol=1e-12)


def test_lindblad_superoperator_consistent_with_rhs():
    d = 3
    rho = _random_complex((d, d))
    h = _random_complex((d, d))
    h = h + h.conj().T
    ops = _random_complex((2, d, d))
    gammas = np.array([0.3, 0.7])
    s = np.asarray(lindblad_superoperator(jnp.asarray(gammas),
                                          jnp.asarray(h), jnp.asarray(ops)))
    direct = _manual_lindbladian(rho, gammas, h, ops)
    via_super = (s @ rho.reshape(-1)).reshape(d, d)
    assert np.allclose(via_super, direct, atol=1e-10)


# ---------------------------------------------------------------------------
# rkdp5
# ---------------------------------------------------------------------------

def test_rkdp5_exact_linear_ode():
    # y' = -k y, exact solution e^{-kt} (reference test_rkdp5,
    # test_core.py:367-393 uses an analogous first-order ODE).
    k = 0.7

    def rhs(t, y):
        return -k * y

    y0 = jnp.asarray([1.0 + 0j])
    for integrate in (integrate_rkdp5,
                      lambda *a, **kw: integrate_rkdp5_scan(*a, **kw)):
        got = np.asarray(integrate(rhs, jnp.asarray([2.0]), 0.0, y0))
        assert np.allclose(got[0, 0], np.exp(-k * 2.0), atol=1e-9)


def test_rkdp5_dense_output_multiple_points():
    def rhs(t, y):
        return jnp.cos(t) * y

    y0 = jnp.asarray([1.0])
    x_eval = jnp.asarray([0.5, 1.0, 1.5, 2.0])
    got = np.asarray(integrate_rkdp5(rhs, x_eval, 0.0, y0))
    expected = np.exp(np.sin(np.asarray(x_eval)))
    assert np.allclose(got[:, 0], expected, atol=1e-8)


def test_rkdp5_scan_matches_while():
    def rhs(t, y):
        return -0.3 * y + 0.1 * jnp.sin(t)

    y0 = jnp.asarray([0.5, -0.2])
    a = np.asarray(integrate_rkdp5(rhs, jnp.asarray([3.0]), 0.0, y0))
    b = np.asarray(integrate_rkdp5_scan(rhs, jnp.asarray([3.0]), 0.0, y0))
    assert np.allclose(a, b, atol=1e-12)


def test_rkdp5_scan_unconverged_poisons_with_nan():
    def rhs(t, y):
        return -y

    y0 = jnp.asarray([1.0])
    got = np.asarray(integrate_rkdp5_scan(rhs, jnp.asarray([100.0]), 0.0, y0,
                                          max_steps=3))
    assert np.all(np.isnan(got))


def test_rkdp5_scan_gradient_finite_difference():
    def loss(c):
        def rhs(t, y):
            return -1j * c * y
        y0 = jnp.asarray([1.0 + 0j])
        yt = integrate_rkdp5_scan(rhs, jnp.asarray([1.0]), 0.0, y0,
                                  max_steps=512)[0, 0]
        return jnp.abs(yt - jnp.exp(-1j * 0.5)) ** 2

    g = float(jax.grad(loss)(0.3))
    eps = 1e-6
    fd = (float(loss(0.3 + eps)) - float(loss(0.3 - eps))) / (2 * eps)
    assert abs(g - fd) < 1e-5


def test_rkdp5_matches_solve_ivp_oscillator():
    # Lindblad-shaped matrix ODE vs scipy's adaptive integrator.
    h = np.array([[1.0, 0.5], [0.5, -1.0]], dtype=complex)
    rho0 = np.array([[0.7, 0.2 - 0.1j], [0.2 + 0.1j, 0.3]], dtype=complex)

    def rhs_jax(t, rho):
        hj = jnp.asarray(h)
        return -1j * (hj @ rho - rho @ hj)

    got = np.asarray(integrate_rkdp5(rhs_jax, jnp.asarray([2.0]), 0.0,
                                     jnp.asarray(rho0)))[0]
    sol = solve_ivp(lambda t, y: (-1j * (h @ y.reshape(2, 2)
                                         - y.reshape(2, 2) @ h)).ravel(),
                    (0, 2.0), rho0.ravel(), rtol=1e-12, atol=1e-12)
    assert np.allclose(got, sol.y[:, -1].reshape(2, 2), atol=1e-8)


def test_frechet_dual_taylor_matches_block_identity():
    """The dual-number Taylor Fréchet (the XLA backward's squaring-regime
    branch since round 4) equals the block-identity evaluation to machine
    precision across norms, and the expm custom VJP (taylor forward forced)
    matches AD-through-Padé."""
    import jax
    import jax.numpy as jnp
    from qoc_tpu.ops.expm import (_frechet_dual_taylor, expm, expm_frechet,
                                  expm_pade, set_expm_forward)
    rng = np.random.default_rng(0)
    for d, scale in ((16, 5.0), (16, 0.1), (48, 12.0)):
        a = ((rng.normal(size=(2, d, d)) + 1j * rng.normal(size=(2, d, d)))
             * scale / np.sqrt(d))
        g = rng.normal(size=(2, d, d)) + 1j * rng.normal(size=(2, d, d))
        at = np.swapaxes(a, -1, -2)
        want = np.asarray(expm_frechet(jnp.asarray(at), jnp.asarray(g)))
        got = np.asarray(_frechet_dual_taylor(jnp.asarray(at),
                                              jnp.asarray(g)))
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-13

    a = (rng.normal(size=(8, 8)) + 1j * rng.normal(size=(8, 8))) * 2.0
    tgt = rng.normal(size=(8, 8)) + 1j * rng.normal(size=(8, 8))
    set_expm_forward("taylor")
    try:
        g1 = jax.grad(lambda x: jnp.real(jnp.vdot(tgt, expm(x[None])[0])))(
            jnp.asarray(a))
    finally:
        set_expm_forward("auto")
    g2 = jax.grad(lambda x: jnp.real(jnp.vdot(tgt, expm_pade(x[None])[0])))(
        jnp.asarray(a))
    assert float(jnp.abs(g1 - g2).max() / jnp.abs(g2).max()) < 1e-12


# ---------------------------------------------------------------------------
# ans_jacobian (reference qoc/standard/utils/autogradutil.py:10-31)
# ---------------------------------------------------------------------------

def test_ans_jacobian_scalar_and_array_outputs():
    from qoc_tpu.gradutil import ans_jacobian

    # Scalar output: one value_and_grad pass.
    f = lambda x: jnp.sum(x ** 2)
    x = jnp.asarray([1.0, 2.0, 3.0])
    value, grad = ans_jacobian(f)(x)
    assert np.isclose(float(value), 14.0)
    assert np.allclose(np.asarray(grad), 2 * np.asarray(x))

    # Array output: full Jacobian, checked against the analytic one of
    # g(x) = [x0*x1, x1^2] -> J = [[x1, x0], [0, 2*x1]].
    g = lambda x: jnp.stack([x[0] * x[1], x[1] ** 2])
    xv = jnp.asarray([2.0, 5.0])
    value, jac = ans_jacobian(g)(xv)
    assert np.allclose(np.asarray(value), [10.0, 25.0])
    assert np.allclose(np.asarray(jac), [[5.0, 2.0], [0.0, 10.0]])

    # argnum selects the differentiated argument.
    h = lambda a, b: jnp.sum(a * b)
    _, db = ans_jacobian(h, argnum=1)(jnp.asarray([1.0, 2.0]),
                                      jnp.asarray([3.0, 4.0]))
    assert np.allclose(np.asarray(db), [1.0, 2.0])


def test_set_expm_forward_offers_only_the_xla_approximants():
    from qoc_tpu.ops.expm import _EXPM_FORWARD, set_expm_forward
    for impl in ("pallas", "triton"):
        with pytest.raises(ValueError, match="Unknown expm forward"):
            set_expm_forward(impl)
    assert _EXPM_FORWARD["impl"] == "auto"
