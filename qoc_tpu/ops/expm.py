"""Matrix exponential: scaling and squaring (Padé-13 or Taylor) with an
exact Fréchet-derivative adjoint.

This is the hot kernel of GRAPE propagation. The reference implementation
(/root/reference/qoc/standard/functions/expm.py:83-276) is a Higham-2005
scaling-and-squaring Padé evaluated in numpy and differentiated by tracing
autograd through the algorithm, which the reference's own report identifies as
its dominant cost (backward of expm at d=2^7: 313 s vs 0.039 s for a plain
matmul — report/report/report.tex:245-255). This rebuild differs
structurally:

- fixed Padé order 13 for all inputs (order dispatch would be a ``lax.switch``
  over matrix chains; at order 13 the extra matmuls are cheap batched work and
  the approximant is accurate for every post-scaling norm, avoiding the
  reference's
  order-selection control flow and its ``pade9`` crash bug, expm.py:147),
- data-dependent squaring count executed as a masked ``lax.while_loop`` so
  batched inputs each square exactly as often as their norm requires,
- gradients via ``jax.custom_vjp``: the cotangent is the exact Fréchet
  derivative L(Aᵀ, Ḡ), evaluated with the [[Aᵀ, Ḡ], [0, Aᵀ]] block-matrix
  identity (one 2d×2d expm) — no differentiation through the squaring chain,
  no O(pade-terms) residual tape. This is the "exact gradients, not the
  commuting approximation" requirement of report.tex:230-237.

All entry points are batched over arbitrary leading axes and jit/vmap/scan
safe.
"""

import math

import jax
import jax.numpy as jnp
from jax import lax

from qoc_tpu.ops.linalg import conjugate_transpose, mul, one_norm

__all__ = ["expm", "expm_pade", "expm_taylor", "expm_eigh",
           "expm_frechet", "set_expm_forward"]

# Padé-13 numerator coefficients b_0..b_13 (Higham 2005, Table 10.4; also used
# by scipy.linalg.expm). The denominator shares them with alternating signs.
_B = (
    64764752532480000.0,
    32382376266240000.0,
    7771770303897600.0,
    1187353796428800.0,
    129060195264000.0,
    10559470521600.0,
    670442572800.0,
    33522128640.0,
    1323241920.0,
    40840800.0,
    960960.0,
    16380.0,
    182.0,
    1.0,
)

# theta_13: largest 1-norm for which the order-13 approximant meets double
# rounding error (Higham 2005 Table 2.3; reference expm.py:206).
_THETA_13 = 5.371920351148152

# Hard cap on squarings: 2^-60 scaling puts any representable norm far below
# theta_13; the while_loop exits earlier for all practical inputs.
_MAX_SQUARINGS = 60


def _pade13_uv(a):
    """Odd/even polynomial halves (U, V) of the order-13 Padé approximant."""
    d = a.shape[-1]
    eye = jnp.eye(d, dtype=a.dtype)
    eye = jnp.broadcast_to(eye, a.shape)
    a2 = mul(a, a)
    a4 = mul(a2, a2)
    a6 = mul(a2, a4)
    u = mul(
        a,
        mul(a6, _B[13] * a6 + _B[11] * a4 + _B[9] * a2)
        + _B[7] * a6 + _B[5] * a4 + _B[3] * a2 + _B[1] * eye,
    )
    v = (
        mul(a6, _B[12] * a6 + _B[10] * a4 + _B[8] * a2)
        + _B[6] * a6 + _B[4] * a4 + _B[2] * a2 + _B[0] * eye
    )
    return u, v


# Taylor-19 scaling threshold: truncation error theta^20/20! ~ 4e-19 at
# theta = 1, i.e. double-precision accurate after scaling.
_THETA_TAYLOR = 1.0
# Degree-8 short-circuit threshold: when EVERY matrix in the batch has
# 1-norm <= 0.25 (the standard propagation regime, ||dt*H|| small), the
# degree-8 polynomial (4 matmuls vs 7) is already accurate to
# 0.25^9/9! ~ 1e-11.
_THETA_TAYLOR_8 = 0.25
# 1/k! for k = 0..19.
_TAYLOR_COEFFS = tuple(1.0 / math.factorial(k) for k in range(20))


def _squaring_count(a, theta):
    """Per-matrix squaring count s >= 0 so that ||a / 2^s||_1 <= theta."""
    norm = one_norm(a)
    # ceil(log2(norm / theta)) clamped to [0, _MAX_SQUARINGS]; log2 of 0 or
    # subnormal norms is guarded by the maximum with 1 (=> s = 0).
    ratio = norm / theta
    s = jnp.ceil(jnp.log2(jnp.maximum(ratio, 1.0))).astype(jnp.int32)
    return jnp.clip(s, 0, _MAX_SQUARINGS)


def _taylor19(a):
    """Degree-19 Taylor polynomial of exp(a) by Paterson-Stockmeyer.

    7 matmuls and no linear solve: the accelerator core (see
    ``_default_method``).
    """
    d = a.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(d, dtype=a.dtype), a.shape)
    a2 = mul(a, a)
    a3 = mul(a2, a)
    a4 = mul(a2, a2)
    c = _TAYLOR_COEFFS

    def chunk(k):
        # c_k I + c_{k+1} A + c_{k+2} A^2 + c_{k+3} A^3
        return (c[k] * eye + c[k + 1] * a + c[k + 2] * a2 + c[k + 3] * a3)

    # Horner in A^4 over 5 degree-3 chunks: degrees 0..19.
    p = chunk(16)
    p = mul(p, a4) + chunk(12)
    p = mul(p, a4) + chunk(8)
    p = mul(p, a4) + chunk(4)
    p = mul(p, a4) + chunk(0)
    return p


def _taylor8(a):
    """Degree-8 Taylor polynomial by Paterson-Stockmeyer (4 matmuls)."""
    d = a.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(d, dtype=a.dtype), a.shape)
    a2 = mul(a, a)
    a3 = mul(a2, a)
    a4 = mul(a2, a2)
    c = _TAYLOR_COEFFS
    low = c[0] * eye + c[1] * a + c[2] * a2 + c[3] * a3
    high = c[4] * eye + c[5] * a + c[6] * a2 + c[7] * a3 + c[8] * a4
    return low + mul(a4, high)


def _taylor_poly(a, norm_max):
    """Norm-adaptive Taylor approximant: degree 8 when the whole batch is
    small, degree 19 otherwise (runtime lax.cond, one branch executes)."""
    return lax.cond(norm_max <= _THETA_TAYLOR_8, _taylor8, _taylor19, a)


# Forward-implementation override: "auto" picks Taylor on accelerators and
# Pade on CPU (see _default_method).
_EXPM_FORWARD = {"impl": "auto"}


def set_expm_forward(impl):
    """Select the expm approximant: 'auto' | 'taylor' | 'pade'."""
    if impl not in ("auto", "taylor", "pade"):
        raise ValueError("Unknown expm forward implementation: {}"
                         "".format(impl))
    _EXPM_FORWARD["impl"] = impl


def _method():
    impl = _EXPM_FORWARD["impl"]
    return _default_method() if impl == "auto" else impl


def _forward_impl(a):
    with jax.named_scope("expm"):
        return _expm_core(a, max_squarings=None, method=_method())


def _default_method():
    """Approximant choice: the rational Padé-13 form needs a batched LU
    solve, the polynomial Taylor-19 form only matrix products. Both are
    double-precision accurate after scaling. The CPU keeps Padé (fewer
    products); accelerators take Taylor, whose products batch densely
    (whether Padé's solve pays on the GPU is not measured yet)."""
    return "pade" if jax.default_backend() == "cpu" else "taylor"


def _expm_core(a, max_squarings=None, method=None):
    """Scaling-and-squaring core (Padé-13 or Taylor-19 approximant).

    With ``max_squarings=None`` the squaring chain is a masked
    ``lax.while_loop`` running ``max(s)`` iterations over the batch (fast, not
    reverse-differentiable). With a static ``max_squarings`` it is a masked
    ``fori_loop`` (reverse-differentiable through the algorithm).
    """
    if method is None:
        method = _default_method()
    theta = _THETA_13 if method == "pade" else _THETA_TAYLOR
    s = _squaring_count(a, theta)
    real_dt = jnp.finfo(a.dtype).dtype
    scale = jnp.exp2(-s.astype(real_dt))
    a_scaled = a * scale[..., None, None]

    if method == "pade":
        u, v = _pade13_uv(a_scaled)
        r = jnp.linalg.solve(-u + v, u + v)
    else:
        scaled_norm_max = jnp.max(one_norm(a_scaled))
        r = _taylor_poly(a_scaled, scaled_norm_max)

    mask = s[..., None, None]

    def body(i, r_):
        return jnp.where(i < mask, mul(r_, r_), r_)

    if max_squarings is None:
        s_max = jnp.max(s)

        def wcond(carry):
            i, _ = carry
            return i < s_max

        def wbody(carry):
            i, r_ = carry
            return i + 1, body(i, r_)

        _, r = lax.while_loop(wcond, wbody, (jnp.int32(0), r))
    else:
        r = lax.fori_loop(0, max_squarings, body, r)
    return r


def expm_pade(a, max_squarings=16):
    """Differentiable-through Padé-13 expm with a static squaring bound.

    JAX reverse-mode differentiates through the algorithm itself (scaled
    matmuls + solve + masked squarings). Use :func:`expm` for the
    custom-adjoint version; this variant exists as an oracle for validating
    the custom VJP and for callers that need forward-mode (jvp).

    Parity: reference expm_pade (expm.py:210-252), minus its order-selection
    branches and the pade9 typo crash.
    """
    return _expm_core(a, max_squarings=max_squarings, method="pade")


def expm_taylor(a, max_squarings=None):
    """Solve-free Taylor-19 scaling-and-squaring expm (the accelerator
    default)."""
    return _expm_core(a, max_squarings=max_squarings, method="taylor")


@jax.custom_vjp
def expm(a):
    """Matrix exponential, batched over leading axes.

    Forward: scaling-and-squaring Padé-13 with data-dependent squaring count.
    Backward: exact Fréchet adjoint — cotangent Ā = L(Aᵀ, Ḡ) via one block
    expm — replacing autograd-through-the-algorithm (the reference's 4000x
    slowdown, report.tex:251).
    """
    return _forward_impl(a)


def expm_frechet(a, e):
    """Fréchet derivative L(A, E) = d/dt expm(A + tE) |_{t=0}.

    Evaluated with the block identity
    ``expm([[A, E], [0, A]]) = [[expm(A), L(A, E)], [0, expm(A)]]``.
    """
    d = a.shape[-1]
    zeros = jnp.zeros_like(a)
    top = jnp.concatenate((a, e), axis=-1)
    bot = jnp.concatenate((zeros, a), axis=-1)
    block = jnp.concatenate((top, bot), axis=-2)
    return _forward_impl(block)[..., :d, d:]


def _dualmul(x, y):
    """(V, dV) x (W, dW) -> (VW, dV·W + V·dW)."""
    v, dv = x
    w, dw = y
    return mul(v, w), mul(dv, w) + mul(v, dw)


def _taylor19_dual(p):
    """Dual-number degree-19 Paterson-Stockmeyer (the tangent of
    _taylor19): 7 dual matmuls."""
    a, da = p
    d = a.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(d, dtype=a.dtype), a.shape)
    a2 = _dualmul(p, p)
    a3 = _dualmul(a2, p)
    a4 = _dualmul(a2, a2)
    c = _TAYLOR_COEFFS

    def chunk(k):
        return (c[k] * eye + c[k + 1] * a + c[k + 2] * a2[0]
                + c[k + 3] * a3[0],
                c[k + 1] * da + c[k + 2] * a2[1] + c[k + 3] * a3[1])

    def step(q, k):
        qm = _dualmul(q, a4)
        ck = chunk(k)
        return qm[0] + ck[0], qm[1] + ck[1]

    q = chunk(16)
    q = step(q, 12)
    q = step(q, 8)
    q = step(q, 4)
    q = step(q, 0)
    return q


def _taylor8_dual(p):
    """Dual-number degree-8 Paterson-Stockmeyer (4 dual matmuls)."""
    a, da = p
    d = a.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(d, dtype=a.dtype), a.shape)
    a2 = _dualmul(p, p)
    a3 = _dualmul(a2, p)
    a4 = _dualmul(a2, a2)
    c = _TAYLOR_COEFFS
    low = (c[0] * eye + c[1] * a + c[2] * a2[0] + c[3] * a3[0],
           c[1] * da + c[2] * a2[1] + c[3] * a3[1])
    high = (c[4] * eye + c[5] * a + c[6] * a2[0] + c[7] * a3[0]
            + c[8] * a4[0],
            c[5] * da + c[6] * a2[1] + c[7] * a3[1] + c[8] * a4[1])
    tail = _dualmul(a4, high)
    return low[0] + tail[0], low[1] + tail[1]


def _frechet_dual_taylor(at, g):
    """L(at, g) by a dual-number evaluation of the Taylor
    scaling-squaring chain — ~3x the forward's matmul count, versus ~8x
    for the block identity expm([[at, g], [0, at]]) on 2d-sized matrices
    (measured 13.7 -> ~6 ms on the d=2^10 Table-1 backward). Exact for any
    norm: the pair rides the same scaling, norm-adaptive polynomial, and
    masked squaring chain as the forward."""
    s = _squaring_count(at, _THETA_TAYLOR)
    real_dt = jnp.finfo(at.dtype).dtype
    scale = jnp.exp2(-s.astype(real_dt))[..., None, None]
    v = at * scale
    dv = g * scale
    norm_max = jnp.max(one_norm(v))
    v, dv = lax.cond(norm_max <= _THETA_TAYLOR_8, _taylor8_dual,
                     _taylor19_dual, (v, dv))
    mask = s[..., None, None]
    s_max = jnp.max(s)

    def wcond(carry):
        return carry[0] < s_max

    def wbody(carry):
        i, (v_, dv_) = carry
        sq = _dualmul((v_, dv_), (v_, dv_))
        keep = i < mask
        return i + 1, (jnp.where(keep, sq[0], v_),
                       jnp.where(keep, sq[1], dv_))

    _, (_, dv) = lax.while_loop(wcond, wbody, (jnp.int32(0), (v, dv)))
    return dv


def _expm_fwd(a):
    return _forward_impl(a), a


def _approximant(a, method):
    if method == "pade":
        u, v = _pade13_uv(a)
        return jnp.linalg.solve(-u + v, u + v)
    return _taylor_poly(a, jnp.max(one_norm(a)))


def _expm_bwd(a, g):
    # JAX vjp is the linear (non-conjugating) transpose of the jvp. The jvp of
    # expm is E -> L(A, E) = \int exp(sA) E exp((1-s)A) ds; its transpose under
    # the bilinear pairing sum(X * Y) is G -> L(A^T, G).
    #
    # Two exact evaluations, chosen at runtime:
    # - no squaring needed anywhere in the batch (the common propagation
    #   regime, ||dt*H|| < theta): the forward was just the approximant
    #   polynomial, so its jax.vjp IS the exact adjoint — ~2x forward cost;
    # - otherwise: the block-matrix Fréchet identity on the 2d-sized
    #   [[A^T, G], [0, A^T]] (one 2d expm, ~8x forward cost).
    method = _method()
    theta = _THETA_13 if method == "pade" else _THETA_TAYLOR
    s_max = jnp.max(_squaring_count(a, theta))

    def cheap(operands):
        a_, g_ = operands
        _, vjp_fn = jax.vjp(lambda x: _approximant(x, method), a_)
        return vjp_fn(g_)[0]

    def block(operands):
        a_, g_ = operands
        at = jnp.swapaxes(a_, -1, -2)
        if method == "taylor":
            # Dual-number chain: ~3x forward cost vs the 2d-block expm's
            # ~8x (see _frechet_dual_taylor).
            return _frechet_dual_taylor(at, g_)
        return expm_frechet(at, g_)

    with jax.named_scope("expm_bwd"):
        return (lax.cond(s_max == 0, cheap, block, (a, g)),)


expm.defvjp(_expm_fwd, _expm_bwd)


def expm_eigh(h):
    """U = expm(-1j * h) for Hermitian h, via eigendecomposition.

    The fast path for skew-Hermitian generators (every Schrödinger Magnus term
    is skew-Hermitian when the user Hamiltonian is Hermitian): two matmuls and
    an elementwise exp instead of the Padé chain. Differentiable through
    ``jnp.linalg.eigh``.

    Parity: reference expm_eigh (expm.py:257-271).
    """
    eigvals, p = jnp.linalg.eigh(h)
    d = jnp.exp(-1j * eigvals)
    return mul(p * d[..., None, :], conjugate_transpose(p))
