"""Magnus expansions M2 / M4 / M6 with Gauss-Legendre collocation.

Counterpart of /root/reference/qoc/core/mathmethods.py:70-164,
following arXiv:1709.06483. Each function takes a jax-traceable generator
callable ``a(t) -> matrix`` (typically ``-1j * H(t)``), samples it at the
collocation nodes of the interval [time, time + dt], and combines the samples
with commutators. All outputs are batched however ``a`` is batched.
"""

import math

from qoc_tpu.ops.linalg import commutator

__all__ = ["magnus_m2", "magnus_m4", "magnus_m6"]

_M2_C1 = 0.5

_M4_C1 = 0.5 - math.sqrt(3) / 6
_M4_C2 = 0.5 + math.sqrt(3) / 6
_M4_F0 = math.sqrt(3) / 12

_M6_C1 = 0.5 - math.sqrt(15) / 10
_M6_C2 = 0.5
_M6_C3 = 0.5 + math.sqrt(15) / 10
_M6_F0 = math.sqrt(15) / 3
_M6_F1 = 10.0 / 3.0
# DIVERGENCE from the reference: mathmethods.py:130 uses _M6_F2 = 1/2, which
# empirically degrades the M6 scheme to ~3rd order. The Blanes-Casas-Oteo-Ros
# sixth-order Gauss-Legendre Magnus formula is
#   Omega = b1 + b3/12 + (1/240)[-20 b1 - b3 + [b1,b2], b2 - (1/60)[b1, 2 b3
#           + [b1,b2]]],
# i.e. the b3 coefficient is 1/12; with it the one-step error converges at
# ~O(dt^7) (verified against scipy.solve_ivp in tests/test_ops.py).
_M6_F2 = 1.0 / 12.0
_M6_F3 = 1.0 / 240.0
_M6_F4 = 1.0 / 60.0


def magnus_m2(a, dt, time):
    """Second-order Magnus term: dt * a(midpoint).

    Parity: reference mathmethods.py:74-93.
    """
    return dt * a(time + dt * _M2_C1)


def magnus_m4(a, dt, time):
    """Fourth-order Magnus term from two Gauss-Legendre nodes.

    Parity: reference mathmethods.py:100-122.
    """
    a1 = a(time + dt * _M4_C1)
    a2 = a(time + dt * _M4_C2)
    return (dt / 2) * (a1 + a2) + _M4_F0 * (dt ** 2) * commutator(a2, a1)


def magnus_m6(a, dt, time):
    """Sixth-order Magnus term from three Gauss-Legendre nodes.

    Parity: reference mathmethods.py:134-164.
    """
    a1 = a(time + dt * _M6_C1)
    a2 = a(time + dt * _M6_C2)
    a3 = a(time + dt * _M6_C3)
    b1 = dt * a2
    b2 = _M6_F0 * dt * (a3 - a1)
    b3 = _M6_F1 * dt * (a3 - 2 * a2 + a1)
    b1_b2_commutator = commutator(b1, b2)
    return (
        b1
        + _M6_F2 * b3
        + _M6_F3
        * commutator(
            -20 * b1 - b3 + b1_b2_commutator,
            b2 - _M6_F4 * commutator(b1, 2 * b3 + b1_b2_commutator),
        )
    )
