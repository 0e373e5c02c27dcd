"""Control interpolation.

Counterpart of the reference's linear interpolation
(/root/reference/qoc/core/mathmethods.py:14-67). The reference brackets the
query with ``anp.argmax(x <= xs)``; here it is a ``jnp.searchsorted`` (binary
search, jit/vmap safe, O(log N)) with the bracket clamped to [1, N-1], which
reproduces the reference's behavior exactly, including linear extrapolation
from the two lowest (highest) points below (above) the sample range.
"""

import jax.numpy as jnp

__all__ = ["interpolate_linear_points", "interpolate_linear_set"]


def interpolate_linear_points(x1, x2, x3, y1, y2):
    """Linearly inter/extrapolate the point at x3 from (x1, y1), (x2, y2).

    Parity: reference mathmethods.py:14-33.
    """
    return y1 + (((y2 - y1) / (x2 - x1)) * (x3 - x1))


def interpolate_linear_set(x, xs, ys):
    """Value at ``x`` of the piecewise-linear function through (xs, ys).

    Arguments:
    x :: scalar - query point.
    xs :: array (N) - sorted sample locations.
    ys :: array (N, ...) - sample values; leading axis indexes samples.

    Returns the interpolated value with shape ``ys.shape[1:]``. Queries outside
    [xs[0], xs[-1]] extrapolate linearly from the two boundary samples
    (reference mathmethods.py:53-61).
    """
    # First index i with x <= xs[i], clamped so (i-1, i) is a valid bracket;
    # the clamping realizes both extrapolation branches of the reference.
    xs = jnp.asarray(xs)
    ys = jnp.asarray(ys)
    index = jnp.searchsorted(xs, x, side="left")
    index = jnp.clip(index, 1, xs.shape[0] - 1)
    x1 = xs[index - 1]
    x2 = xs[index]
    y1 = jnp.take(ys, index - 1, axis=0)
    y2 = jnp.take(ys, index, axis=0)
    return interpolate_linear_points(x1, x2, x, y1, y2)
