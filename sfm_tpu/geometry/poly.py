"""Branch-free closed-form polynomial root helpers (cubic/quartic).

Shared by the Grunert P3P solver (geometry/pnp.py) and the quaternion
nearest-rotation solver (geometry/rotations.py).  Everything is
elementwise arithmetic: batched, jit/vmap-friendly, no custom calls."""

from __future__ import annotations

import jax.numpy as jnp


def real_cubic_root(b, c, d):
    """Largest real root of x^3 + b x^2 + c x + d (trigonometric method,
    branch-free)."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    # three-real-root case (discriminant <= 0): Viete
    p_ = jnp.minimum(p, -1e-12)
    m = 2.0 * jnp.sqrt(-p_ / 3.0)
    acos_arg = jnp.clip(3.0 * q / (p_ * m), -1.0, 1.0)
    theta = jnp.arccos(acos_arg) / 3.0
    root_tri = m * jnp.cos(theta) - b / 3.0
    # one-real-root case (discriminant > 0): Cardano
    disc = q * q / 4.0 + p ** 3 / 27.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    cbrt = lambda x: jnp.sign(x) * jnp.abs(x) ** (1.0 / 3.0)
    root_car = cbrt(-q / 2.0 + sq) + cbrt(-q / 2.0 - sq) - b / 3.0
    return jnp.where(disc > 0, root_car, root_tri)


def quartic_roots(A4, A3, A2, A1, A0):
    """Real roots of A4 x^4 + ... + A0 (Ferrari).  Returns (roots [..., 4],
    valid [..., 4]); invalid slots hold 0.  Roots are Newton-polished on
    the original quartic."""
    A4s = jnp.where(jnp.abs(A4) < 1e-12, jnp.sign(A4) * 1e-12 + 1e-12, A4)
    p = A3 / A4s
    q = A2 / A4s
    r = A1 / A4s
    s = A0 / A4s
    al = q - 3.0 * p * p / 8.0
    be = r - p * q / 2.0 + p ** 3 / 8.0
    ga = s - p * r / 4.0 + p * p * q / 16.0 - 3.0 * p ** 4 / 256.0
    # resolvent cubic 8m^3 + 8 al m^2 + (2 al^2 - 8 ga) m - be^2 = 0
    m = real_cubic_root(al, al * al / 4.0 - ga, -be * be / 8.0)
    m = jnp.maximum(m, 1e-12)
    w = jnp.sqrt(2.0 * m)
    # y^2 + w y + (al/2 + m - be/(2w)) = 0 ; y^2 - w y + (al/2 + m + be/(2w))
    c1 = al / 2.0 + m - be / (2.0 * w)
    c2 = al / 2.0 + m + be / (2.0 * w)
    d1 = w * w - 4.0 * c1
    d2 = w * w - 4.0 * c2
    s1 = jnp.sqrt(jnp.maximum(d1, 0.0))
    s2 = jnp.sqrt(jnp.maximum(d2, 0.0))
    ys = jnp.stack([(-w + s1) / 2.0, (-w - s1) / 2.0,
                    (w + s2) / 2.0, (w - s2) / 2.0], axis=-1)
    valid = jnp.stack([d1 >= 0, d1 >= 0, d2 >= 0, d2 >= 0], axis=-1)
    roots = ys - p[..., None] / 4.0

    def bc(x):
        return x[..., None]

    def f(x):
        return (((bc(A4) * x + bc(A3)) * x + bc(A2)) * x + bc(A1)) * x \
            + bc(A0)

    def fp(x):
        return ((4 * bc(A4) * x + 3 * bc(A3)) * x + 2 * bc(A2)) * x + bc(A1)

    for _ in range(2):
        roots = roots - f(roots) / jnp.where(
            jnp.abs(fp(roots)) < 1e-9, 1e-9, fp(roots))
    return jnp.where(valid, roots, 0.0), valid
