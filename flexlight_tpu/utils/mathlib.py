"""Host-side math utilities (NumPy).

Counterpart of the reference's `modules/math.js` (math.js:6-172).
These run on the host during scene construction / flattening; everything on
the device path lives in `flexlight_tpu.ops`.
"""

from __future__ import annotations

import numpy as np

BIAS = 2.0 ** -32


def stabilize(x):
    """Snap near-integers to integers (math.js:10)."""
    x = np.asarray(x, dtype=np.float64)
    frac = np.abs(x) % 1.0
    snap = (frac < BIAS) | (frac > 1.0 - BIAS)
    return np.where(snap, np.round(x), x)


def cross(a, b):
    return np.cross(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64))


def dot(a, b):
    return float(np.dot(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)))


def diff(a, b):
    return np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)


def add(a, b):
    return np.asarray(a, dtype=np.float64) + np.asarray(b, dtype=np.float64)


def length(a):
    return float(np.linalg.norm(np.asarray(a, dtype=np.float64)))


def normalize(a):
    """Normalize; zero-length vectors map to zero (math.js:52-55)."""
    a = np.asarray(a, dtype=np.float64)
    n = np.linalg.norm(a)
    if n < BIAS:
        return np.zeros_like(a)
    return a / n


def identity(dim: int) -> np.ndarray:
    return np.eye(dim, dtype=np.float64)


def moore_penrose(a) -> np.ndarray:
    """Moore-Penrose pseudo-inverse (math.js:86-101).

    The reference hand-rolls QR; NumPy's SVD-based pinv is numerically
    equivalent for the 3x3 rotation*scale matrices used per transform.
    """
    return np.linalg.pinv(np.asarray(a, dtype=np.float64))


def rotation_axis(normal, theta: float) -> np.ndarray:
    """Axis-angle rotation matrix (scene.js:559-569)."""
    n = np.asarray(normal, dtype=np.float64)
    s, c = np.sin(theta), np.cos(theta)
    omc = 1.0 - c
    return np.array([
        [n[0] * n[0] * omc + c, n[0] * n[1] * omc - n[2] * s, n[0] * n[2] * omc + n[1] * s],
        [n[0] * n[1] * omc + n[2] * s, n[1] * n[1] * omc + c, n[1] * n[2] * omc - n[0] * s],
        [n[0] * n[2] * omc - n[1] * s, n[1] * n[2] * omc + n[0] * s, n[2] * n[2] * omc + c],
    ])


def rotation_spherical(theta: float, psi: float) -> np.ndarray:
    """Spherical rotation matrix (scene.js:571-584)."""
    st, ct = np.sin(theta), np.cos(theta)
    sp, cp = np.sin(psi), np.cos(psi)
    return np.array([
        [ct, 0.0, st],
        [-st * sp, cp, ct * sp],
        [-st * cp, -sp, ct * cp],
    ])


def ray_triangle(ray_origin, ray_direction, t_a, t_b, t_c, n) -> float:
    """CPU ray/triangle distance for UI picking (math.js:113-137).

    Returns distance along the normalized ray, or inf on miss.
    """
    bias = 2.0 ** -12
    n = np.asarray(n, dtype=np.float64)
    d = normalize(ray_direction)
    denom_s = np.dot(n, d)
    if denom_s == 0.0:
        return np.inf
    s = np.dot(n, diff(t_a, ray_origin)) / denom_s
    if s <= bias:
        return np.inf
    p = add(np.asarray(d) * s, ray_origin)
    v0 = diff(t_b, t_a)
    v1 = diff(t_c, t_a)
    v2 = diff(p, t_a)
    d00 = np.dot(v0, v0)
    d01 = np.dot(v0, v1)
    d11 = np.dot(v1, v1)
    d20 = np.dot(v2, v0)
    d21 = np.dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    if denom == 0.0:
        return np.inf
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    if min(u, v) <= bias or u + v >= 1.0 - bias:
        return np.inf
    return float(s)


def gram_schmidt(rows) -> np.ndarray:
    """Row-wise Gram-Schmidt orthogonalization (math.js:59-69),
    un-normalized (the reference normalizes afterwards in qr)."""
    rows = np.asarray(rows, dtype=np.float64)
    out = []
    for r in rows:
        v = r.astype(np.float64).copy()
        for u in out:
            uu = np.dot(u, u)
            if uu > 0:
                v -= u * (np.dot(u, r) / uu)
        out.append(v)
    return np.stack(out)


def qr(a):
    """QR decomposition via Gram-Schmidt on the columns (math.js:78-84).
    Returns (Q, R) with Q column-orthonormal and R = Q^T A."""
    a = np.asarray(a, dtype=np.float64)
    qt = gram_schmidt(a.T)
    norms = np.linalg.norm(qt, axis=1, keepdims=True)
    qt = np.divide(qt, norms, out=np.zeros_like(qt), where=norms > 0)
    return qt.T, qt @ a


def regression(points, n: int) -> np.ndarray:
    """Least-squares polynomial fit of degree n (math.js:103-111):
    coefficients x solving min |A x - b| with A[i,j] = x_i**j, via the
    pseudo-inverse (the reference's Math.regression)."""
    points = np.asarray(points, dtype=np.float64)
    a = points[:, 0:1] ** np.arange(n + 1, dtype=np.float64)[None, :]
    return moore_penrose(a) @ points[:, 1]


def sigmoid(x):
    """Logistic sigmoid (math.js:153); stray ANN leftover kept for
    API parity."""
    return 1.0 / (1.0 + np.exp(-np.asarray(x, dtype=np.float64)))


def sigmoid_prime(x):
    """Sigmoid derivative (math.js:169)."""
    s = sigmoid(x)
    return s * (1.0 - s)


def mod(x, y):
    """Floored modulo (math.js:171) — JS % is truncated; the reference
    defines the floored form explicitly."""
    return x - y * np.floor(x / y)
