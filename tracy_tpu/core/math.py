"""Vector math and color primitives on batched arrays.

The reference uses a scalar vec2/3/4 + mat3/4 C++ math library (cclib or GLM,
reference src/common.h:100-217). Here everything operates on `[..., 3]`
jnp arrays so a single expression covers millions of rays; matrices are plain
`[4, 4]` arrays (host-built with numpy, device math with jnp).

Conventions match GLM (the reference's alternative math lib selected by
USE_GLM): `reflect`, `refract`, right-handed `lookAt`, GL-style `perspective`
with [-1, 1] clip depth, and the standard piecewise sRGB transfer curve.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

PI = 3.1415926535897932
# Reference EPS (common.h:157). Used by intersection tests and russian roulette.
EPS = 1.0e-8


def dot(a, b, keepdims: bool = True):
    """Batched dot product over the trailing axis."""
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    return jnp.cross(a, b)


def length(v, keepdims: bool = True):
    return jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=keepdims))


def normalize(v, eps: float = 1.0e-20):
    """Safe normalize: returns v/|v| with a tiny clamp to avoid 0/0 -> NaN.

    The clamp keeps gradients finite where |v| ~ 0 (degenerate tangents etc.).
    """
    return v / jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), eps))


def lerp(a, b, t):
    """Linear interpolation a*(1-t) + b*t (GLM lerp argument order)."""
    return a + (b - a) * t


def reflect(incident, normal):
    """GLM reflect: I - 2*dot(N, I)*N. Matches reference material.h:232."""
    return incident - 2.0 * dot(normal, incident) * normal


def refract(incident, normal, eta):
    """GLM refract. Returns the zero vector on total internal reflection.

    Matches the semantics the reference relies on in material.h:242 — when TIR
    occurs the refracted direction degenerates and the specular branch wins via
    the Schlick probability (cosine becomes NaN-free because the zero vector is
    still lerped/normalized; we guard normalize against 0).
    """
    cosi = dot(normal, incident)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    refr = eta * incident - (eta * cosi + jnp.sqrt(jnp.maximum(k, 0.0))) * normal
    return jnp.where(k < 0.0, jnp.zeros_like(refr), refr)


# ---------------------------------------------------------------------------
# Color transfer / tonemapping (reference cc::gfx::srgb/linear/reinhard/aces,
# cpu_details.cpp:218-243).
# ---------------------------------------------------------------------------


def srgb_from_linear(x):
    """Linear -> sRGB, standard piecewise curve (GLM convertLinearToSRGB)."""
    x = jnp.maximum(x, 0.0)
    lo = x * 12.92
    hi = 1.055 * jnp.power(jnp.maximum(x, 1e-8), 1.0 / 2.4) - 0.055
    return jnp.where(x <= 0.0031308, lo, hi)


def linear_from_srgb(x):
    """sRGB -> linear, standard piecewise curve (GLM convertSRGBToLinear)."""
    x = jnp.maximum(x, 0.0)
    lo = x / 12.92
    hi = jnp.power((x + 0.055) / 1.055, 2.4)
    return jnp.where(x <= 0.04045, lo, hi)


def reinhard(x):
    """Reinhard global operator x/(1+x)."""
    return x / (1.0 + x)


def aces(x):
    """ACES filmic fit (Narkowicz 2015)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def luminance(rgb):
    w = jnp.asarray([0.2126, 0.7152, 0.0722], dtype=rgb.dtype)
    return jnp.sum(rgb * w, axis=-1)


# ---------------------------------------------------------------------------
# Host-side (numpy) matrix builders. Used by the camera and scene transforms;
# these mirror GLM's lookAt/perspective/translate/rotate/scale that the
# reference calls in camera.h:37-55 and scene.cpp:423-428,478-483.
# ---------------------------------------------------------------------------


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed view matrix (GLM lookAtRH)."""
    eye = np.asarray(eye, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)

    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)

    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fovy_radians: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    """Right-handed GL projection, clip z in [-1, 1] (GLM perspectiveRH_NO)."""
    f = 1.0 / np.tan(fovy_radians / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = (2.0 * zfar * znear) / (znear - zfar)
    m[3, 2] = -1.0
    return m


def translate(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = np.asarray(t, dtype=np.float64)
    return m


def rotate_axis(angle_radians: float, axis) -> np.ndarray:
    """Rotation about an arbitrary axis (GLM rotate)."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(angle_radians), np.sin(angle_radians)
    C = 1.0 - c
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ]
    )
    return m


def scale(s) -> np.ndarray:
    s = np.asarray(s, dtype=np.float64)
    if s.ndim == 0:
        s = np.full((3,), float(s))
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def radians(deg: float) -> float:
    return float(deg) * np.pi / 180.0
