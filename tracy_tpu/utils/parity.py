"""Statistical image parity against the reference's own renders.

The goldens in tests/goldens/ref/*.npz are the reference's tonemapped
output (0..255-clamped 255.99*srgb), y=0 scanline first (its v = y/h
convention makes that the image bottom, camera.h:28-35), produced by
tools/refharness from the scenes in tests/goldens/scn/.

RNG streams differ (reference: racy shared-state PCG; ours: counter-based),
so comparison is statistical, and it happens in LINEAR radiance (sRGB
inverted): sRGB is concave, so the sRGB-space mean of a noisier estimate is
systematically lower (Jensen). Linear block means are unbiased at any noise
level; only the 255 clamp (saturated pixels, identical on both sides)
survives as nonlinearity.

Metrics: |mean diff| (global energy), p95 of |block diff| (systematic
regional differences; robust to a few high-variance sun-glint blocks), and
the max block diff. All in linear radiance units (sky white = 1.0).
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN_DIR = os.path.join(REPO_ROOT, "tests", "goldens", "ref")
SCENE_DIR = os.path.join(REPO_ROOT, "tests", "goldens", "scn")


class Tolerance(NamedTuple):
    frames: int  # progressive 1-spp frames rendered for the comparison
    mean: float
    p95: float
    max: float


# Scenes that need no asset files, with the frame count and tolerances
# their comparison uses (calibrations in the comments are CPU runs).
TOLERANCES: Dict[str, Tolerance] = {
    # flat grey sphere under uniform sky: tiny variance, tight tolerance.
    "furnace": Tolerance(24, 0.01, 0.02, 0.05),
    # small emissive light, no NEE: high variance GI (48-frame
    # calibration: mean 0.0011, p95 0.020, max 0.048).
    "cornell": Tolerance(16, 0.01, 0.07, 0.2),
    "testtree": Tolerance(16, 0.01, 0.03, 0.12),
    # 5x5 BRDF sweep under the synthetic HDR sky (nearest-sampled):
    # metal/rough/translucent lobes + the float texture path (24-frame
    # calibration: mean 0.0015, p95 0.008, max 0.017).
    "spheres": Tolerance(6, 0.03, 0.06, 0.5),
    # translucent spheres; paths survive every bounce. CPU calibration
    # (24 frames, bvh): mean 0.0194, p95 0.056, max 0.138; the bounds
    # leave room for another backend's float ordering.
    "random": Tolerance(24, 0.025, 0.075, 0.3),
}


def srgb_to_linear(s):
    return np.where(s <= 0.04045, s / 12.92, ((s + 0.055) / 1.055) ** 2.4)


def load_golden(name: str) -> np.ndarray:
    """The reference's image of `name` in linear radiance, bottom row
    first, [H, W, 3]."""
    z = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    img = z["image"].astype(np.float32)  # [H, W, 3], 0..255
    return srgb_to_linear(img / 255.99)


def ours_linear(tonemapped: np.ndarray, flip: bool = True) -> np.ndarray:
    """Our tonemapped [H, W, 3] image (0..1) -> linear radiance on the
    goldens' 0..255 grid, bottom row first when `flip` (our accum row 0 is
    the image top)."""
    img = np.clip(np.asarray(tonemapped) * 255.99, 0.0, 255.0)
    img = srgb_to_linear(img / 255.99)
    return img[::-1] if flip else img


def block_means(img: np.ndarray, bs: int = 16) -> np.ndarray:
    h, w, _ = img.shape
    return img[: h // bs * bs, : w // bs * bs].reshape(
        h // bs, bs, w // bs, bs, 3
    ).mean(axis=(1, 3))


def parity_metrics(ref: np.ndarray, ours: np.ndarray):
    """(|mean diff|, p95 |block diff|, max |block diff|) of two linear
    images of one shape."""
    if ref.shape != ours.shape:
        raise ValueError(f"shape mismatch {ref.shape} vs {ours.shape}")
    d = np.abs(block_means(ref) - block_means(ours))
    return (abs(float(ref.mean()) - float(ours.mean())),
            float(np.percentile(d, 95)), float(d.max()))


def check_parity(name: str, ref: np.ndarray, ours: np.ndarray,
                 tol: Tolerance):
    """Raise AssertionError naming the metric that exceeds `tol`; return
    the metrics otherwise."""
    dmean, p95, dmax = parity_metrics(ref, ours)
    if dmean > tol.mean:
        raise AssertionError(
            f"{name}: linear mean diff {dmean:.4f} > {tol.mean}")
    if p95 > tol.p95:
        raise AssertionError(f"{name}: block p95 {p95:.4f} > {tol.p95}")
    if dmax > tol.max:
        raise AssertionError(f"{name}: block max {dmax:.4f} > {tol.max}")
    return dmean, p95, dmax


def primary_and_bounce_rays(scene, width: int, height: int, n: int,
                            seed: int = 0):
    """`n` rays of a width x height frame of `scene` for hit-level parity:
    pixel-centre primary rays of n distinct random pixels; for the second
    half, the rays of one scattered bounce from the first hit (found by
    brute force), where there is a hit. Returns (origin, direction, number
    of bounce rays)."""
    import jax.numpy as jnp

    from tracy_tpu.core.camera import pixel_samples_rows
    from tracy_tpu.render import material as mtl
    from tracy_tpu.render.integrator import (
        interpolate_hit, make_bruteforce_intersector,
    )

    half = jnp.full((height, width), 0.5, jnp.float32)
    ss, tt = pixel_samples_rows(width, height,
                                jnp.arange(height, dtype=jnp.int32),
                                half, half)
    o, d = scene.camera.generate_rays(ss, tt)
    rng = np.random.default_rng(seed)
    pick = jnp.asarray(rng.choice(width * height, n, replace=False))
    o = o.reshape(-1, 3)[pick]
    d = d.reshape(-1, 3)[pick]
    hit = make_bruteforce_intersector(scene)(o, d, jnp.ones((n,), bool))
    attrs = interpolate_hit(scene, hit, o, d)
    params = mtl.gather_surface_params(scene, attrs.material, attrs.uv,
                                       attrs.normal, attrs.tangent)
    u = jnp.asarray(rng.random((3, n), dtype=np.float32))
    sc = mtl.scatter(d, attrs.point, params, u[0], u[1], u[2])
    second = (jnp.arange(n) >= n // 2) & hit.mask
    o = jnp.where(second[:, None], sc.origin, o)
    d = jnp.where(second[:, None], sc.direction, d)
    return o, d, int(second.sum())


def hit_materials(scene, res):
    """(Hit, material ids [N]) from any intersector's result: a bare Hit
    (brute force, bvh) or a rich (Hit, PacketAttrs) pair (packet, tlas)."""
    from tracy_tpu.render.intersect import Hit

    if isinstance(res, Hit):
        return res, scene.tri_material[res.tri]
    return res[0], res[1].material
