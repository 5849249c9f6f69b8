"""Inverse-rendering CLI — the differentiable-rendering showcase.

Optimizes scene parameters (material albedo/roughness/metalness, textures,
or vertex positions) so a re-render matches a target image. No reference
analogue exists (Tracy cannot differentiate anything); this is the north-star
capability of this framework.

Examples:
  # Re-derive a material's albedo from a rendering of the scene
  python -m tracy_tpu.apps.optimize_cli -scene data/scenes/default.scn \
      -target target.png -params albedo -steps 200 -out recovered.png

  # Self-test mode: perturb the scene, then recover it
  python -m tracy_tpu.apps.optimize_cli -scene data/scenes/default.scn \
      -selftest albedo -steps 100
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-scene", default=None)
    p.add_argument("-data-root", default=None)
    p.add_argument("-width", type=int, default=96)
    p.add_argument("-height", type=int, default=72)
    p.add_argument("-spp", type=int, default=4)
    p.add_argument("-bounces", type=int, default=3)
    p.add_argument("-target", default=None, help="target image (png)")
    p.add_argument("-params", default="albedo",
                   help="comma list: albedo,roughness,metalness,ior,emissive,"
                        "translucent,tex_data,vertex_pos")
    p.add_argument("-steps", type=int, default=100)
    p.add_argument("-lr", type=float, default=5e-2)
    p.add_argument("-out", default="recovered.png")
    p.add_argument("-selftest", default=None,
                   help="perturb+recover this param instead of using -target")
    p.add_argument("-cpu", action="store_true")
    p.add_argument("-accel", default="auto", choices=("auto", "none"),
                   help="auto = the platform's default traversal "
                        "(config.default_path; zero-gradient for "
                        "material/texture params, winner recompute for "
                        "vertex gradients); none = brute force")
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp
    import optax

    from tracy_tpu.config import RenderConfig, default_path
    from tracy_tpu.diff import (
        apply_params, extract_params, make_train_step,
    )
    from tracy_tpu.render import film
    from tracy_tpu.render.renderer import sample_radiance
    from tracy_tpu.scene.scn_parser import default_scene, load_scene
    from tracy_tpu.utils.compile_cache import setup_compile_cache
    from tracy_tpu.utils.image_io import save_image
    from tracy_tpu.utils.log import log

    if args.scene:
        builder = load_scene(args.scene, data_root=args.data_root,
                             width=args.width, height=args.height)
        builder.width, builder.height = args.width, args.height
    else:
        builder = default_scene(args.width, args.height)
    scene = builder.build()

    setup_compile_cache()
    path = default_path(jax.default_backend(), args.width * args.height,
                        builder.num_triangles, builder.has_translucent)
    if args.accel == "none":
        path = {"accel": "none", "wave_compact_group": 0}
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_bounces=args.bounces, tonemap="none",
                       russian_roulette=False, **path)

    param_names = (args.selftest or args.params).split(",")
    intersect_fn = None
    if args.accel == "auto":
        from tracy_tpu.diff import make_training_intersector

        # vertex gradients need the winner recompute; everything else
        # rides the traversal forward under a zero-gradient VJP.
        intersect_fn = make_training_intersector(
            scene, cfg, needs_geometry_grads="vertex_pos" in param_names,
        )

    frame = jnp.asarray(7, jnp.int32)
    base = extract_params(scene)

    if args.selftest:
        # Target = render of the TRUE scene; start = perturbed params.
        # Only OBSERVABLE rows are perturbed/scored: materials that some
        # triangle references (sky slot 0 contributes via emissive only,
        # and unused table rows can never be recovered).
        target, _ = sample_radiance(scene, cfg, frame, intersect_fn)
        rng = np.random.default_rng(0)
        field = getattr(base, args.selftest)
        used = np.zeros(scene.materials.albedo.shape[0], bool)
        used[np.unique(np.asarray(scene.tri_material))] = True
        used[0] = False
        noise = rng.uniform(-0.3, 0.3, size=field.shape).astype(np.float32)
        if args.selftest in ("albedo", "roughness", "metalness", "ior",
                             "emissive", "translucent"):
            sel = used.reshape((-1,) + (1,) * (field.ndim - 1))
            noise = np.where(sel, noise, 0.0)
        perturbed = field + jnp.asarray(noise)
        if args.selftest in ("albedo", "roughness", "metalness", "translucent"):
            perturbed = jnp.clip(perturbed, 0.01, 1.0)
        params = base._replace(**{args.selftest: perturbed})
        train_fields = [args.selftest]
        observable = sel if args.selftest != "tex_data" else None
    else:
        if not args.target:
            p.error("need -target or -selftest")
        from PIL import Image

        img = np.asarray(Image.open(args.target).convert("RGB"), np.float32) / 255.0
        # Tonemapped png -> approximate linear target.
        from tracy_tpu.core.math import linear_from_srgb

        target = jnp.asarray(np.asarray(linear_from_srgb(jnp.asarray(img))))
        params = base
        train_fields = args.params.split(",")

    mask = jax.tree_util.tree_map(lambda x: jnp.zeros_like(x, bool), base)
    for f in train_fields:
        mask = mask._replace(**{f: jnp.ones_like(getattr(base, f), bool)})

    step, opt_state = make_train_step(
        scene, cfg, optax.adam(args.lr), intersect_fn=intersect_fn,
        trainable_mask=mask,
    )

    t0 = time.perf_counter()
    for i in range(args.steps):
        params, opt_state, loss = step(params, opt_state, target, frame)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            log(f"step {i}: loss {float(loss):.6f}")
    log(f"optimized {args.steps} steps in {time.perf_counter() - t0:.1f}s")

    recovered, _ = sample_radiance(apply_params(scene, params), cfg, frame, intersect_fn)
    save_image(np.asarray(film.to_u8(film.tonemap(recovered, cfg.replace(tonemap='srgb')))), args.out)
    log(f"saved {args.out}")

    if args.selftest:
        diff = np.abs(np.asarray(getattr(params, args.selftest))
                      - np.asarray(getattr(base, args.selftest)))
        if observable is not None:
            diff = diff * observable
        err = float(diff.max())
        log(f"selftest max observable param error vs truth: {err:.4f}")
        return 0 if err < 0.1 else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
