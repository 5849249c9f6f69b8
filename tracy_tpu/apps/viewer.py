"""Interactive progressive viewer.

Equivalent of the reference's windowed main loop (win_raytracer.cpp:494-556 +
the Win32/X11 windowing + Bitmap blit): the image keeps accumulating samples
("image will keep getting better", README.md:8) while WASDQE moves the camera
and left-drag looks around; any camera change is a camera cut that resets
accumulation. Window title telemetry (MRays/s @ fps) becomes the figure
title, refreshed ~1 Hz.

While the camera is moving, frames render at PREVIEW RESOLUTION (1/4 in
each dimension = 16x fewer rays, -preview-scale) and upscale for display,
so look-around stays interactive even at 1080p targets; the first still
frame snaps back to full resolution and restarts accumulation. Resizing
the window re-derives the render resolution and the camera projection
(the reference's WM_SIZE -> Camera::UpdateProjection path,
win_raytracer.cpp:118-124, camera.h:44-55) — a resize implies a jit
recompile, so it happens once per new size, not per frame.

The per-tick logic lives in ViewerSession (GUI-free, tested headless in
tests/test_viewer.py); main() wraps it in matplotlib (the only GUI stack
in the image — no X11 dev headers for a native window). Run:

    python -m tracy_tpu.apps.viewer -scene data/scenes/cornell.scn

Headless environments can use -frames N -out img.png for a burst render
(same loop, no window).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np


def preview_config(cfg, scale: int):
    """Downscaled copy of cfg for camera-motion preview frames (None when
    scale <= 1 or the image is already tiny). Dimensions snap to multiples
    of 32 so packets keep square tiles."""
    if scale <= 1:
        return None
    w = max(64, (cfg.width // scale) // 32 * 32)
    h = max(32, (cfg.height // scale) // 32 * 32)
    if w >= cfg.width or h >= cfg.height:
        return None
    return dataclasses.replace(cfg, width=w, height=h)


class ViewerSession:
    """One viewer's worth of state + the per-frame tick, GUI-free.

    The reference's main loop (win_raytracer.cpp:494-556) is: process
    events -> process inputs (camera cut resets accumulation) -> OnUpdate
    (one frame of tracing) -> present. tick() is that loop body; the GUI
    layer feeds events into .controller / .request_resize() and displays
    the returned u8 image.
    """

    def __init__(self, cfg, scene, controller, preview_scale: int = 4):
        from tracy_tpu.render.renderer import Renderer, init_state

        self._Renderer = Renderer
        self._init_state = init_state
        self.cfg = cfg
        self.scene = scene
        self.controller = controller
        self.preview_scale = preview_scale
        self.renderer = Renderer(cfg)
        self.state = init_state(cfg)
        self.pcfg = preview_config(cfg, preview_scale)
        self.prenderer = Renderer(self.pcfg) if self.pcfg is not None else None
        self.pstate = init_state(self.pcfg) if self.pcfg is not None else None
        self.previewing = False
        self._resize_req: Optional[Tuple[int, int]] = None

    # -- event feeds ---------------------------------------------------------

    def request_resize(self, width: int, height: int):
        """Window resize (reference WM_SIZE): render resolution + camera
        projection re-derive on the next tick. Snapped to 32-multiples so
        packets keep square tiles; a resize implies a jit recompile, so it
        is applied once per new size, not per pixel-drag event."""
        self._resize_req = (max(64, int(width) // 32 * 32),
                            max(32, int(height) // 32 * 32))

    # -- the loop body -------------------------------------------------------

    def _apply_resize(self):
        w2, h2 = self._resize_req
        self._resize_req = None
        if (w2, h2) == (self.cfg.width, self.cfg.height):
            return False
        self.cfg = dataclasses.replace(self.cfg, width=w2, height=h2)
        self.controller.state = dataclasses.replace(
            self.controller.state, aspect=w2 / max(h2, 1))
        self.scene = dataclasses.replace(
            self.scene, camera=self.controller.state.to_camera())
        self.renderer = self._Renderer(self.cfg)
        self.state = self._init_state(self.cfg)
        self.pcfg = preview_config(self.cfg, self.preview_scale)
        self.prenderer = (self._Renderer(self.pcfg)
                          if self.pcfg is not None else None)
        self.pstate = (self._init_state(self.pcfg)
                       if self.pcfg is not None else None)
        return True

    def tick(self, dt: float, mouse_pos=None) -> np.ndarray:
        """One frame: inputs -> (maybe) camera cut -> render -> u8 image
        at the CURRENT display resolution (preview frames are upscaled)."""
        if self._resize_req is not None:
            self._apply_resize()

        moved = self.controller.update(dt, mouse_pos)
        if moved:
            # Camera cut: rebuild camera arrays, reset accumulation
            # (TracyEvent::eCameraCut, cpu_trace.cpp:76-78).
            self.scene = dataclasses.replace(
                self.scene, camera=self.controller.state.to_camera())
            self.state = self._init_state(self.cfg)
            self.renderer.total_rays = 0.0
            self.renderer.timer.reset()
            if self.prenderer is not None:
                self.pstate = self._init_state(self.pcfg)
                self.previewing = True
        elif self.previewing:
            self.previewing = False  # first still frame: back to full res
            self.state = self._init_state(self.cfg)

        if self.previewing and self.prenderer is not None:
            self.pstate, _ = self.prenderer.step(self.scene, self.pstate)
            img = np.asarray(self.prenderer.display_u8(self.pstate))
            # nearest-neighbor upscale to the display size
            img = img.repeat(self.preview_scale, axis=0).repeat(
                self.preview_scale, axis=1)[:self.cfg.height, :self.cfg.width]
            return img
        self.state, _ = self.renderer.step(self.scene, self.state)
        return np.asarray(self.renderer.display_u8(self.state))

    def title(self) -> str:
        r = self.prenderer if (self.previewing and self.prenderer) else self.renderer
        st = self.pstate if (self.previewing and self.prenderer) else self.state
        return (f"{r.mrays_per_sec:.2f} MRays/s @ "
                f"{int(st.frame) / max(r.timer.total, 1e-9):.2f} fps"
                f"{' [preview]' if self.previewing else ''}")


def make_session(builder, scene, cfg, preview_scale: int = 4) -> ViewerSession:
    from tracy_tpu.apps.input import CameraController, CameraState

    cam = builder.camera_params
    controller = CameraController(CameraState(
        eye=np.asarray(cam["eye"], dtype=np.float64),
        target=np.asarray(cam["center"], dtype=np.float64),
        up=np.asarray(cam["up"], dtype=np.float64),
        fov_degrees=float(cam["fov_degrees"]),
        aspect=builder.width / max(builder.height, 1),
    ))
    return ViewerSession(cfg, scene, controller, preview_scale)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-scene", default=None)
    p.add_argument("-data-root", default=None)
    p.add_argument("-width", type=int, default=640)
    p.add_argument("-height", type=int, default=480)
    p.add_argument("-spp", type=int, default=1)
    p.add_argument("-bounces", type=int, default=5)
    p.add_argument("-cpu", action="store_true")
    p.add_argument("-frames", type=int, default=0,
                   help="headless: render N frames then save and exit")
    p.add_argument("-preview-scale", type=int, default=4,
                   help="camera-motion preview downscale (1 = off)")
    p.add_argument("-out", default="viewer.png")
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from tracy_tpu.config import RenderConfig, default_path
    from tracy_tpu.render.renderer import Renderer, init_state
    from tracy_tpu.scene.scn_parser import default_scene, load_scene
    from tracy_tpu.utils.compile_cache import setup_compile_cache
    from tracy_tpu.utils.log import log

    if args.scene:
        builder = load_scene(args.scene, data_root=args.data_root,
                             width=args.width, height=args.height)
    else:
        builder = default_scene(args.width, args.height)
    scene = builder.build()
    import jax

    setup_compile_cache()
    cfg = RenderConfig(width=builder.width, height=builder.height,
                       spp=args.spp, max_bounces=args.bounces,
                       **default_path(jax.default_backend(),
                                      builder.width * builder.height,
                                      builder.num_triangles,
                                      builder.has_translucent))

    if args.frames > 0:
        renderer = Renderer(cfg)
        state = init_state(cfg)
        for _ in range(args.frames):
            state, _ = renderer.step(scene, state)
        from tracy_tpu.utils.image_io import save_image

        save_image(renderer.display_u8(state), args.out)
        log(f"saved {args.out}")
        return 0

    sess = make_session(builder, scene, cfg, args.preview_scale)

    import matplotlib

    matplotlib.use("TkAgg" if matplotlib.get_backend() == "agg" else matplotlib.get_backend())
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.set_axis_off()
    im = ax.imshow(np.zeros((cfg.height, cfg.width, 3), np.uint8))
    mouse_pos = [None]
    controller = sess.controller

    fig.canvas.mpl_connect("key_press_event", lambda e: controller.key_down(e.key or ""))
    fig.canvas.mpl_connect("key_release_event", lambda e: controller.key_up(e.key or ""))
    fig.canvas.mpl_connect(
        "button_press_event",
        lambda e: controller.mouse_press(e.x, e.y) if e.button == 1 else None,
    )
    fig.canvas.mpl_connect(
        "button_release_event", lambda e: controller.mouse_release()
    )
    fig.canvas.mpl_connect(
        "motion_notify_event", lambda e: mouse_pos.__setitem__(0, (e.x, e.y))
    )
    fig.canvas.mpl_connect(
        "resize_event", lambda e: sess.request_resize(e.width, e.height))

    last_title = time.perf_counter()
    last_frame = time.perf_counter()
    plt.show(block=False)
    while plt.fignum_exists(fig.number):
        now = time.perf_counter()
        dt = min(now - last_frame, 0.25) * 60.0  # reference dt is in frames-ish
        last_frame = now

        w0, h0 = sess.cfg.width, sess.cfg.height
        img = sess.tick(dt, mouse_pos[0])
        if (sess.cfg.width, sess.cfg.height) != (w0, h0):
            log(f"resize -> {sess.cfg.width}x{sess.cfg.height} "
                f"(projection updated)")
        im.set_data(img)

        if now - last_title > 1.0:
            fig.suptitle(f"{builder.name} — {sess.title()}")
            last_title = now
        fig.canvas.draw_idle()
        fig.canvas.flush_events()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
