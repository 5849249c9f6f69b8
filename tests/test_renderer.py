def _packet_cfg(**kw):
    from tracy_tpu.config import RenderConfig

    return RenderConfig(width=32, height=24, accel="packet", **kw)


def test_tier_pick_cpu_uses_xla_packet():
    """accel='packet' builds the XLA packet traversal: accel data is the
    (PackedBVH, slot-ordered triangle tables) pair."""
    from tracy_tpu.accel.packet import PackedBVH
    from tracy_tpu.render.renderer import Renderer
    from tracy_tpu.scene.scn_parser import default_scene

    scene = default_scene(32, 24).build()
    r = Renderer(_packet_cfg())
    r._ensure_accel(scene)
    assert isinstance(r.accel.data, tuple) and len(r.accel.data) == 2
    assert isinstance(r.accel.data[0], PackedBVH)


def test_tier_pick_compaction_binds_wrapper():
    """wave_compact_group > 0 wraps the intersector; bounce 0 gets the
    uncompacted binding when skip_first is on."""
    from tracy_tpu.render.renderer import Renderer
    from tracy_tpu.scene.scn_parser import default_scene

    scene = default_scene(32, 24).build()
    r = Renderer(_packet_cfg(wave_compact_group=2048,
                             wave_compact_skip_first=True))
    r._ensure_accel(scene)
    assert r.accel.bind_first is not None
    assert r.accel.bind is not r.accel.bind_first
    isect = r.accel.bind(scene, r.accel.data)
    assert isect.__qualname__.startswith("compact_intersector")

    r2 = Renderer(_packet_cfg())
    r2._ensure_accel(scene)
    assert r2.accel.bind_first is None


def test_tier_pick_accel_none_bruteforce():
    """accel='none' is the reference's CUDA brute-force analogue
    (cuda_trace.cu:22-70): global soup, no tree."""
    from tracy_tpu.render.renderer import Renderer
    from tracy_tpu.config import RenderConfig
    from tracy_tpu.scene.scn_parser import default_scene

    scene = default_scene(32, 24).build()
    r = Renderer(RenderConfig(width=32, height=24, accel="none"))
    r._ensure_accel(scene)
    assert r.accel.data == ()
