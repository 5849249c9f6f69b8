"""tracy-tpu: a differentiable progressive Monte Carlo path tracer in JAX.

A JAX/XLA framework with the capabilities of carcass82/tracy (a C++20/CUDA
interactive path tracer, see SURVEY.md): triangle-mesh path
tracing with an Unreal-style roughness/metalness/translucency/IOR material model,
textured meshes, HDR sky probes, procedural geometry, a `.scn` scene format,
BVH-accelerated intersection and progressive sample accumulation — re-designed
for data-parallel accelerators:

* flat SoA scene pytrees instead of OO Mesh/Material graphs,
* a wavefront integrator (`lax.scan` over bounces, masked lanes) instead of a
  recursive megakernel,
* counter-based stateless RNG instead of per-thread mutable PRNG state,
* host-side binned-SAH BVH flattened to arrays + vectorized lock-step traversal
  instead of a pointer kd-tree,
* the whole light path differentiable (pixel -> material params / textures /
  vertices), which the reference never had,
* pixels/samples sharded over a `jax.sharding.Mesh` with `psum` reductions
  instead of OpenMP/CUDA thread grids.
"""

from tracy_tpu.config import RenderConfig
from tracy_tpu.version import __version__

__all__ = ["RenderConfig", "__version__"]
