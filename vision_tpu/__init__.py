"""vision_tpu: differentiable path tracer in JAX.

Brand-new framework with the capability set of the Vision renderer
(reference: Royalvice/Vision): wavefront path tracing over jnp SoA arrays,
uber-BSDF material dispatch, flat light/texture tables, BVH + dense
intersection routes (a CUDA traversal kernel on the GPU), jit/grad/
shard_map throughout.
"""
__version__ = "0.1.0"

import os as _os

import jax as _jax

# f32 matmuls at full f32 precision. On the GPU, XLA would otherwise run
# them in TF32 (about three decimal digits); the renderer's math, geometry
# included, is exact f32 everywhere. This is process-global (it must reach
# every jit trace that touches renderer geometry); host apps embedding the
# renderer alongside TF32-happy JAX code can opt out with VT_EXACT_MATMUL=0.
if _os.environ.get("VT_EXACT_MATMUL", "1") != "0":
    _jax.config.update("jax_default_matmul_precision", "highest")


def _place_compile_cache():
    """JAX's persistent compilation cache: where JAX_COMPILATION_CACHE_DIR
    says (JAX reads that variable itself), else <checkout>/.jax_cache. The
    path is fixed because it is part of the cache key."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    _jax.config.update("jax_compilation_cache_dir",
                       _os.path.join(root, ".jax_cache"))


_place_compile_cache()

from .scene.scene import Scene, load_scene  # noqa: E402,F401
from .render import render, render_to_file, postprocess  # noqa: E402,F401
