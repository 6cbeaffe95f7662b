"""neural_renderer_v2_jax -- a JAX (XLA + a Pallas/Triton GPU kernel)
differentiable triangle-mesh rasterizer with the full capability surface
of Rebirth-Alex/neural_renderer_v2_pytorch (Neural 3D Mesh Renderer v2).

Public API mirrors the reference package __init__
(neural_renderer_torch/__init__.py:1-14) so reference users can switch
imports; everything underneath is a from-scratch design:
  - ops/       pure-functional compute path (camera, resolve, shading,
               the NMR differentiation custom-vjp, rasterize pipeline)
  - models/    Renderer facade, Mesh, lights
  - utils/     OBJ/MTL I/O, texture atlases, generated scenes, optimizers
  - parallel/  device-mesh sharding (shard_map over data x tile x face)
"""

from .models.lights import AmbientLight, DirectionalLight, Light, SpecularLight
from .models.mesh import Mesh
from .models.renderer import Renderer
from .ops.camera import look, look_at, perspective
from .ops.differentiation import differentiation
from .ops.maps import cross, mask_foreground, to_map
from .ops.rasterize import (
    RasterizeHyperparam,
    RasterizeParam,
    rasterize,
    rasterize_all,
    rasterize_depth,
    rasterize_rgb,
    rasterize_rgba,
    rasterize_silhouettes,
)
from .ops.resolve import compute_face_index_map, compute_weight_map
from .utils.helpers import (
    create_textures,
    get_points_from_angles,
    imread,
    imsave,
    make_gif,
    to_device,
    to_gpu,
)
from .utils.obj_io import load_mtl, load_obj, save_obj
from .utils.optim import Adam, adam

__version__ = "2.0.2"
