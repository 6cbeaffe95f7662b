"""High-level ``Renderer`` facade.

Holds camera + rendering state as mutable attributes and composes
transform -> rasterize, mirroring the reference object API
(neural_renderer_torch/renderer.py:7-75) so a reference user can switch
with no call-site changes.  All heavy lifting is in the pure-functional
ops layer; the facade only assembles (static hyperparams, tensor params)
and dispatches to jit-cached pipelines.

Attributes may be jax arrays: setting ``renderer.viewpoints`` to a traced
array inside a ``jax.grad``-ed function makes the camera differentiable
(example4 optimises the camera position this way).
"""

from __future__ import annotations

import math

from ..ops.camera import look, look_at, perspective
from ..ops.rasterize import (
    RasterizeHyperparam,
    RasterizeParam,
    rasterize_depth,
    rasterize_rgb,
    rasterize_rgba,
    rasterize_silhouettes,
)


class Renderer(object):
    def __init__(self):
        # rendering
        self.image_size = 256
        self.anti_aliasing = True
        self.draw_backside = True
        self.background_color = None

        # camera
        self.perspective = True
        self.viewing_angle = 30
        self.viewpoints = [0, 0, -(1.0 / math.tan(math.radians(self.viewing_angle)) + 1)]
        self.camera_mode = "look_at"
        self.camera_direction = [0, 0, 1]
        self.near = 0.1
        self.far = 100

        # resolve backend: 'auto' | 'xla' | 'triton' (RasterizeHyperparam)
        self.backend = "auto"
        # XLA scan chunk of the face-sharded resolve; None -> 16
        self.face_chunk = None
        self.batch_chunk = 8       # lax.map sub-batching past this bs
        # set to the create_textures texture_size to enable the
        # gather-free per-face-patch sampling fast path (leave None for
        # arbitrary loaded atlases)
        self.texture_size = None

    def transform_vertices(self, vertices, lights=None):
        """Viewpoint + perspective transform (renderer.py:24-35)."""
        if self.camera_mode == "look_at":
            vertices = look_at(vertices, self.viewpoints)
        elif self.camera_mode == "look":
            vertices = look(vertices, self.viewpoints, self.camera_direction)

        if self.perspective:
            vertices = perspective(vertices, angle=self.viewing_angle)
        return vertices

    def _hyperparams(self):
        return RasterizeHyperparam(
            image_size=self.image_size,
            near=self.near,
            far=self.far,
            anti_aliasing=self.anti_aliasing,
            draw_backside=self.draw_backside,
            backend=self.backend,
            face_chunk=self.face_chunk,
            batch_chunk=self.batch_chunk,
        )

    def render_silhouettes(self, vertices, faces, backgrounds=None):
        vertices = self.transform_vertices(vertices)
        params = RasterizeParam(
            background_color=self.background_color, backgrounds=backgrounds
        )
        return rasterize_silhouettes(vertices, faces, params, self._hyperparams())

    def render(self, vertices, faces, vertices_t, faces_t, textures, backgrounds=None, lights=None):
        """RGBA render: [bs, 4, H, W]."""
        vertices = self.transform_vertices(vertices)
        params = RasterizeParam(
            vertices_textures=vertices_t,
            faces_textures=faces_t,
            textures=textures,
            background_color=self.background_color,
            backgrounds=backgrounds,
            lights=tuple(lights) if lights is not None else None,
            texture_size=self.texture_size,
        )
        return rasterize_rgba(vertices, faces, params, self._hyperparams())

    def render_rgb(self, vertices, faces, vertices_t, faces_t, textures, backgrounds=None, lights=None):
        vertices = self.transform_vertices(vertices, lights)
        params = RasterizeParam(
            vertices_textures=vertices_t,
            faces_textures=faces_t,
            textures=textures,
            background_color=self.background_color,
            backgrounds=backgrounds,
            lights=tuple(lights) if lights is not None else None,
            texture_size=self.texture_size,
        )
        return rasterize_rgb(vertices, faces, params, self._hyperparams())

    def render_depth(self, vertices, faces, backgrounds=None):
        vertices = self.transform_vertices(vertices)
        params = RasterizeParam(
            background_color=self.background_color, backgrounds=backgrounds
        )
        return rasterize_depth(vertices, faces, params, self._hyperparams())
