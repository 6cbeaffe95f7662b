"""Sharded rendering: shard_map over a (data, tile) device mesh.

Design (the reference has no parallelism beyond one CUDA launch --
SURVEY.md section 2.2 "Parallelism inventory: none"):

  * The row-local pipeline stage (``ops.rasterize.compute_channel_maps``:
    resolve -> weight/coordinate maps -> shading) runs inside
    ``jax.shard_map``: the batch is sharded over ``data``, image rows over
    ``tile``, faces/textures replicated.  Forward needs ZERO communication
    -- every pixel band is independent.
  * The global stage (``finalize_images``: background blend, the NMR
    differentiation custom-vjp, flips, AA pooling) runs under ordinary
    jit on the sharded arrays; XLA GSPMD inserts the 1-pixel halo
    exchanges that the differentiation backward's neighbor shifts need at
    tile boundaries.
  * Backward: gradients w.r.t. replicated inputs (vertices when broadcast,
    textures, light params) are all-reduced by the psum that shard_map's
    transpose inserts -- XLA overlaps these with remaining backward
    compute.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops.rasterize import (
    RasterizeHyperparam,
    RasterizeParam,
    compute_channel_maps,
    finalize_images,
    make_backgrounds,
)


def _shard_map(f, mesh, in_specs, out_specs):
    # check_vma=False: the resolve's scan carry is initialized from
    # constants (unvarying) but written with tile-varying values, which the
    # vma checker rejects; semantics are correct, so opt out.
    try:
        return jax.shard_map(
            f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
        )
    except (AttributeError, TypeError):  # older jax
        from jax.experimental.shard_map import shard_map as _sm

        return _sm(
            f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_rep=False
        )


def rasterize_core_sharded(vertices, faces, params, hyperparams, mesh):
    """Sharded equivalent of ``ops.rasterize.rasterize_core``.

    Args:
      vertices: [bs, nv, 3]; bs must be divisible by mesh.shape['data'].
      faces: [nf, 3] int32 (replicated).
      params: RasterizeParam; batch-major leaves are sharded over 'data'.
      mesh: a (data, tile) Mesh from parallel.mesh.make_mesh.

    Returns [bs, C, image_size, image_size] images, sharded
    (batch over 'data', rows over 'tile').
    """
    hp = hyperparams
    bs = vertices.shape[0]
    render_size = hp.image_size * 2 if hp.anti_aliasing else hp.image_size
    n_tile = mesh.shape["tile"]
    n_data = mesh.shape["data"]
    n_face = dict(mesh.shape).get("face", 1)
    assert bs % n_data == 0, (bs, n_data)
    # Uneven tile splits pad the row count up to a tile multiple: the
    # trailing shard renders rows past the image bottom, whose pixel
    # centres lie outside every face's bbox (yp > 1), so they resolve to
    # background and are cropped off again before the global stage.
    rows = -(-render_size // n_tile)
    padded_rows = rows * n_tile
    face_axis = "face" if n_face > 1 else None

    def local_fn(vertices, faces, vt, ft, tex, lights):
        p = RasterizeParam(
            vertices_textures=vt, faces_textures=ft, textures=tex,
            lights=lights, texture_size=params.texture_size,
        )
        row_start = jax.lax.axis_index("tile") * rows
        return compute_channel_maps(
            vertices, faces, p, hp, render_size, row_start=row_start,
            num_rows=rows, face_axis=face_axis,
        )

    lights = params.lights
    in_specs = (
        P("data"),                  # vertices
        P(),                        # faces
        P("data") if params.vertices_textures is not None else P(),
        P(),                        # faces_textures (replicated ids)
        P("data") if params.textures is not None else P(),
        P("data"),                  # lights pytree prefix (batch-major leaves)
    )
    # planar NCHW outputs: rows (the tile axis) are dim 2
    out_specs = (
        P("data", None, "tile"),
        P("data", None, "tile"),
        P("data", None, "tile"),
    )

    images, coords, fg = _shard_map(local_fn, mesh, in_specs, out_specs)(
        vertices,
        faces,
        params.vertices_textures,
        params.faces_textures,
        params.textures,
        lights,
    )
    if padded_rows != render_size:
        images = images[:, :, :render_size]
        coords = coords[:, :, :render_size]
        fg = fg[:, :, :render_size]
    backgrounds = make_backgrounds(params, bs, render_size)
    return finalize_images(images, coords, fg, backgrounds, hp)


@functools.lru_cache(maxsize=None)
def _jitted_sharded(hyperparams, mesh):
    return jax.jit(
        lambda vertices, faces, params: rasterize_core_sharded(
            vertices, faces, params, hyperparams, mesh
        )
    )


def _run(vertices, faces, params, hyperparams, mesh):
    if params is None:
        params = RasterizeParam()
    vertices = jnp.asarray(vertices, dtype=jnp.float32)
    faces = jnp.asarray(faces)
    return _jitted_sharded(hyperparams, mesh)(vertices, faces, params)


def rasterize_silhouettes_sharded(
    vertices, faces, params=None, hyperparams=RasterizeHyperparam(), *, mesh
):
    hp = hyperparams.replace(draw_rgb=False, draw_silhouettes=True, draw_depth=False)
    return _run(vertices, faces, params, hp, mesh)[:, 0]


def rasterize_rgba_sharded(
    vertices, faces, params=None, hyperparams=RasterizeHyperparam(), *, mesh
):
    hp = hyperparams.replace(draw_rgb=True, draw_silhouettes=True, draw_depth=False)
    return _run(vertices, faces, params, hp, mesh)


def rasterize_rgb_sharded(
    vertices, faces, params=None, hyperparams=RasterizeHyperparam(), *, mesh
):
    hp = hyperparams.replace(draw_rgb=True, draw_silhouettes=False, draw_depth=False)
    return _run(vertices, faces, params, hp, mesh)


def rasterize_depth_sharded(
    vertices, faces, params=None, hyperparams=RasterizeHyperparam(), *, mesh
):
    hp = hyperparams.replace(draw_rgb=False, draw_silhouettes=False, draw_depth=True)
    return _run(vertices, faces, params, hp, mesh)[:, 0]
