"""resolve_and_gather: z-resolve followed by the winner-attribute gather,
with a segment-sum backward; and the face-vertex gather.

The CUDA reference resolves visibility (kernel N1) and then the Python
layer gathers per-face data at every pixel (``to_map``, utils.py:104-114,
whose autograd transpose is an atomicAdd scatter in the chainer twin,
rasterize.py:94-115).  This module keeps that split: the resolve runs
either as the XLA scan (``backend='xla'``, the plain reference) or as the
tiled Triton kernel (``backend='triton'``), and the winning face's vertex
coordinates and auxiliary attributes are gathered with ``to_map`` into
channel planes (NCHW), the pipeline's layout.

Gradient semantics match ``to_map`` exactly: d(face_data)[b, fim[p]] +=
g[p] over foreground pixels; the face-index map itself carries no
gradient.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .maps import to_map
from .resolve import compute_face_index_map
from .resolve_triton import compute_face_index_map_triton


def face_index_map(faces, image_size, near, far, draw_backside, backend,
                   row_start=0, num_rows=None, return_depth=False,
                   interpret=False, face_chunk=None):
    """The z-buffer resolve on the chosen backend (see
    :func:`.resolve.compute_face_index_map` for arguments and results).
    ``face_chunk`` is the XLA scan's chunk (default 16); the Triton kernel
    has its own schedule."""
    if backend == "triton":
        return compute_face_index_map_triton(
            faces, image_size, near, far, draw_backside,
            row_start=row_start, num_rows=num_rows,
            return_depth=return_depth, interpret=interpret,
        )
    if backend != "xla":
        raise ValueError("unknown resolve backend %r" % (backend,))
    return compute_face_index_map(
        faces, image_size, near, far, draw_backside, face_chunk or 16,
        row_start=row_start, num_rows=num_rows, return_depth=return_depth,
    )


def _scatter_to_faces(grad_map, face_index_map, num_faces):
    """[bs, H, W, D] pixel grads -> [bs, nf, D] per-face grads
    (masked segment-sum; the transpose of the winner-gather)."""
    bs = grad_map.shape[0]
    D = grad_map.shape[-1]
    flat_g = grad_map.reshape(bs, -1, D)
    flat_i = face_index_map.reshape(bs, -1)
    mask = (flat_i >= 0)[..., None]
    flat_g = jnp.where(mask, flat_g, 0.0)
    safe_i = jnp.maximum(flat_i, 0)

    def per_batch(g, i):
        return jax.ops.segment_sum(g, i, num_segments=num_faces)

    return jax.vmap(per_batch)(flat_g, safe_i)


@jax.custom_vjp
def gather_face_vertices(vertices, face_indices):
    """``vertices[:, face_indices]`` ([bs, nv, 3] -> [bs, nf, 3, 3]), the
    reference's face assembly (rasterize.py:231-232).  The shared-vertex
    gradient transpose is a segment-sum over the nf*3 slots."""
    return jnp.take(vertices, face_indices, axis=1)


def _gfv_fwd(vertices, face_indices):
    out = jnp.take(vertices, face_indices, axis=1)
    return out, (face_indices, vertices.shape[1])


def _gfv_bwd(residuals, g):
    face_indices, num_vertices = residuals
    flat_idx = face_indices.reshape(-1)

    def per_batch(gb):
        return jax.ops.segment_sum(
            gb.reshape(-1, 3), flat_idx, num_segments=num_vertices
        )

    g_idx = np.zeros(face_indices.shape, jax.dtypes.float0)
    return jax.vmap(per_batch)(g), g_idx


gather_face_vertices.defvjp(_gfv_fwd, _gfv_bwd)


@functools.partial(
    jax.custom_vjp,
    nondiff_argnums=(3, 4, 5, 6, 7, 8, 9, 10),
)
def resolve_and_gather(
    face_vertices,
    face_attrs,
    row_start,
    image_size,
    near,
    far,
    draw_backside,
    backend,
    num_rows,
    latch_z=True,
    interpret=False,
):
    """Returns (face_index_map, fvm_planar, attr_planes).

    Args:
      face_vertices: [bs, nf, 3, 3] NDC face vertices (differentiable).
      face_attrs: [bs, nf, A] auxiliary per-face attributes
        (differentiable), or None.
      row_start: first image row to render (int scalar; may be traced --
        the tile-sharded path passes ``axis_index('tile') * rows``).
      backend: 'xla' (the scan) or 'triton' (the tiled kernel).
      num_rows: rows to render (static), or None for the full image.
      latch_z: when False, only the winner's XY coords are gathered (the
        silhouette path never reads z) and fvm_planar's z planes (2,5,8)
        are constant zeros; no gradient flows into vertex z either way
        through those planes.
      interpret: run the Triton kernel in the Pallas interpreter.

    Outputs (H = num_rows):
      face_index_map: [bs, H, W] int32, -1 background (non-differentiable).
      fvm_planar: [bs, 9, H, W] winner vertex coords, 0 on background.
      attr_planes: [bs, A, H, W] or None.
    """
    return _forward(
        face_vertices, face_attrs, row_start, image_size, near, far,
        draw_backside, backend, num_rows, latch_z, interpret,
    )


_XY_PLANES = (0, 1, 3, 4, 6, 7)


def _forward(face_vertices, face_attrs, row_start, image_size, near, far,
             draw_backside, backend, num_rows, latch_z, interpret):
    bs, nf = face_vertices.shape[:2]
    coords_src = (
        face_vertices.reshape(bs, nf, 9) if latch_z
        else face_vertices[..., :2].reshape(bs, nf, 6)
    )
    fim = face_index_map(
        jax.lax.stop_gradient(face_vertices), image_size, near, far,
        draw_backside, backend, row_start=row_start, num_rows=num_rows,
        interpret=interpret,
    )
    fvm_c = to_map(coords_src, fim).transpose(0, 3, 1, 2)
    attr_planes = (
        None if face_attrs is None
        else to_map(face_attrs, fim).transpose(0, 3, 1, 2)
    )
    if latch_z:
        fvm_planar = fvm_c
    else:
        # assemble the 9-plane layout with zero z planes (fused away by
        # XLA into the consumers)
        z = jnp.zeros_like(fvm_c[:, :1])
        fvm_planar = jnp.concatenate(
            [fvm_c[:, 0:2], z, fvm_c[:, 2:4], z, fvm_c[:, 4:6], z], 1
        )
    return fim, fvm_planar, attr_planes


def _fwd(face_vertices, face_attrs, row_start, image_size, near, far,
         draw_backside, backend, num_rows, latch_z, interpret):
    out = _forward(
        face_vertices, face_attrs, row_start, image_size, near, far,
        draw_backside, backend, num_rows, latch_z, interpret,
    )
    return out, (out[0], face_vertices.shape[1])


def _bwd(image_size, near, far, draw_backside, backend, num_rows, latch_z,
         interpret, residuals, g):
    fim, num_faces = residuals
    _, g_fvm, g_attr = g
    bs = fim.shape[0]
    has_attr = g_attr is not None and not isinstance(
        g_attr, jax.custom_derivatives.SymbolicZero
    )
    if not latch_z:
        # z planes are constant zeros in the primal: drop their cotangents
        g_fvm = g_fvm[:, _XY_PLANES]
    g_coords = _scatter_to_faces(g_fvm.transpose(0, 2, 3, 1), fim, num_faces)
    g_attrs = (
        _scatter_to_faces(g_attr.transpose(0, 2, 3, 1), fim, num_faces)
        if has_attr else None
    )
    if latch_z:
        g_faces = g_coords.reshape(bs, num_faces, 3, 3)
    else:
        g_faces = jnp.pad(
            g_coords.reshape(bs, num_faces, 3, 2), ((0, 0),) * 3 + ((0, 1),)
        )
    # row_start is an integer scalar: its cotangent is the trivial float0
    g_row_start = np.zeros((), jax.dtypes.float0)
    return g_faces, g_attrs, g_row_start


resolve_and_gather.defvjp(_fwd, _bwd)
