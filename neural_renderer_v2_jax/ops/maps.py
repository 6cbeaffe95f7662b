"""Gather/scatter map ops: ``to_map`` and ``mask_foreground``.

Design notes
------------
The reference implements these as a python batch loop with advanced
indexing plus a custom autograd Function (neural_renderer_torch/
utils.py:104-160) and, in the chainer twin, as CuPy kernels with an
``atomicAdd`` scatter in the backward (neural_renderer_chainer/
rasterize.py:31-191).  Here both are single XLA ops:

  * ``to_map`` is a batched gather (``jnp.take`` along the face axis) with
    a ``where(idx >= 0)`` mask.  XLA's transpose of gather is a
    scatter-add (atomic on a GPU, so f32 sums may reorder between runs).
  * ``mask_foreground`` is ``jnp.where(mask, x, 0)``; its VJP is exactly
    the reference's masked-passthrough backward.
"""

from __future__ import annotations

import jax.numpy as jnp


def to_map(data_in, indices):
    """Gather per-face (or per-texel) data onto the image grid.

    Args:
      data_in: [bs, n, ...] per-item data (faces, texels, ...).
      indices: [bs, H, W] int32 map of item ids; negative = background.

    Returns:
      [bs, H, W, ...] gathered data, 0 where ``indices < 0``.

    Differentiable w.r.t. ``data_in`` (XLA scatter-add transpose).
    Reference: neural_renderer_torch/utils.py:104-114.
    """
    indices = indices.astype(jnp.int32)
    safe_idx = jnp.maximum(indices, 0)
    # vmapped gather over the batch axis: out[b, h, w, ...] = data[b, idx[b,h,w], ...]
    gathered = jnp.take_along_axis(
        data_in.reshape(data_in.shape[0], data_in.shape[1], -1),
        safe_idx.reshape(indices.shape[0], -1, 1),
        axis=1,
    )
    out_shape = indices.shape + data_in.shape[2:]
    gathered = gathered.reshape(out_shape)
    mask = (indices >= 0).reshape(indices.shape + (1,) * (len(out_shape) - indices.ndim))
    return jnp.where(mask, gathered, 0.0)


def mask_foreground(data, face_index_map):
    """Zero out background pixels (face_index < 0).

    Gradient: passthrough on foreground, zero on background -- identical to
    the reference's custom Function (utils.py:117-160) but expressed as a
    plain ``where`` whose VJP already has that behavior.
    """
    mask = face_index_map >= 0
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))
    return jnp.where(mask, data, 0.0)


def cross(a, b):
    """Batched 3-vector cross product (chainer-parity op).

    The chainer twin ships a custom Function with the analytic backward
    ``ga = cross(b, gc), gb = cross(gc, a)`` (neural_renderer_chainer/
    cross.py:26-55); under jax the same VJP falls out of autodiff on
    ``jnp.cross``, so this is a plain alias kept for API parity.
    """
    return jnp.cross(a, b)
