"""The NMR approximate-gradient op (``differentiation``).

Forward is the identity on images.  Backward converts incoming pixel
gradients into gradients w.r.t. the per-pixel *screen coordinates*
(coordinate_map) from neighboring-pixel intensity differences -- this is
what makes the rasterizer a *neural* renderer: gradients flow from image
losses through pixel edges back to vertex positions.

Exact reference semantics (required for gradient parity):
  * neural_renderer_torch/differentiation.py:6-40 (the Function),
  * neural_renderer_torch/utils.py:75-101 (``pad_zeros`` and the
    loss-aware ``maximum`` tie-break rule).

For a pixel row intensity I and incoming grad g, with step = 2/H:

  grad_r[y] = -sum_c (I[y] - I[y+1]) * g[y+1] / step        (y in [0, H-2])
  grad_r_full = pad_right(grad_r) + pad_left(grad_r)
  grad_l[y] = -sum_c (I[y+1] - I[y]) * g[y] / step
  grad_l_full = pad_left(grad_l) + pad_right(grad_l)
  grad = maximum(grad_r_full, grad_l_full)

where ``maximum(r, l)`` is 0 if max(r,l) <= 0 or |r-l| < 1e-4, else -r if
r > l else l.  Same along x.  Output grad_loss_xy stacks (grad_x, grad_y)
on the channel axis.

Layout: the whole pipeline is channel-planar (NCHW) -- images are
[bs, C, H, W] and coordinates [bs, 2, H, W] -- so every shift/product
runs along the contiguous image width (the reference's NHWC layout would
put the C<=5 channel dim there).  This is pure vectorized shift/pad
arithmetic that XLA fuses; no kernel is needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def maximum(data_right, data_left, eps=1e-4):
    """Loss-aware combine of right/left edge gradients.

    Reference: neural_renderer_torch/utils.py:91-101.  Application order in
    the reference is: base = left; where r > l -> -r; where |r-l| < eps ->
    0; where max(r, l) <= 0 -> 0.  (Later assignments override earlier
    ones, so the zero conditions win.)
    """
    zero = (jnp.maximum(data_right, data_left) <= 0) | (
        jnp.abs(data_right - data_left) < eps
    )
    picked = jnp.where(data_right > data_left, -data_right, data_left)
    return jnp.where(zero, 0.0, picked)


def _pad_shift(g, axis, side):
    """pad one zero slice on ``side`` of ``axis`` (utils.py:75-88)."""
    pad_width = [(0, 0)] * g.ndim
    pad_width[axis] = (1, 0) if side == "left" else (0, 1)
    return jnp.pad(g, pad_width)


def _coordinate_grad(images, grad_output):
    """Grad w.r.t. the coordinate map.  images/grad: [bs, C, H, W] planar;
    returns [bs, 2, H, W] (x grads on channel 0, y on channel 1)."""
    image_size = images.shape[2]
    step = 2.0 / image_size
    I, G = images, grad_output

    # --- y (rows; axis 2) ---
    gyr = -jnp.sum((I[:, :, :-1] - I[:, :, 1:]) * G[:, :, 1:], axis=1) / step
    grad_y_r = _pad_shift(gyr, 1, "right") + _pad_shift(gyr, 1, "left")
    gyl = -jnp.sum((I[:, :, 1:] - I[:, :, :-1]) * G[:, :, :-1], axis=1) / step
    grad_y_l = _pad_shift(gyl, 1, "left") + _pad_shift(gyl, 1, "right")
    grad_y = maximum(grad_y_r, grad_y_l)          # [bs, H, W]

    # --- x (columns; axis 3) ---
    gxr = -jnp.sum((I[:, :, :, :-1] - I[:, :, :, 1:]) * G[:, :, :, 1:], axis=1) / step
    grad_x_r = _pad_shift(gxr, 2, "right") + _pad_shift(gxr, 2, "left")
    gxl = -jnp.sum((I[:, :, :, 1:] - I[:, :, :, :-1]) * G[:, :, :, :-1], axis=1) / step
    grad_x_l = _pad_shift(gxl, 2, "left") + _pad_shift(gxl, 2, "right")
    grad_x = maximum(grad_x_r, grad_x_l)          # [bs, H, W]

    return jnp.stack((grad_x, grad_y), axis=1)    # [bs, 2, H, W]


@jax.custom_vjp
def differentiation(images, coordinates):
    """Identity on ``images``; routes approximate gradients into
    ``coordinates`` on the backward pass.

    Args:
      images: [bs, C, H, W] rendered channels (planar).
      coordinates: [bs, 2, H, W] per-pixel screen XY (coordinate_map).
    """
    del coordinates
    return images


def _differentiation_fwd(images, coordinates):
    del coordinates
    return images, images


def _differentiation_bwd(residual_images, g):
    grad_images = g
    grad_coordinates = _coordinate_grad(residual_images, g)
    return grad_images, grad_coordinates


differentiation.defvjp(_differentiation_fwd, _differentiation_bwd)
