"""Gradient-parity test for the NMR ``differentiation`` op against a
finite-shift oracle (reference: tests_torch/test_differentiation.py:10-65).

For random images and an identity coordinate grid, the gradient w.r.t.
each interior pixel's coordinate must equal (in absolute value) the
larger of the two "shift this pixel by one row/col" loss deltas, clamped
to negative (the maximum() rule).
"""

import jax
import jax.numpy as jnp
import numpy as np

import neural_renderer_v2_jax as nr


def test_differentiation_backward_matches_finite_shift():
    rng = np.random.RandomState(0)
    images = rng.normal(size=(10, 32, 32, 3)).astype("float32")

    x = np.tile(np.arange(32).astype("float32")[None, None, :, None], (10, 32, 1, 1))
    y = np.tile(np.arange(32).astype("float32")[None, :, None, None], (10, 1, 32, 1))
    coordinates = np.concatenate((x, y), axis=-1)
    coordinates = ((coordinates / 31) * 2 - 1) * 31.0 / 32.0

    noise = rng.normal(size=(10, 32, 32, 3)).astype("float32")
    step = 2 / 32.0

    # the op is channel-planar (NCHW); the oracle below stays in NHWC
    images_j = jnp.asarray(images.transpose(0, 3, 1, 2))
    noise_j = jnp.asarray(noise.transpose(0, 3, 1, 2))

    def loss_fn(coords):
        return jnp.sum(nr.differentiation(images_j, coords) * noise_j)

    grad_planar = np.asarray(
        jax.grad(loss_fn)(jnp.asarray(coordinates.transpose(0, 3, 1, 2)))
    )
    grad_coordinates = grad_planar.transpose(0, 2, 3, 1)

    for _ in range(100):
        yi = rng.randint(1, 31)
        xi = rng.randint(1, 31)

        # shift the pixel one row down ("bottom") / up ("top")
        images_yb = images.copy()
        images_yb[:, yi - 1, xi] = images[:, yi, xi]
        images_yb[:, yi, xi] = images[:, yi + 1, xi]
        grad_yb = ((images_yb - images) * noise).sum((1, 2, 3)) / step
        grad_yb = np.minimum(grad_yb, 0)

        images_yt = images.copy()
        images_yt[:, yi + 1, xi] = images[:, yi, xi]
        images_yt[:, yi, xi] = images[:, yi - 1, xi]
        grad_yt = ((images_yt - images) * noise).sum((1, 2, 3)) / step
        grad_yt = np.minimum(grad_yt, 0)

        grad_y_abs = np.maximum(np.abs(grad_yb), np.abs(grad_yt))
        np.testing.assert_allclose(
            grad_y_abs, np.abs(grad_coordinates[:, yi, xi, 1]), rtol=1e-4, atol=0
        )

        images_xl = images.copy()
        images_xl[:, yi, xi - 1] = images[:, yi, xi]
        images_xl[:, yi, xi] = images[:, yi, xi + 1]
        grad_xl = ((images_xl - images) * noise).sum((1, 2, 3)) / step
        grad_xl = np.minimum(grad_xl, 0)

        images_xr = images.copy()
        images_xr[:, yi, xi + 1] = images[:, yi, xi]
        images_xr[:, yi, xi] = images[:, yi, xi - 1]
        grad_xr = ((images_xr - images) * noise).sum((1, 2, 3)) / step
        grad_xr = np.minimum(grad_xr, 0)

        grad_x_abs = np.maximum(np.abs(grad_xl), np.abs(grad_xr))
        np.testing.assert_allclose(
            grad_x_abs, np.abs(grad_coordinates[:, yi, xi, 0]), rtol=1e-4, atol=0
        )


def test_differentiation_forward_is_identity():
    rng = np.random.RandomState(1)
    images = jnp.asarray(rng.normal(size=(2, 3, 8, 8)).astype("float32"))
    coords = jnp.zeros((2, 2, 8, 8), jnp.float32)
    out = nr.differentiation(images, coords)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(images))


def test_maximum_rule():
    from neural_renderer_v2_jax.ops.differentiation import maximum

    r = jnp.asarray(np.array([-1.0, 2.0, 1.0, 0.5, 0.50004], "float32"))
    l = jnp.asarray(np.array([-2.0, 1.0, 3.0, 0.5, 0.5], "float32"))
    out = np.asarray(maximum(r, l))
    # both <= 0 -> 0; r > l -> -r; l >= r -> l; |r-l| < 1e-4 -> 0
    np.testing.assert_allclose(out, [0.0, -2.0, 3.0, 0.0, 0.0])
