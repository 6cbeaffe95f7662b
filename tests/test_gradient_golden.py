"""Vertex-gradient golden regression.

The NMR approximate backward is the product's core value; this test pins
the exact vertex gradients of a small silhouette fit against a stored
golden (generated by this implementation's CPU path -- a regression
net against future kernel/pipeline changes, complementing the live
finite-shift oracle in test_differentiation.py and the convergence test).
Regenerate with ``python tests/test_gradient_golden.py`` after an
intentional semantic change.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

import neural_renderer_v2_jax as nr
from neural_renderer_v2_jax.ops.rasterize import (
    RasterizeHyperparam,
    rasterize_silhouettes,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "vertex_grads_golden.npz")

VERTS = np.array(
    [[0.8, 0.8, 1.0], [-0.5, -0.8, 1.0], [-0.8, 0.8, 1.0], [0.5, -0.8, 1.0]],
    "float32",
)
FACES = np.array([[0, 1, 2], [3, 1, 0]], "int32")


def _grads():
    hp = RasterizeHyperparam(image_size=64, anti_aliasing=False)
    yy, xx = np.mgrid[0:64, 0:64]
    ref = jnp.asarray(((xx + yy) % 7 / 6.0).astype("float32")[None])

    def loss(v):
        im = rasterize_silhouettes(v, FACES, None, hp)
        return jnp.sum((im - ref) ** 2)

    return np.asarray(jax.grad(loss)(jnp.asarray(VERTS[None])))


def test_vertex_gradients_match_golden():
    g = _grads()
    assert np.abs(g).max() > 0
    if not os.path.exists(GOLDEN):
        np.savez(GOLDEN, grads=g)
    golden = np.load(GOLDEN)["grads"]
    np.testing.assert_allclose(g, golden, rtol=1e-5, atol=1e-7)


if __name__ == "__main__":
    g = _grads()
    np.savez(GOLDEN, grads=g)
    print("regenerated", GOLDEN, g.shape, float(np.abs(g).max()))
