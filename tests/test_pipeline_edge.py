"""Pipeline-level edge cases and cross-backend fuzz.

The kernel-level fuzz (test_resolve_triton) covers the resolve ops in
isolation; these cases run the FULL pipeline (gather -> resolve -> maps
-> NMR hook -> flip/AA) on degenerate scenes where integration bugs
hide: empty images, everything clipped, single faces, and batches mixing
empty and full slots -- asserting xla/triton backend equality and
finite, sane gradients throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neural_renderer_v2_jax.ops.rasterize import (
    RasterizeHyperparam,
    RasterizeParam,
    rasterize_rgba,
    rasterize_silhouettes,
)


def _hp(backend, **kw):
    return RasterizeHyperparam(
        image_size=32, anti_aliasing=False, backend=backend,
        interpret=backend == "triton", **kw
    )


def _grad_silhouette(tv, faces, backend):
    def loss(tv):
        return jnp.sum(
            rasterize_silhouettes(tv, faces, None, _hp(backend)) ** 2
        )

    return jax.grad(loss)(tv)


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_empty_scene(backend):
    """No face covers any pixel: black image, zero gradients, no NaNs."""
    tv = jnp.asarray(
        np.array([[[5.0, 5.0, 1.0], [5.2, 5.0, 1.0], [5.0, 5.2, 1.0]]], "f")
    )  # entirely off-screen
    faces = jnp.asarray(np.array([[0, 1, 2]], "i"))
    img = rasterize_silhouettes(tv, faces, None, _hp(backend))
    assert float(jnp.abs(img).max()) == 0.0
    g = _grad_silhouette(tv, faces, backend)
    np.testing.assert_array_equal(np.asarray(g), 0.0)


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_all_faces_clipped_by_near_plane(backend):
    """Faces entirely in front of the near plane (z < near) are clipped:
    empty image, zero gradients (reference kernel.cu near/far clip)."""
    tv = jnp.asarray(
        np.array([[[-0.5, -0.5, 0.01], [0.5, -0.5, 0.01], [0.0, 0.5, 0.01]]], "f")
    )
    faces = jnp.asarray(np.array([[0, 1, 2]], "i"))
    img = rasterize_silhouettes(tv, faces, None, _hp(backend))
    assert float(jnp.abs(img).max()) == 0.0
    g = _grad_silhouette(tv, faces, backend)
    assert np.isfinite(np.asarray(g)).all()


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_single_face_and_mixed_batch(backend):
    """One visible triangle; a batch mixing an empty slot with a full one
    must keep the slots independent (and match the other backend)."""
    tri = np.array(
        [[-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.0, 0.5, 1.0]], "f"
    )
    tv = jnp.asarray(np.stack([tri * 0 + 9.0, tri]))  # slot 0 off-screen
    faces = jnp.asarray(np.array([[0, 1, 2]], "i"))
    img = np.asarray(rasterize_silhouettes(tv, faces, None, _hp(backend)))
    assert img[0].sum() == 0
    assert img[1].sum() > 0
    g = np.asarray(_grad_silhouette(tv, faces, backend))
    assert np.isfinite(g).all()
    assert np.abs(g[1]).max() > 0 and np.abs(g[0]).max() == 0


def test_fuzz_full_pipeline_backend_equality():
    """Random soups (duplicates, degenerates, straddlers) through the
    FULL silhouette and textured pipelines: the two backends must agree
    bit-exactly on images and to 1e-4 rel on gradients."""
    import neural_renderer_v2_jax as nr

    rng = np.random.RandomState(77)
    for trial in range(3):
        nf = int(rng.choice([5, 33]))
        size = 32
        fv = rng.uniform(-1.2, 1.2, (1, nf * 3, 3)).astype("f")
        fv[..., 2] = np.abs(fv[..., 2]) + rng.uniform(0.05, 0.5)
        if nf > 4:
            fv[0, 3:6] = fv[0, 0:3]          # duplicate face
            fv[0, 7] = fv[0, 6]              # degenerate edge
        tv = jnp.asarray(fv)
        faces = jnp.asarray(np.arange(nf * 3, dtype="i").reshape(nf, 3))

        imgs = {}
        grads = {}
        for backend in ("xla", "triton"):
            imgs[backend] = np.asarray(
                rasterize_silhouettes(tv, faces, None, _hp(backend))
            )
            grads[backend] = np.asarray(_grad_silhouette(tv, faces, backend))
        np.testing.assert_array_equal(imgs["xla"], imgs["triton"])
        scale = max(np.abs(grads["xla"]).max(), 1e-6)
        np.testing.assert_allclose(
            grads["triton"], grads["xla"], atol=1e-4 * scale
        )

        # textured RGBA with a tiled atlas through both backends
        vt, ft, tex = nr.create_textures(nf, texture_size=2)
        params = RasterizeParam(
            vertices_textures=jnp.asarray(vt[None]),
            faces_textures=jnp.asarray(ft),
            textures=jnp.asarray(rng.rand(*tex.shape).astype("f")[None]),
            texture_size=2,
        )
        rgba = {
            b: np.asarray(rasterize_rgba(tv, faces, params, _hp(b)))
            for b in ("xla", "triton")
        }
        np.testing.assert_allclose(rgba["xla"], rgba["triton"], atol=1e-5)
