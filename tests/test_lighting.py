"""Lighting and background-blend tests with analytic oracles.

The reference validates its 3-light path only torch-vs-chainer
(test_rasterize.py:116-203); here a camera-facing triangle gives a
closed-form answer: normal (0,0,-1) everywhere, so
rgb = tex * (ambient + relu(d_z)*dir_color + specular_color * 1^alpha).
"""

import jax.numpy as jnp
import numpy as np

import neural_renderer_v2_jax as nr
from neural_renderer_v2_jax.models.lights import (
    AmbientLight,
    DirectionalLight,
    SpecularLight,
)
from neural_renderer_v2_jax.ops.rasterize import (
    RasterizeHyperparam,
    RasterizeParam,
    rasterize_rgb,
)

VERTS = np.array(
    [[0.5, -0.5, 1.0], [-0.5, -0.5, 1.0], [0.0, 0.5, 1.0]], "float32"
)
FACES = np.array([[0, 1, 2]], "int32")


def _render(lights, background_color=None):
    vt, ft, tex = nr.create_textures(1, texture_size=2)
    params = RasterizeParam(
        vertices_textures=jnp.asarray(vt[None]),
        faces_textures=jnp.asarray(ft),
        textures=jnp.asarray(tex[None]),  # white
        lights=lights,
        background_color=background_color,
    )
    hp = RasterizeHyperparam(image_size=64, anti_aliasing=False)
    img = rasterize_rgb(jnp.asarray(VERTS[None]), jnp.asarray(FACES), params, hp)
    return np.asarray(img)[0].transpose(1, 2, 0)  # [H, W, 3]


def test_three_light_analytic():
    ca = np.array([[0.1, 0.2, 0.3]], "float32")
    cd = np.array([[0.3, 0.1, 0.2]], "float32")
    cs = np.array([[0.2, 0.3, 0.1]], "float32")
    lights = (
        AmbientLight(color=jnp.asarray(ca)),
        DirectionalLight(color=jnp.asarray(cd), direction=jnp.asarray([[0.0, 0.0, 1.0]])),
        SpecularLight(color=jnp.asarray(cs), alpha=jnp.asarray([2.0])),
    )
    img = _render(lights)
    fg = img.sum(-1) > 0
    assert fg.mean() > 0.05
    expected = (ca + cd + cs)[0]
    # interior pixels (normal constant) must equal the closed form
    interior = np.asarray(img[fg])
    np.testing.assert_allclose(
        np.median(interior, axis=0), expected, rtol=1e-5
    )


def test_directional_backface_flag():
    # light from behind: relu kills it; backside=True takes abs -> full
    cd = jnp.asarray([[0.5, 0.5, 0.5]])
    behind = jnp.asarray([[0.0, 0.0, -1.0]])
    dark = _render((DirectionalLight(color=cd, direction=behind),))
    lit = _render((DirectionalLight(color=cd, direction=behind, backside=True),))
    fg = lit.sum(-1) > 0
    assert dark[fg].max() < 1e-6
    np.testing.assert_allclose(np.median(lit[fg]), 0.5, rtol=1e-5)


def test_background_color_blend():
    img = _render(None, background_color=(0.2, 0.4, 0.6))
    bg = img.sum(-1) > 0
    # background pixels carry exactly the background color
    corners = img[0, 0], img[0, -1], img[-1, 0], img[-1, -1]
    for c in corners:
        np.testing.assert_allclose(c, [0.2, 0.4, 0.6], atol=1e-6)
    # foreground (white texture, no lights) stays 1
    center = img[img.shape[0] // 2 + 8, img.shape[1] // 2]
    np.testing.assert_allclose(center, [1.0, 1.0, 1.0], atol=1e-6)


def test_texel_fast_path_matches_gather_sampling(knot):
    """The latched-texel sampler (texture_size set) must reproduce the
    general atlas-gather sampler on create_textures-style atlases, for
    both values and texture gradients, at ts=2 and ts=4."""
    import jax

    vertices, faces = knot
    renderer = nr.Renderer()
    renderer.viewpoints = nr.get_points_from_angles(2.732, 30, 45)
    tv = renderer.transform_vertices(jnp.asarray(vertices[None]))
    F = jnp.asarray(faces)

    rng = np.random.RandomState(3)
    for ts in (2, 4):
        vt, ft, tex = nr.create_textures(faces.shape[0], texture_size=ts)
        tex = rng.rand(*tex.shape).astype("float32")
        base = dict(
            vertices_textures=jnp.asarray(vt[None]),
            faces_textures=jnp.asarray(ft),
            textures=jnp.asarray(tex[None]),
        )
        hp = RasterizeHyperparam(image_size=64, anti_aliasing=False)
        slow = rasterize_rgb(tv, F, RasterizeParam(**base), hp)
        fast = rasterize_rgb(
            tv, F, RasterizeParam(**base, texture_size=ts), hp
        )
        np.testing.assert_allclose(
            np.asarray(fast), np.asarray(slow), atol=1e-5,
            err_msg="ts=%d forward" % ts,
        )

        def loss(textures, fastpath):
            p = RasterizeParam(
                **{**base, "textures": textures},
                texture_size=ts if fastpath else None,
            )
            return jnp.sum(rasterize_rgb(tv, F, p, hp) ** 2)

        g_slow = np.asarray(jax.grad(loss)(base["textures"], False))
        g_fast = np.asarray(jax.grad(loss)(base["textures"], True))
        scale = max(np.abs(g_slow).max(), 1e-6)
        np.testing.assert_allclose(
            g_fast, g_slow, atol=1e-5 * scale, err_msg="ts=%d grad" % ts
        )


def test_empty_lights_tuple_renders_black():
    """Reference parity (rasterize.py:253-283): lights=() accumulates a
    zero color-weight map, so the RGB channels come out black (lights=None
    skips lighting entirely)."""
    img_none = _render(None)
    img_empty = _render(())
    assert np.abs(img_none).max() > 0.1
    np.testing.assert_array_equal(img_empty, np.zeros_like(img_empty))


def test_light_base_class_and_subclassing():
    """``Light`` is a real base class -- reference-style
    isinstance checks work, and a user SUBCLASS of a concrete light is
    applied like its parent (torch semantics)."""
    import jax.numpy as jnp

    from neural_renderer_v2_jax.models.lights import (
        AmbientLight, DirectionalLight, Light, SpecularLight,
    )
    from neural_renderer_v2_jax.ops.shading import apply_lights_planar

    amb = AmbientLight(color=jnp.ones((1, 3)) * 0.25)
    assert isinstance(amb, Light)
    assert all(
        issubclass(c, Light)
        for c in (AmbientLight, DirectionalLight, SpecularLight)
    )

    class TintedAmbient(AmbientLight):
        pass

    rgb = jnp.ones((1, 3, 4, 4))
    normals = jnp.zeros((1, 3, 4, 4))
    out_sub = apply_lights_planar(rgb, normals, (TintedAmbient(color=jnp.ones((1, 3)) * 0.25),))
    out_base = apply_lights_planar(rgb, normals, (amb,))
    np.testing.assert_array_equal(np.asarray(out_sub), np.asarray(out_base))
