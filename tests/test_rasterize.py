"""Rasterizer forward/backward parity tests.

Oracles (in order of strength):
  1. External golden images shipped with the reference:
     - ``teapot_blender.png``  (Blender render; silhouette oracle used by
       tests_chainer/test_rasterize.py:24-41)
     - ``<model-id>.png``      (textured RGBA render validated against the
       chainer implementation at allclose atol=1e-2,
       tests_chainer/test_rasterize.py:43-72)
     - ``teapot_depth.png``    (Blender depth)
  2. End-to-end optimization convergence (tests_torch/test_rasterize.py:
     205-249): the approximate gradients must actually optimize.
  3. Internal invariants (batch independence, weight-map normalization).

Note on tolerances: the reference compares two CUDA implementations on the
same GPU (bitwise-correlated float paths) and uses atol=2e-3/1e-2.  We run
a different float pipeline, so a handful of z-fight/edge pixels can
legitimately differ; the assertions bound the *fraction* of differing
pixels and the mean error instead of demanding per-pixel allclose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import neural_renderer_v2_jax as nr
from neural_renderer_v2_jax.ops.rasterize import (
    RasterizeHyperparam,
    rasterize_silhouettes,
)


def test_silhouette_vs_blender_golden(reference_data):
    """Binary teapot silhouette vs the Blender golden
    (chainer stest_forward_case1 config: AA off, viewpoint (2.732, 0, 0))."""
    import imageio.v2 as iio

    ref = iio.imread(reference_data / "teapot_blender.png")
    ref = (ref.min(-1) != 255).astype("float32")

    vertices, faces = nr.load_obj(str(reference_data / "teapot.obj"))
    renderer = nr.Renderer()
    renderer.anti_aliasing = False
    renderer.viewpoints = nr.get_points_from_angles(2.732, 0, 0)
    image = np.asarray(renderer.render_silhouettes(vertices[None], faces))[0]

    diff = np.abs(image - ref)
    assert diff.mean() < 2e-3
    assert (diff > 0.5).mean() < 2e-3  # only boundary pixels may differ


def test_batch_independence(knot):
    """Rendering a batch where only slot 2 holds the mesh must equal the
    single-mesh render in slot 2 and empty images elsewhere
    (the reference's target_num pattern, tests_torch/test_rasterize.py:18-41)."""
    vertices, faces = knot
    vertices_batch = np.tile(vertices[None], (4, 1, 1)) * 0
    vertices_batch[2] = vertices

    renderer = nr.Renderer()
    renderer.anti_aliasing = False
    renderer.viewpoints = nr.get_points_from_angles(2.732, 0, 0)
    batch_images = np.asarray(renderer.render_silhouettes(vertices_batch, faces))
    single = np.asarray(renderer.render_silhouettes(vertices[None], faces))[0]

    np.testing.assert_allclose(batch_images[2], single, atol=1e-6)
    assert batch_images[0].sum() == 0
    assert batch_images[1].sum() == 0
    assert batch_images[3].sum() == 0


def test_textured_render_vs_golden(reference_data):
    """Full textured RGBA render (UV atlas, perspective-correct sampling,
    backface culling) vs the shipped golden PNG
    (chainer test_forward_case2 config)."""
    name = "4e49873292196f02574b5684eaec43e9"
    ref = nr.imread(str(reference_data / ("%s.png" % name)))
    v, f, vt, ft, tex = nr.load_obj(
        str(reference_data / name / "model.obj"), load_textures=True
    )
    renderer = nr.Renderer()
    renderer.draw_backside = False
    renderer.viewpoints = nr.get_points_from_angles(2.5, 10, -90)
    images = np.asarray(renderer.render(v[None], f, vt[None], ft, tex[None]))
    image = images[0].transpose(1, 2, 0)

    assert image.shape == ref.shape
    d = np.abs(ref - image)
    assert d.mean() < 1e-3
    assert (d.max(-1) > 1e-2).mean() < 1e-3  # < 0.1% of pixels off


def test_depth_render_finite_and_ordered(knot):
    """Depth map sanity: foreground depths within [near, far], background 0."""
    vertices, faces = knot
    renderer = nr.Renderer()
    renderer.anti_aliasing = False
    renderer.viewpoints = nr.get_points_from_angles(2, 30.0, 0)
    depth = np.asarray(renderer.render_depth(vertices[None], faces))[0]

    fg = depth > 0
    assert fg.any()
    assert depth[fg].min() > 0.1
    assert depth[fg].max() < 100.0
    # a unit-box mesh at distance 2: depths around 1..3
    assert 1.0 < depth[fg].mean() < 3.0


def test_depth_render_vs_blender_golden(reference_data):
    """Min-max-normalized depth vs the shipped Blender depth golden
    (teapot_depth.png), the config of the reference's depth oracle
    (tests_chainer/test_rasterize.py stest_forward_case3 / the live
    chainer-vs-torch variant tests_torch/test_rasterize.py:83-112:
    viewpoint (2, 30, 0), AA off, normalize by (d-min)/(max-min)).

    The golden comes from a different renderer (Blender) and is uint8-
    quantized, so per-pixel allclose at the cross-CUDA 2e-3 is not honest;
    we bound the mean (measured 2.6e-4) and the fraction of off pixels
    (measured: ONE boundary pixel)."""
    import imageio.v2 as iio

    ref = iio.imread(reference_data / "teapot_depth.png").astype("float32") / 255.0
    vertices, faces = nr.load_obj(str(reference_data / "teapot.obj"))
    renderer = nr.Renderer()
    renderer.anti_aliasing = False
    renderer.viewpoints = nr.get_points_from_angles(2, 30.0, 0)
    depth = np.asarray(renderer.render_depth(vertices[None], faces))[0]
    norm = (depth - depth.min()) / (depth.max() - depth.min())

    err = np.abs(norm - ref)
    assert err.mean() < 1e-3
    assert (err > 1e-2).mean() < 1e-4  # isolated boundary pixels only


def test_second_textured_golden(reference_data):
    """The multi-material / flat-Kd atlas golden
    (1cde62b063e14777c9152a706245d48.png, validated by
    tests_chainer/test_rasterize.py:43-72 with viewpoint (2.5, 10, 60),
    draw_backside off).  NOTE: the reference checkout ships only
    ``model.mtl`` for this asset -- ``model.obj`` (and its texture images)
    are missing from BOTH tests_torch/data and tests_chainer/data -- so
    the render cannot be reproduced; the test runs in full whenever the
    asset is present."""
    name = "1cde62b063e14777c9152a706245d48"
    obj = reference_data / name / "model.obj"
    if not obj.exists():
        pytest.skip(
            "reference checkout ships only model.mtl for %s (no model.obj)"
            % name
        )
    ref = nr.imread(str(reference_data / ("%s.png" % name)))
    v, f, vt, ft, tex = nr.load_obj(str(obj), load_textures=True)
    renderer = nr.Renderer()
    renderer.draw_backside = False
    renderer.viewpoints = nr.get_points_from_angles(2.5, 10, 60)
    images = np.asarray(renderer.render(v[None], f, vt[None], ft, tex[None]))
    image = images[0].transpose(1, 2, 0)
    d = np.abs(ref - image)
    assert d.mean() < 1e-3
    assert (d.max(-1) > 1e-2).mean() < 1e-3


def test_silhouette_fit_convergence(reference_data):
    """The NMR gradient north star (tests_torch/test_rasterize.py:205-249):
    optimize a 2-triangle square to match gradient.png; IoU loss must drop
    below 0.01 within 350 Adam(lr=0.005) steps."""
    ref = nr.imread(str(reference_data / "gradient.png"))
    ref = 1 - ref
    ref = jnp.asarray(ref[:, :, 0])

    vertices = jnp.asarray(
        np.array(
            [[0.1, 0.1, 1.0], [-0.1, 0.1, 1.0], [-0.1, -0.1, 1.0], [0.1, -0.1, 1.0]],
            "float32",
        )
    )
    faces = jnp.asarray(np.array([[0, 1, 2], [0, 2, 3]], "int32"))
    hyper = RasterizeHyperparam(image_size=256, anti_aliasing=False)

    opt = optax.adam(0.005)
    opt_state = opt.init(vertices)

    @jax.jit
    def step(vertices, opt_state):
        def loss_fn(v):
            images = rasterize_silhouettes(v[None], faces, None, hyper)
            image = images[0]
            iou = jnp.sum(image * ref) / jnp.sum(image + ref - image * ref)
            return 1.0 - iou

        loss, grads = jax.value_and_grad(loss_fn)(vertices)
        updates, opt_state = opt.update(grads, opt_state)
        vertices = optax.apply_updates(vertices, updates)
        return vertices, opt_state, loss

    losses = []
    for i in range(350):
        vertices, opt_state, loss = step(vertices, opt_state)
        losses.append(float(loss))
        if losses[-1] < 0.01:
            break
    assert losses[-1] < 0.01, "did not converge: last losses %s" % losses[-5:]


def test_weight_map_properties(knot):
    """Foreground weights sum to 1 and lie in [0,1]; background weights 0."""
    from neural_renderer_v2_jax.ops.resolve import (
        compute_face_index_map,
        compute_weight_map,
    )

    vertices, faces = knot
    renderer = nr.Renderer()
    renderer.viewpoints = nr.get_points_from_angles(2.732, 30, 0)
    tv = renderer.transform_vertices(jnp.asarray(vertices[None]))
    fv = jnp.take(tv, jnp.asarray(faces), axis=1)
    fim = compute_face_index_map(fv, 128, 0.1, 100.0, True, 16)
    wm = np.asarray(compute_weight_map(fv, fim))
    fim = np.asarray(fim)

    fg = fim >= 0
    assert fg.any()
    np.testing.assert_allclose(wm[fg].sum(-1), 1.0, atol=1e-5)
    assert wm.min() >= 0.0
    assert wm.max() <= 1.0
    assert np.all(wm[~fg] == 0)


def test_to_map_and_mask_foreground():
    from neural_renderer_v2_jax.ops.maps import mask_foreground, to_map

    rng = np.random.RandomState(0)
    data = jnp.asarray(rng.randn(2, 5, 3).astype("float32"))
    idx = jnp.asarray(
        np.array([[[0, -1], [4, 2]], [[-1, -1], [1, 3]]], "int32")
    )  # [2, 2, 2]
    out = np.asarray(to_map(data, idx))
    assert out.shape == (2, 2, 2, 3)
    np.testing.assert_allclose(out[0, 0, 0], np.asarray(data)[0, 0])
    np.testing.assert_allclose(out[0, 0, 1], 0)
    np.testing.assert_allclose(out[1, 1, 1], np.asarray(data)[1, 3])

    # gradient of to_map is scatter-add into data
    def f(d):
        return jnp.sum(to_map(d, idx) * 2.0)

    g = np.asarray(jax.grad(f)(data))
    assert g[0, 0].sum() == pytest.approx(6.0)  # used once, 3 channels * 2
    assert g[1, 0].sum() == 0  # never gathered

    x = jnp.asarray(rng.randn(2, 2, 2, 3).astype("float32"))
    masked = np.asarray(mask_foreground(x, idx))
    assert np.all(masked[np.asarray(idx) < 0] == 0)


def test_render_channel_shapes(knot):
    vertices, faces = knot
    vt, ft, tex = nr.create_textures(faces.shape[0], texture_size=2)
    renderer = nr.Renderer()
    renderer.image_size = 64
    renderer.viewpoints = nr.get_points_from_angles(2.732, 30, 0)

    sil = renderer.render_silhouettes(vertices[None], faces)
    assert sil.shape == (1, 64, 64)
    rgba = renderer.render(vertices[None], faces, vt[None], ft, tex[None])
    assert rgba.shape == (1, 4, 64, 64)
    rgb = renderer.render_rgb(vertices[None], faces, vt[None], ft, tex[None])
    assert rgb.shape == (1, 3, 64, 64)
    depth = renderer.render_depth(vertices[None], faces)
    assert depth.shape == (1, 64, 64)


def test_rasterize_all_matches_individual_channels(knot):
    """rasterize_all (chainer rasterize_all parity, rasterize.py:614-766)
    draws RGB + silhouette + depth in one pass; each channel must match
    the dedicated entry point."""
    from neural_renderer_v2_jax.ops.rasterize import (
        rasterize_all,
        rasterize_depth,
        rasterize_rgb,
        rasterize_silhouettes,
        RasterizeParam,
    )

    vertices, faces = knot
    vt, ft, tex = nr.create_textures(faces.shape[0], texture_size=2)
    renderer = nr.Renderer()
    renderer.viewpoints = nr.get_points_from_angles(2.732, 30, 45)
    tv = renderer.transform_vertices(jnp.asarray(vertices[None]))
    F = jnp.asarray(faces)
    params = RasterizeParam(
        vertices_textures=jnp.asarray(vt[None]),
        faces_textures=jnp.asarray(ft),
        textures=jnp.asarray(tex[None]),
    )
    hp = RasterizeHyperparam(image_size=64, anti_aliasing=False)

    allc = np.asarray(rasterize_all(tv, F, params, hp))
    assert allc.shape == (1, 5, 64, 64)
    rgb = np.asarray(rasterize_rgb(tv, F, params, hp))
    sil = np.asarray(rasterize_silhouettes(tv, F, params, hp))
    dep = np.asarray(rasterize_depth(tv, F, params, hp))
    np.testing.assert_allclose(allc[:, :3], rgb, atol=1e-6)
    np.testing.assert_allclose(allc[:, 3], sil, atol=1e-6)
    np.testing.assert_allclose(allc[:, 4], dep, atol=1e-6)


def test_custom_adam_param_wise_lr():
    """utils/optim.adam (reference chainer AdamRule parity,
    optimizers.py:6-37): per-parameter lr, frozen at lr=0."""
    import jax

    params = {"a": jnp.ones(3), "b": jnp.ones(3)}
    grads = {"a": jnp.ones(3), "b": jnp.ones(3)}
    opt = nr.adam(lr=0.1, param_lrs={"a": 0.0, "b": None})
    state = opt.init(params)
    updates, state = opt.update(grads, state)
    import optax

    new = optax.apply_updates(params, updates)
    np.testing.assert_array_equal(np.asarray(new["a"]), np.ones(3))  # frozen
    assert np.all(np.asarray(new["b"]) < 1.0)                        # stepped
    # reference Adam step size at t=1 is ~lr
    np.testing.assert_allclose(np.asarray(new["b"]), 1.0 - 0.1, atol=1e-3)


def test_batch_chunked_render_bit_exact(knot):
    """batch_chunk (the large-bs lax.map split) is bit-identical to the
    monolithic render -- values AND vertex gradients -- at a bs that is
    not a multiple of the chunk, for silhouettes and textured+lit RGBA
    with a background color."""
    from neural_renderer_v2_jax.models.lights import (
        AmbientLight,
        DirectionalLight,
    )
    from neural_renderer_v2_jax.ops.camera import look_at, perspective
    from neural_renderer_v2_jax.ops.rasterize import (
        RasterizeParam,
        rasterize_rgba,
    )
    from neural_renderer_v2_jax.utils.helpers import create_textures

    vertices, faces = knot
    bs = 10
    eyes = np.stack(
        [
            np.array(nr.get_points_from_angles(2.732, 30, 36 * i), "float32")
            for i in range(bs)
        ]
    )
    tv = perspective(
        look_at(jnp.broadcast_to(jnp.asarray(vertices[None]), (bs,) + vertices.shape), eyes),
        angle=30.0,
    )
    F = np.asarray(faces)
    hp0 = RasterizeHyperparam(image_size=64, batch_chunk=None)
    hp4 = RasterizeHyperparam(image_size=64, batch_chunk=4)

    a = rasterize_silhouettes(tv, F, None, hp0)
    b = rasterize_silhouettes(tv, F, None, hp4)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # the exact-divisor split (round 5): bs=10 with batch_chunk=6 takes
    # the divisor path (bc=5, two padless chunks; 5 >= 3/4 * 6) -- must
    # stay bit-equal to the monolithic render
    hp6 = RasterizeHyperparam(image_size=64, batch_chunk=6)
    c = rasterize_silhouettes(tv, F, None, hp6)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(c))

    vt, ft, tex = create_textures(F.shape[0], texture_size=2)
    params = RasterizeParam(
        vertices_textures=jnp.broadcast_to(jnp.asarray(vt[None]), (bs,) + vt.shape),
        faces_textures=np.asarray(ft),
        textures=jnp.broadcast_to(jnp.asarray(tex[None]), (bs,) + tex.shape),
        texture_size=2,
        background_color=(0.2, 0.3, 0.4),
        lights=(
            AmbientLight(color=jnp.full((bs, 3), 0.4)),
            DirectionalLight(
                color=jnp.full((bs, 3), 0.6),
                direction=jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (bs, 1)),
            ),
        ),
    )
    np.testing.assert_array_equal(
        np.asarray(rasterize_rgba(tv, F, params, hp0)),
        np.asarray(rasterize_rgba(tv, F, params, hp4)),
    )

    def loss(x, hp):
        return jnp.sum(rasterize_silhouettes(x, F, None, hp) ** 2)

    ga = jax.grad(lambda x: loss(x, hp0))(tv)
    gb = jax.grad(lambda x: loss(x, hp4))(tv)
    np.testing.assert_array_equal(np.asarray(ga), np.asarray(gb))


def test_odd_image_size_renders(knot, monkeypatch):
    """Sizes that are not a multiple of the kernel's tile run the Triton
    resolve (padded canvas + crop inside the op -- no silent XLA
    fallback) and match the XLA pipeline bit-exactly, values and
    gradients."""
    from neural_renderer_v2_jax.ops import gather_resolve

    vertices, faces = knot
    renderer = nr.Renderer()
    renderer.viewpoints = nr.get_points_from_angles(2.732, 30, 45)
    tv = renderer.transform_vertices(jnp.asarray(vertices[None]))

    calls = []
    real = gather_resolve.compute_face_index_map_triton

    def spy(*args, **kw):
        calls.append(kw.get("num_rows"))
        return real(*args, **kw)

    monkeypatch.setattr(gather_resolve, "compute_face_index_map_triton", spy)
    hp = RasterizeHyperparam(image_size=50, interpret=True)  # 100 rows with AA
    sil = np.asarray(
        rasterize_silhouettes(tv, faces, None, hp.replace(backend="triton"))
    )
    assert sil.shape == (1, 50, 50)
    assert 0.05 < sil.mean() < 0.3
    assert calls, "the Triton backend was not used for the odd size"
    np.testing.assert_array_equal(
        sil, np.asarray(rasterize_silhouettes(tv, faces, None, hp.replace(backend="xla")))
    )

    # bit-exact vs the XLA resolve at an odd width, no AA, gradients too
    hp = RasterizeHyperparam(image_size=75, anti_aliasing=False, interpret=True)
    ref = np.random.RandomState(3).rand(1, 75, 75).astype("float32")

    def loss(tv, backend):
        return jnp.sum(
            rasterize_silhouettes(tv, faces, None, hp.replace(backend=backend))
            * ref
        )

    g_tri = np.asarray(jax.grad(lambda v: loss(v, "triton"))(tv))
    g_xla = np.asarray(jax.grad(lambda v: loss(v, "xla"))(tv))
    np.testing.assert_array_equal(g_tri, g_xla)


def test_renderer_look_mode_and_background_image(knot):
    """Facade coverage for the remaining Renderer attributes: 
    camera_mode='look' (fixed gaze direction) must match the manual
    look() pipeline, and a full background IMAGE (not just a color) must
    show through unchanged on background pixels (the reference blends
    pre-flip, chainer rasterize.py:574-577)."""
    import jax.numpy as jnp

    from neural_renderer_v2_jax.ops.camera import look, perspective as persp
    from neural_renderer_v2_jax.ops.rasterize import (
        rasterize_silhouettes as rs,
    )

    vertices, faces = knot
    renderer = nr.Renderer()
    renderer.image_size = 64
    renderer.anti_aliasing = False
    renderer.camera_mode = "look"
    renderer.viewpoints = [0.0, 0.0, -2.732]
    got = np.asarray(renderer.render_silhouettes(vertices[None], faces))

    tv = persp(
        look(jnp.asarray(vertices[None]), jnp.asarray([0.0, 0.0, -2.732])),
        angle=30.0,
    )
    hp = RasterizeHyperparam(image_size=64, anti_aliasing=False)
    want = np.asarray(rs(tv, jnp.asarray(faces), None, hp))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0

    # background image passes through on background pixels
    vt, ft, tex = nr.create_textures(faces.shape[0], texture_size=2)
    renderer2 = nr.Renderer()
    renderer2.image_size = 64
    renderer2.anti_aliasing = False
    renderer2.viewpoints = nr.get_points_from_angles(2.732, 30, 0)
    rng = np.random.RandomState(3)
    bg = rng.rand(1, 3, 64, 64).astype("float32")
    rgba = np.asarray(
        renderer2.render(vertices[None], faces, vt[None], ft, tex[None],
                         backgrounds=jnp.asarray(bg))
    )
    sil = rgba[0, 3]
    mask = sil == 0
    assert mask.any() and (~mask).any()
    np.testing.assert_allclose(
        rgba[0, :3].transpose(1, 2, 0)[mask],
        bg[0].transpose(1, 2, 0)[mask],
        atol=1e-6,
    )


def test_pick_batch_chunk_geometry():
    """The sub-batch chooser: exact divisors >= 3/4 of the requested
    chunk beat padded splits; primes fall back to balanced padding."""
    from neural_renderer_v2_jax.ops.rasterize import _pick_batch_chunk

    assert _pick_batch_chunk(30, 8) == (6, 5, 0)
    assert _pick_batch_chunk(16, 8) == (8, 2, 0)
    assert _pick_batch_chunk(12, 8) == (6, 2, 0)
    assert _pick_batch_chunk(10, 6) == (5, 2, 0)
    assert _pick_batch_chunk(9, 8) == (5, 2, 1)     # balanced fallback
    assert _pick_batch_chunk(11, 8) == (6, 2, 1)
    assert _pick_batch_chunk(10, 8) == (5, 2, 0)    # balanced happens to divide
