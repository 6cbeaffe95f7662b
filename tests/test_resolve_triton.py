"""The Triton resolve (ops/resolve_triton.py) against the XLA scan, in the
Pallas interpreter on the CPU; the XLA gather/scatter paths around it;
and the compiled kernel on the card (``chip`` marker).

On the CPU the index maps are bit-exact.  The winning depths agree to
f32 rounding only: XLA contracts the scan's multiply-adds differently
from the interpreter's per-face ops, which moves ``zp`` by an ulp or so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import neural_renderer_v2_jax as nr
from neural_renderer_v2_jax.ops.resolve import compute_face_index_map
from neural_renderer_v2_jax.ops.resolve_triton import (
    compute_face_index_map_triton,
)


def _knot_faces(knot, views=1, azimuth=45):
    v, f = knot
    r = nr.Renderer()
    eyes = np.array(
        [nr.get_points_from_angles(2.732, 30, azimuth + 90 * i) for i in range(views)],
        np.float32,
    )
    r.viewpoints = eyes
    tv = r.transform_vertices(jnp.broadcast_to(jnp.asarray(v), (views,) + v.shape))
    return jnp.take(tv, jnp.asarray(f), axis=1)


def _soup(rng, bs, nf, lo=0.1):
    fv = rng.uniform(-1, 1, (bs, nf, 3, 3)).astype("float32")
    fv[..., 2] = np.abs(fv[..., 2]) + lo
    return fv


def _check(fv, size, **kw):
    ref_i, ref_d = compute_face_index_map(
        jnp.asarray(fv), size, return_depth=True, **kw
    )
    got_i, got_d = compute_face_index_map_triton(
        jnp.asarray(fv), size, return_depth=True, interpret=True, **kw
    )
    ref_i, got_i = np.asarray(ref_i), np.asarray(got_i)
    np.testing.assert_array_equal(got_i, ref_i)
    # depth feeds only the face-sharded combine, whose accept band is 1e-4
    np.testing.assert_allclose(np.asarray(got_d), np.asarray(ref_d), rtol=1e-4)
    return ref_i


@pytest.mark.parametrize("draw_backside", [True, False])
def test_knot_matches_xla(knot, draw_backside):
    fim = _check(_knot_faces(knot), 96, draw_backside=draw_backside)
    assert 0.05 < (fim >= 0).mean() < 0.5


def test_backside_culling_removes_only_back_faces(knot):
    """The knot is closed and wound like the reference's meshes: culling
    back faces must leave the visible faces (all but grazing rim pixels)."""
    fv = _knot_faces(knot)
    a = compute_face_index_map_triton(fv, 64, draw_backside=True, interpret=True)
    b = compute_face_index_map_triton(fv, 64, draw_backside=False, interpret=True)
    a, b = np.asarray(a), np.asarray(b)
    assert (a == b).mean() > 0.999
    assert (b >= 0).sum() >= 0.99 * (a >= 0).sum()


@pytest.mark.parametrize("nf", [1, 31, 33, 100])
def test_batched_odd_face_counts(nf):
    """Face counts around the culling chunk (32), batch of 3."""
    rng = np.random.RandomState(nf)
    _check(_soup(rng, 3, nf), 40)


@pytest.mark.parametrize("size", [17, 75, 100, 136])
def test_non_power_of_two_sizes(size):
    """The canvas pads to whole tiles and crops."""
    rng = np.random.RandomState(size)
    _check(_soup(rng, 1, 23, lo=0.5), size)


@pytest.mark.parametrize("tile,chunk", [((16, 64), 16), ((8, 32), 64), ((64, 64), 8)])
def test_tile_and_chunk_shapes(knot, tile, chunk):
    """Other tile and chunk shapes give the same map (the schedule never
    changes the result)."""
    fv = _knot_faces(knot, views=2)
    ref = np.asarray(compute_face_index_map(fv, 48))
    got = compute_face_index_map_triton(fv, 48, interpret=True, tile=tile, chunk=chunk)
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_row_window_with_traced_start(knot):
    """The tile-sharded path renders a band of rows from a traced
    row_start; each band must equal that band of the full image."""
    fv = _knot_faces(knot)
    full = np.asarray(compute_face_index_map(fv, 64))

    @jax.jit
    def band(r):
        return compute_face_index_map_triton(
            fv, 64, row_start=r, num_rows=24, interpret=True
        )

    for r in (0, 20, 40):
        np.testing.assert_array_equal(np.asarray(band(r)), full[:, r:r + 24])


def test_degenerate_clipped_and_duplicate_faces():
    """Duplicates (the earlier face wins), zero-area faces, faces past the
    near and far planes, and a NaN face."""
    rng = np.random.RandomState(3)
    fv = _soup(rng, 2, 12)
    fv[:, 1] = fv[:, 0]                      # exact duplicate
    fv[:, 2, 1] = fv[:, 2, 0]                # degenerate edge
    fv[:, 3, :, 2] = 0.05                    # in front of near
    fv[:, 4, :, 2] = 200.0                   # behind far
    fv[:, 5, 0, 0] = np.nan
    fim = _check(fv, 32)
    assert not np.isin(fim, [1, 2, 3, 4, 5]).any()


def test_fuzz_random_scenes():
    rng = np.random.RandomState(123)
    for _ in range(4):
        bs = int(rng.randint(1, 4))
        nf = int(rng.choice([3, 17, 100]))
        size = int(rng.choice([24, 40]))
        backside = bool(rng.rand() < 0.5)
        fv = _soup(rng, bs, nf)
        if nf > 4:
            fv[:, 1] = fv[:, 0]
            fv[:, 2, 1] = fv[:, 2, 0]
        _check(fv, size, draw_backside=backside)


def test_face_sharded_resolve_with_depth(knot):
    """The face-sharded resolve runs the kernel per shard and combines the
    (index, depth) pairs; it must reproduce the single-device map."""
    from neural_renderer_v2_jax.parallel import make_mesh
    from neural_renderer_v2_jax.parallel.faces import (
        compute_face_index_map_face_sharded,
    )
    from neural_renderer_v2_jax.parallel.render import _shard_map
    from jax.sharding import PartitionSpec as P

    fv = _knot_faces(knot, views=2)[:, :-1]  # odd count: shards pad
    mesh = make_mesh(data=1, tile=1, face=4, devices=jax.devices()[:4])

    def local(fv):
        return compute_face_index_map_face_sharded(
            fv, 48, backend="triton", interpret=True
        )

    got = _shard_map(local, mesh, (P(),), P())(fv)
    want = compute_face_index_map(fv, 48)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_compiled_kernel_needs_gpu_or_interpret():
    fv = jnp.asarray(_soup(np.random.RandomState(0), 1, 4))
    with pytest.raises(ValueError, match="interpret=True"):
        compute_face_index_map_triton(fv, 16)
    from neural_renderer_v2_jax.ops.gather_resolve import face_index_map

    with pytest.raises(ValueError, match="unknown resolve backend"):
        face_index_map(fv, 16, 0.1, 100.0, True, "pallas")


def test_resolve_and_gather_backends_agree():
    """resolve_and_gather on both backends: same index map, same planes,
    same gradients (the gather and its scatter are shared XLA code)."""
    from neural_renderer_v2_jax.ops.gather_resolve import resolve_and_gather

    rng = np.random.RandomState(21)
    fv = jnp.asarray(_soup(rng, 2, 29, lo=0.4))
    attrs = jnp.asarray(rng.randn(2, 29, 5).astype("float32"))
    cot = jnp.asarray(rng.randn(2, 9, 48, 48).astype("float32"))
    cot_a = jnp.asarray(rng.randn(2, 5, 48, 48).astype("float32"))

    def run(backend):
        def loss(f, a):
            _, fvm, ap = resolve_and_gather(
                f, a, 0, 48, 0.1, 100.0, True, backend, None, True,
                backend == "triton",
            )
            return jnp.sum(fvm * cot) + jnp.sum(ap * cot_a)

        out = resolve_and_gather(
            fv, attrs, 0, 48, 0.1, 100.0, True, backend, None, True,
            backend == "triton",
        )
        return out, jax.grad(loss, argnums=(0, 1))(fv, attrs)

    (ox, gx), (ot, gt) = run("xla"), run("triton")
    for a, b in zip(ox, ot):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(gx, gt):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_scatter_to_faces_matches_scatter_add():
    """The winner-gather transpose (masked segment-sum) against an
    explicit scatter-add, with background pixels and odd face counts."""
    from neural_renderer_v2_jax.ops.gather_resolve import _scatter_to_faces

    rng = np.random.RandomState(2)
    nf = 37
    fim = rng.randint(-1, nf, size=(2, 32, 32)).astype("int32")
    g = rng.randn(2, 32, 32, 5).astype("float32")
    got = np.asarray(_scatter_to_faces(jnp.asarray(g), jnp.asarray(fim), nf))
    want = np.zeros((2, nf, 5), np.float32)
    for b in range(2):
        m = fim[b] >= 0
        np.add.at(want[b], fim[b][m], g[b][m])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gather_face_vertices_grad_matches_autodiff():
    """The face-vertex gather's segment-sum transpose against XLA's own
    gradient of the gather, with heavy vertex sharing and unused
    vertices."""
    from neural_renderer_v2_jax.ops.gather_resolve import gather_face_vertices

    rng = np.random.RandomState(13)
    nv, nf, bs = 29, 53, 2
    vertices = jnp.asarray(rng.randn(bs, nv, 3).astype("float32"))
    faces = jnp.asarray(rng.randint(0, nv, size=(nf, 3)).astype("int32"))
    cotan = rng.randn(bs, nf, 3, 3).astype("float32")

    g = jax.grad(lambda v: jnp.sum(gather_face_vertices(v, faces) * cotan))(vertices)
    want = jax.grad(lambda v: jnp.sum(jnp.take(v, faces, axis=1) * cotan))(vertices)
    np.testing.assert_allclose(np.asarray(g), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(gather_face_vertices(vertices, faces)),
        np.asarray(jnp.take(vertices, faces, axis=1)),
    )


@pytest.mark.parametrize("bs,th,tw,P", [(2, 37, 53, 500), (1, 8, 8, 64)])
def test_atlas_taps_texture_grads_match_autodiff(bs, th, tw, P):
    """The quad-merged texture-gradient backward against plain autodiff
    of the four tap gathers, with taps crossing row boundaries."""
    from neural_renderer_v2_jax.ops.shading import _atlas_taps, _atlas_taps_impl

    rng = np.random.RandomState(15)
    T = th * tw
    flat = jnp.asarray(rng.rand(bs, 3, T).astype("float32"))
    idx = jnp.asarray(rng.randint(0, T - tw - 2, size=(bs, P)).astype("int32"))
    cotan = rng.randn(bs, 4, 3, P).astype("float32")

    g = jax.grad(lambda f: jnp.sum(_atlas_taps(f, idx, tw) * cotan))(flat)
    want = jax.grad(lambda f: jnp.sum(_atlas_taps_impl(f, idx, tw) * cotan))(flat)
    scale = max(np.abs(np.asarray(want)).max(), 1e-6)
    np.testing.assert_allclose(np.asarray(g), np.asarray(want), atol=1e-5 * scale)


@pytest.mark.chip
def test_compiled_kernel_on_gpu(chip, knot):
    """The compiled kernel on the card against the XLA scan: at least
    99.99% of index pixels equal (Triton and XLA contract multiply-adds
    into FMAs differently, which can flip a pixel centre on an edge), and
    equal pixels' depths within 1e-5 relative."""
    fv = _knot_faces(knot, views=4)
    ik, dk = compute_face_index_map_triton(fv, 256, return_depth=True)
    ix, dx = compute_face_index_map(fv, 256, return_depth=True)
    ik, dk, ix, dx = (np.asarray(x) for x in (ik, dk, ix, dx))
    assert (ik == ix).mean() >= 0.9999
    same = (ik == ix) & (ix >= 0)
    np.testing.assert_allclose(dk[same], dx[same], rtol=1e-5)


@pytest.mark.chip
def test_compiled_pipeline_on_gpu(chip, knot):
    """A textured render and its gradients through the public entry point,
    kernel against XLA, on the card."""
    v, f = knot
    vt, ft, tex = nr.create_textures(f.shape[0], texture_size=2)
    r = nr.Renderer()
    r.image_size = 128
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 45)

    def loss(vertices, backend):
        r.backend = backend
        img = r.render(vertices[None], f, vt[None], ft, tex[None])
        return jnp.sum(img ** 2)

    vs = jnp.asarray(v)
    gk = np.asarray(jax.grad(lambda x: loss(x, "triton"))(vs))
    gx = np.asarray(jax.grad(lambda x: loss(x, "xla"))(vs))
    assert np.abs(gk - gx).max() <= 1e-4 * np.abs(gx).max()
