"""Multi-device sharding tests on the 8-virtual-CPU-device mesh.

The (data, tile) shard_map path must match the single-device pipeline:
forward bit-exact (row-local compute), gradients up to psum reduction
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
    rasterize_silhouettes,
)
from neural_renderer_v2_jax.parallel import (
    make_mesh,
    rasterize_rgb_sharded,
    rasterize_silhouettes_sharded,
)


@pytest.fixture(scope="module")
def teapot(knot):
    """The generated 2,464-face mesh (the reference teapot's size)."""
    return knot


def _hp(backend="xla", **kw):
    """Hyperparams for a backend; the Triton kernel runs interpreted."""
    return RasterizeHyperparam(
        backend=backend, interpret=backend == "triton", **kw
    )


@pytest.fixture(scope="module")
def transformed_batch(teapot):
    v, f = teapot
    renderer = nr.Renderer()
    renderer.viewpoints = nr.get_points_from_angles(2.732, 30, 15)
    tv = renderer.transform_vertices(jnp.asarray(np.tile(v[None], (2, 1, 1))))
    return tv, jnp.asarray(f)


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_sharded_silhouette_matches_single(transformed_batch, backend):
    """Tile sharding must be bit-exact vs the single-device XLA pipeline
    with BOTH backends: the Triton kernel (interpret mode on CPU) runs
    under the row-window shard_map path."""
    tv, f = transformed_batch
    mesh = make_mesh(data=2, tile=4)
    hp = _hp(backend, image_size=128, anti_aliasing=False)
    sharded = np.asarray(rasterize_silhouettes_sharded(tv, f, None, hp, mesh=mesh))
    single = np.asarray(
        rasterize_silhouettes(tv, f, None, hp.replace(backend="xla"))
    )
    np.testing.assert_array_equal(sharded, single)


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_sharded_gradients_match_single(transformed_batch, backend):
    tv, f = transformed_batch
    mesh = make_mesh(data=2, tile=4)
    hp = _hp(backend, image_size=128, anti_aliasing=False)
    hp_single = hp.replace(backend="xla")
    ref = jnp.asarray(np.random.RandomState(0).rand(2, 128, 128).astype("float32"))

    def loss_sharded(tv):
        return jnp.sum(rasterize_silhouettes_sharded(tv, f, None, hp, mesh=mesh) * ref)

    def loss_single(tv):
        return jnp.sum(rasterize_silhouettes(tv, f, None, hp_single) * ref)

    g_sh = np.asarray(jax.grad(loss_sharded)(tv))
    g_si = np.asarray(jax.grad(loss_single)(tv))
    scale = np.abs(g_si).max()
    assert scale > 0
    np.testing.assert_allclose(g_sh, g_si, atol=1e-4 * scale)


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_sharded_textured_with_lights(transformed_batch, teapot, backend):
    tv, f = transformed_batch
    _, faces_np = teapot
    vt, ft, tex = nr.create_textures(faces_np.shape[0], texture_size=2)
    bs = 2
    rng = np.random.RandomState(1)
    lights = (
        DirectionalLight(
            color=jnp.asarray(rng.rand(bs, 3).astype("float32")),
            direction=jnp.asarray(rng.rand(bs, 3).astype("float32")),
        ),
        AmbientLight(color=jnp.asarray(rng.rand(bs, 3).astype("float32"))),
        SpecularLight(color=jnp.asarray(rng.rand(bs, 3).astype("float32"))),
    )
    params = RasterizeParam(
        vertices_textures=jnp.asarray(np.tile(vt[None], (bs, 1, 1))),
        faces_textures=jnp.asarray(ft),
        textures=jnp.asarray(np.tile(tex[None], (bs, 1, 1, 1))),
        lights=lights,
    )
    hp = _hp(backend, image_size=64, anti_aliasing=True)
    mesh = make_mesh(data=2, tile=4)
    sharded = np.asarray(rasterize_rgb_sharded(tv, f, params, hp, mesh=mesh))
    single = np.asarray(rasterize_rgb(tv, f, params, hp.replace(backend="xla")))
    # different XLA fusion between the two programs -> f32 noise only
    np.testing.assert_allclose(sharded, single, atol=3e-5)

    # texture gradients all-reduce across tiles correctly
    def loss_sharded(textures):
        p = params.replace(textures=textures)
        return jnp.sum(rasterize_rgb_sharded(tv, f, p, hp, mesh=mesh) ** 2)

    def loss_single(textures):
        p = params.replace(textures=textures)
        return jnp.sum(rasterize_rgb(tv, f, p, hp) ** 2)

    g_sh = np.asarray(jax.grad(loss_sharded)(params.textures))
    g_si = np.asarray(jax.grad(loss_single)(params.textures))
    scale = max(np.abs(g_si).max(), 1e-6)
    np.testing.assert_allclose(g_sh, g_si, atol=1e-4 * scale)


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_face_sharded_silhouette_matches_single(transformed_batch, backend):
    """(data=2, tile=2, face=2): the resolve's face loop distributed with
    the ordered z-combine must reproduce the single-device image (the
    mesh has no cross-shard depth ties within the 1e-4 band); with
    backend='triton' each shard's local resolve runs the kernel."""
    tv, f = transformed_batch
    mesh = make_mesh(data=2, tile=2, face=2)
    hp = _hp(backend, image_size=128, anti_aliasing=False)
    sharded = np.asarray(rasterize_silhouettes_sharded(tv, f, None, hp, mesh=mesh))
    single = np.asarray(
        rasterize_silhouettes(tv, f, None, hp.replace(backend="xla"))
    )
    np.testing.assert_array_equal(sharded, single)


def test_face_only_sharding_textured(transformed_batch, teapot):
    """face=8: textured RGB forward + texture gradients under pure face
    sharding match the single-device pipeline."""
    tv, f = transformed_batch
    _, faces_np = teapot
    vt, ft, tex = nr.create_textures(faces_np.shape[0], texture_size=2)
    bs = 2
    params = RasterizeParam(
        vertices_textures=jnp.asarray(np.tile(vt[None], (bs, 1, 1))),
        faces_textures=jnp.asarray(ft),
        textures=jnp.asarray(np.tile(tex[None], (bs, 1, 1, 1))),
    )
    hp = RasterizeHyperparam(image_size=64, anti_aliasing=False)
    mesh = make_mesh(data=1, tile=1, face=8)
    sharded = np.asarray(rasterize_rgb_sharded(tv, f, params, hp, mesh=mesh))
    single = np.asarray(rasterize_rgb(tv, f, params, hp))
    np.testing.assert_allclose(sharded, single, atol=3e-5)

    def loss_sharded(textures):
        p = params.replace(textures=textures)
        return jnp.sum(rasterize_rgb_sharded(tv, f, p, hp, mesh=mesh) ** 2)

    def loss_single(textures):
        p = params.replace(textures=textures)
        return jnp.sum(rasterize_rgb(tv, f, p, hp) ** 2)

    g_sh = np.asarray(jax.grad(loss_sharded)(params.textures))
    g_si = np.asarray(jax.grad(loss_single)(params.textures))
    scale = max(np.abs(g_si).max(), 1e-6)
    np.testing.assert_allclose(g_sh, g_si, atol=1e-4 * scale)


def test_face_sharded_cross_shard_tie(transformed_batch):
    """Constructed cross-shard depth tie: two coincident triangles whose
    depths differ by 5e-5 (< the 1e-4 accept band), padded so they land
    on DIFFERENT face shards.  The ordered fold must keep the earlier
    face -- same answer as the sequential single-device z-buffer -- and
    the full face-sharded resolve must agree with the single-device map."""
    import jax.numpy as jnp

    from neural_renderer_v2_jax.ops.rasterize import RasterizeParam  # noqa: F401

    tri = np.array(
        [[[-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.0, 0.5, 1.0]]], "float32"
    )
    fv = np.concatenate(
        [tri, np.zeros((3, 3, 3), "float32"), tri + [0, 0, 5e-5]], 0
    )[None]  # face 0 and face 4 tie within the band; 2 shards of 4 w/ face=2
    vertices = jnp.asarray(fv.reshape(1, -1, 3))
    faces = jnp.asarray(np.arange(15).reshape(5, 3).astype("int32"))

    hp = RasterizeHyperparam(image_size=32, anti_aliasing=False)
    mesh = make_mesh(data=1, tile=1, face=2)
    sharded = rasterize_silhouettes_sharded(vertices, faces, None, hp, mesh=mesh)
    single = rasterize_silhouettes(vertices, faces, None, hp)
    np.testing.assert_array_equal(np.asarray(sharded), np.asarray(single))

    from neural_renderer_v2_jax.ops.resolve import compute_face_index_map

    fim = np.asarray(compute_face_index_map(jnp.asarray(fv), 32))
    assert set(np.unique(fim)) == {-1, 0}  # face 4 never displaces face 0


def test_ordered_z_combine_tolerance_band():
    """The shard fold applies the reference's 1e-4 accept rule: a later
    shard's winner within the band does NOT displace the earlier one."""
    from neural_renderer_v2_jax.parallel.faces import ordered_z_combine

    depths = jnp.asarray(
        [[1.0, 1.0], [1.0 - 5e-5, 0.5]], jnp.float32
    )  # shard 1 is within the band at pixel 0, clearly closer at pixel 1
    indices = jnp.asarray([[7, 7], [9, 9]], jnp.int32)
    d, i = ordered_z_combine((depths, indices))
    np.testing.assert_array_equal(np.asarray(i), [7, 9])
    np.testing.assert_allclose(np.asarray(d), [1.0, 0.5])


def test_sharded_texel_fast_path_matches_single(transformed_batch, teapot):
    """params.texture_size must survive the shard_map boundary: the
    gather-free texel fast path has to produce the same image sharded as
    single-device (it is a static field rebuilt inside local_fn)."""
    tv, f = transformed_batch
    _, faces_np = teapot
    vt, ft, tex = nr.create_textures(faces_np.shape[0], texture_size=4)
    bs = 2
    rng = np.random.RandomState(5)
    tex = rng.rand(*tex.shape).astype("float32")
    params = RasterizeParam(
        vertices_textures=jnp.asarray(np.tile(vt[None], (bs, 1, 1))),
        faces_textures=jnp.asarray(ft),
        textures=jnp.asarray(np.tile(tex[None], (bs, 1, 1, 1))),
        texture_size=4,
    )
    hp = RasterizeHyperparam(image_size=64, anti_aliasing=False)
    mesh = make_mesh(data=2, tile=4)
    sharded = np.asarray(rasterize_rgb_sharded(tv, f, params, hp, mesh=mesh))
    single = np.asarray(rasterize_rgb(tv, f, params, hp))
    np.testing.assert_allclose(sharded, single, atol=1e-4)
    # and the fast path must agree with the general atlas sampler (the
    # tap selection and interpolation run in a different op order -> f32
    # noise only)
    general = np.asarray(
        rasterize_rgb(tv, f, params.replace(texture_size=None), hp)
    )
    np.testing.assert_allclose(single, general, atol=1e-4)


def test_auto_mesh_heuristic():
    """auto_mesh: tile-first, a data axis only from 8 devices up."""
    from neural_renderer_v2_jax.parallel.mesh import auto_mesh

    m8 = auto_mesh(8)
    assert dict(m8.shape) == {"data": 2, "tile": 4}
    m4 = auto_mesh(4)
    assert dict(m4.shape) == {"data": 1, "tile": 4}
    m2 = auto_mesh(2)
    assert dict(m2.shape) == {"data": 1, "tile": 2}
    m1 = auto_mesh(1)
    assert dict(m1.shape) == {"data": 1, "tile": 1}


def test_auto_mesh_face_axis():
    """With the face count known, auto_mesh allocates the face axis (the
    dominant-cost divider at north-star face counts) down to the measured
    ~10K-faces-per-shard crossover, and not past it."""
    from neural_renderer_v2_jax.parallel.mesh import auto_mesh

    # 160K faces, 8 devices: data=2, remaining 4 all go to face
    # (160K / 4 = 40K faces/shard, still >= the 10K crossover)
    m = auto_mesh(8, num_faces=160_000)
    assert dict(m.shape) == {"data": 2, "tile": 1, "face": 4}
    # 25K faces: one doubling only (25K/2 >= 10K but 25K/4 < 10K)
    m = auto_mesh(8, num_faces=25_000)
    assert dict(m.shape) == {"data": 2, "tile": 2, "face": 2}
    # small meshes: no face axis -- tile keeps the devices
    m = auto_mesh(8, num_faces=2_500)
    assert dict(m.shape) == {"data": 2, "tile": 4}
    # 4 devices, large mesh: no data axis, face takes what divides
    m = auto_mesh(4, num_faces=160_000)
    assert dict(m.shape) == {"data": 1, "tile": 1, "face": 4}


def test_resolve_and_gather_latch_z_paths():
    """latch_z=False (the silhouette path) must produce the same planes
    on both backends -- XY planes gathered, z planes exactly zero -- and
    route gradients only into vertex XY."""
    from neural_renderer_v2_jax.ops.gather_resolve import (
        resolve_and_gather,
    )

    rng = np.random.RandomState(21)
    fv = rng.uniform(-1, 1, size=(1, 29, 3, 3)).astype("float32")
    fv[..., 2] = np.abs(fv[..., 2]) + 0.4
    FV = jnp.asarray(fv)

    outs = {}
    for backend in ("xla", "triton"):
        fim, fvm, _ = resolve_and_gather(
            FV, None, 0, 64, 0.1, 100.0, True, backend, None, False,
            backend == "triton",
        )
        outs[backend] = (np.asarray(fim), np.asarray(fvm))
    np.testing.assert_array_equal(outs["xla"][0], outs["triton"][0])
    np.testing.assert_array_equal(outs["xla"][1], outs["triton"][1])
    assert np.all(outs["xla"][1][:, (2, 5, 8)] == 0)  # z planes zero

    # full-latch reference: XY planes identical
    _, fvm9, _ = resolve_and_gather(
        FV, None, 0, 64, 0.1, 100.0, True, "xla", None, True
    )
    np.testing.assert_array_equal(
        outs["xla"][1][:, (0, 1, 3, 4, 6, 7)],
        np.asarray(fvm9)[:, (0, 1, 3, 4, 6, 7)],
    )

    cot = rng.randn(1, 9, 64, 64).astype("float32")

    def loss(v, latch_z):
        _, fvm, _ = resolve_and_gather(
            v, None, 0, 64, 0.1, 100.0, True, "xla", None, latch_z
        )
        return jnp.sum(fvm * cot)

    g6 = np.asarray(jax.grad(lambda v: loss(v, False))(FV))
    g9 = np.asarray(jax.grad(lambda v: loss(v, True))(FV))
    assert np.all(g6[..., 2] == 0)  # no z gradient without the z latch
    np.testing.assert_allclose(g6[..., :2], g9[..., :2], atol=1e-6)


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_sharded_aa_uneven_tile_split(transformed_batch, teapot, backend):
    """AA render whose internal row count does NOT divide the tile axis
    (image_size=33 -> 66 rows over tile=4 -> 17 rows/shard, 2 pad rows):
    the pad-rows-and-crop path must reproduce the single-device image
    bit-exactly (forward is row-local) and its gradients, exercising the
    AA pool + NMR-backward halo exchange at uneven shard boundaries."""
    tv, f = transformed_batch
    _, faces_np = teapot
    vt, ft, tex = nr.create_textures(faces_np.shape[0], texture_size=2)
    bs = 2
    params = RasterizeParam(
        vertices_textures=jnp.asarray(np.tile(vt[None], (bs, 1, 1))),
        faces_textures=jnp.asarray(ft),
        textures=jnp.asarray(np.tile(tex[None], (bs, 1, 1, 1))),
    )
    hp = _hp(backend, image_size=33, anti_aliasing=True)
    mesh = make_mesh(data=2, tile=4)
    sharded = np.asarray(rasterize_rgb_sharded(tv, f, params, hp, mesh=mesh))
    single = np.asarray(rasterize_rgb(tv, f, params, hp.replace(backend="xla")))
    np.testing.assert_allclose(sharded, single, atol=3e-5)

    def loss_sharded(tv):
        return jnp.sum(rasterize_rgb_sharded(tv, f, params, hp, mesh=mesh) ** 2)

    def loss_single(tv):
        return jnp.sum(rasterize_rgb(tv, f, params, hp.replace(backend="xla")) ** 2)

    g_sh = np.asarray(jax.grad(loss_sharded)(tv))
    g_si = np.asarray(jax.grad(loss_single)(tv))
    scale = np.abs(g_si).max()
    assert scale > 0
    np.testing.assert_allclose(g_sh, g_si, atol=1e-4 * scale)


def test_tile_only_mesh_batch1(teapot):
    v, f = teapot
    renderer = nr.Renderer()
    renderer.viewpoints = nr.get_points_from_angles(2.732, 0, 0)
    tv = renderer.transform_vertices(jnp.asarray(v[None]))
    mesh = make_mesh(data=1, tile=8)
    hp = RasterizeHyperparam(image_size=256, anti_aliasing=False)
    sharded = np.asarray(
        rasterize_silhouettes_sharded(tv, jnp.asarray(f), None, hp, mesh=mesh)
    )
    single = np.asarray(rasterize_silhouettes(tv, jnp.asarray(f), None, hp))
    np.testing.assert_array_equal(sharded, single)


# ---------------------------------------------------------------------------
# Collective census: the comm model in docs/SCALING.md rests on a specific
# collective inventory.  These tests pin that inventory in the COMPILED HLO
# of the sharded train step, so a GSPMD regression inserting
# reshards/all-to-alls cannot pass silently.


_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
}


def _shape_bytes(shape_str):
    import re

    total = 0
    for dt, dims in re.findall(r"(\w+)\[([0-9,]*)\]", shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _collective_census(hlo_text):
    """op kind -> list of result byte counts, parsing both scalar- and
    tuple-shaped results (XLA fuses multiple psums into ONE tuple
    all-reduce) and async -start forms."""
    import re

    kinds = (
        "all-reduce", "all-gather", "collective-permute", "all-to-all",
        "reduce-scatter",
    )
    census = {k: [] for k in kinds}
    pat = re.compile(
        r"= (\([^)]*\)|\S+) (" + "|".join(kinds) + r")(-start)?\("
    )
    for m in pat.finditer(hlo_text):
        census[m.group(2)].append(_shape_bytes(m.group(1)))
    return census


def _lower_textured_train_step(mesh, size=32):
    from neural_renderer_v2_jax.parallel.render import (
        rasterize_core_sharded,
    )
    from neural_renderer_v2_jax.utils.helpers import create_textures

    from neural_renderer_v2_jax.utils.scenes import torus_knot

    rng = np.random.RandomState(40)
    v, f = torus_knot(seed=0)
    renderer = nr.Renderer()
    renderer.viewpoints = nr.get_points_from_angles(2.732, 30, 15)
    tv = renderer.transform_vertices(jnp.asarray(np.tile(v[None], (2, 1, 1))))
    vt_np, ft, tex_np = create_textures(f.shape[0], texture_size=2)
    tex = jnp.asarray(
        np.tile(tex_np[None], (2, 1, 1, 1))
        * rng.rand(2, 1, 1, 1).astype("float32")
    )
    vt = jnp.asarray(np.tile(vt_np[None], (2, 1, 1)))
    lights = (
        AmbientLight(jnp.ones((2, 3)) * 0.3),
        DirectionalLight(
            jnp.ones((2, 3)) * 0.6,
            jnp.asarray(np.tile([[0.0, 1.0, 0.0]], (2, 1)).astype("float32")),
        ),
    )
    hp = RasterizeHyperparam(image_size=size, anti_aliasing=True, backend="xla")
    faces = jnp.asarray(f)

    def loss(verts, texs):
        p = RasterizeParam(
            vertices_textures=vt, faces_textures=jnp.asarray(ft),
            textures=texs, lights=lights,
        )
        out = rasterize_core_sharded(verts, faces, p, hp, mesh)
        return jnp.sum(out * out)

    step = jax.jit(jax.grad(loss, argnums=(0, 1)))
    hlo = step.lower(tv, tex).compile().as_text()
    render = 2 * size
    shapes = dict(
        n_verts=tv.shape[1], tex=tex.shape, render=render,
        local_bs=2 // mesh.shape["data"],
        local_rows=render // mesh.shape["tile"],
        n_face=dict(mesh.shape).get("face", 1),
    )
    return hlo, shapes


def test_collective_census_data_tile_face():
    """(data=2, tile=2, face=2): exactly ONE all-reduce carrying exactly
    the replicated-grad bytes (vertex + texture grads, fused to a tuple
    by XLA), exactly TWO all-gathers (the face combine's depth f32 + id
    s32 planes over the local pixel band), a bounded set of small
    collective-permutes (the NMR backward's 1-row halos plus the H-flip's
    band exchange across tile shards), and NO all-to-all, reduce-scatter,
    or resharding collectives of any other kind."""
    mesh = make_mesh(data=2, tile=2, face=2)
    hlo, s = _lower_textured_train_step(mesh)
    census = _collective_census(hlo)

    assert census["all-to-all"] == [], census
    assert census["reduce-scatter"] == [], census

    # one fused psum: vertex grads [local_bs, nv, 3] + texture grads
    # [local_bs, 3, th, tw], f32
    grad_bytes = (
        s["local_bs"] * s["n_verts"] * 3 * 4
        + s["local_bs"] * int(np.prod(s["tex"][1:])) * 4
    )
    assert len(census["all-reduce"]) == 1, census
    assert census["all-reduce"][0] == grad_bytes, (
        census["all-reduce"], grad_bytes,
    )

    # the ordered z-combine gathers 2 planes (depth f32, id s32) of the
    # local pixel band across the face axis (parallel/faces.py:114-115)
    plane = s["n_face"] * s["local_bs"] * s["local_rows"] * s["render"] * 4
    assert sorted(census["all-gather"]) == [plane, plane], (
        census["all-gather"], plane,
    )

    # halos + flip exchange: bounded count, and in total well under two
    # local image copies (the flip moves each row to its mirror shard
    # once; halos are 1-row edges)
    local_image_bytes = (
        s["local_bs"] * 5 * s["local_rows"] * s["render"] * 4
    )
    assert len(census["collective-permute"]) <= 8, census
    assert sum(census["collective-permute"]) <= 2 * local_image_bytes, (
        census["collective-permute"], local_image_bytes,
    )


def test_collective_census_no_face_axis():
    """(data=2, tile=4): with no face axis there is no combine -- the
    compiled step must contain NO all-gather at all (the forward is
    communication-free), just the one grad psum and the halo/flip
    permutes."""
    mesh = make_mesh(data=2, tile=4)
    hlo, s = _lower_textured_train_step(mesh)
    census = _collective_census(hlo)
    assert census["all-to-all"] == [], census
    assert census["reduce-scatter"] == [], census
    assert census["all-gather"] == [], census
    assert len(census["all-reduce"]) == 1, census
    grad_bytes = (
        s["local_bs"] * s["n_verts"] * 3 * 4
        + s["local_bs"] * int(np.prod(s["tex"][1:])) * 4
    )
    assert census["all-reduce"][0] == grad_bytes
