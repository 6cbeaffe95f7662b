"""Pipeline-level differential fuzz: random scenes through the PUBLIC
rasterize entry points, asserting the invariants the kernel-level tests
pin piecewise:

  * triton backend (interpret on CPU) == xla backend, bit-exact, for
    every draw-flag combination, odd sizes, and AA;
  * batch_chunk sub-batching == monolithic, bit-exact, values AND grads;
  * vertex gradients agree between backends (both share the XLA gather
    and scatter, so equality is exact here; the card's tolerance is in
    tests/test_resolve_triton.py's chip tier).

Scenes are random triangle soups (not meshes): degenerate faces,
off-screen faces, z-fighting, and near/far-straddling depths all occur
naturally at these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neural_renderer_v2_jax.ops.rasterize import (
    RasterizeHyperparam,
    RasterizeParam,
    rasterize_all,
    rasterize_silhouettes,
)


def _random_scene(rng, bs, nf, nv):
    """Vertices in NDC-ish range with depths straddling the clip planes,
    plus a random valid face list (soup: repeated/degenerate allowed)."""
    v = rng.randn(bs, nv, 3).astype("float32")
    v[..., 2] = rng.uniform(0.05, 3.0, size=(bs, nv)).astype("float32")
    f = rng.randint(0, nv, size=(nf, 3)).astype("int32")
    return jnp.asarray(v), f


@pytest.mark.parametrize("case", range(4))
def test_fuzz_backends_bit_exact(case):
    rng = np.random.RandomState(100 + case)
    bs = int(rng.randint(1, 4))
    nf = int(rng.randint(5, 60))
    nv = int(rng.randint(9, 40))
    size = int(rng.choice([16, 24, 33]))
    aa = bool(rng.randint(2))
    backside = bool(rng.randint(2))
    tv, f = _random_scene(rng, bs, nf, nv)

    vt = jnp.asarray(rng.rand(bs, nv, 2).astype("float32"))
    ft = f.copy()
    tex = jnp.asarray(rng.rand(bs, 3, 8, 16).astype("float32"))
    params = RasterizeParam(
        vertices_textures=vt, faces_textures=ft, textures=tex
    )

    base = RasterizeHyperparam(
        image_size=size, anti_aliasing=aa, draw_backside=backside,
        interpret=True,
    )
    out = {}
    for backend in ("xla", "triton"):
        hp = base.replace(backend=backend)
        out[backend] = (
            np.asarray(rasterize_silhouettes(tv, f, None, hp)),
            np.asarray(rasterize_all(tv, f, params, hp)),
        )
    np.testing.assert_array_equal(out["xla"][0], out["triton"][0])
    np.testing.assert_array_equal(out["xla"][1], out["triton"][1])


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_fuzz_batch_chunk_values_and_grads(backend):
    rng = np.random.RandomState(7)
    bs, nf, nv = 7, 40, 30
    tv, f = _random_scene(rng, bs, nf, nv)
    hp0 = RasterizeHyperparam(
        image_size=24, backend=backend, batch_chunk=None, interpret=True
    )
    hp3 = hp0.replace(batch_chunk=3)

    a = np.asarray(rasterize_silhouettes(tv, f, None, hp0))
    b = np.asarray(rasterize_silhouettes(tv, f, None, hp3))
    np.testing.assert_array_equal(a, b)

    def loss(x, hp):
        return jnp.sum(rasterize_silhouettes(x, f, None, hp) ** 2)

    ga = np.asarray(jax.grad(lambda x: loss(x, hp0))(tv))
    gb = np.asarray(jax.grad(lambda x: loss(x, hp3))(tv))
    np.testing.assert_array_equal(ga, gb)
    assert np.all(np.isfinite(ga))


def test_fuzz_grads_backends_agree():
    """Full-pipeline vertex gradients: triton vs xla within 1e-4
    relative, the bound the card is held to (atomic scatter-adds reorder
    f32 sums there); on the CPU they are equal."""
    rng = np.random.RandomState(11)
    tv, f = _random_scene(rng, 2, 30, 24)
    hp = RasterizeHyperparam(image_size=32, anti_aliasing=True, interpret=True)

    def loss(x, backend):
        h = hp.replace(backend=backend)
        img = rasterize_silhouettes(x, f, None, h)
        return jnp.sum(img * img) / (jnp.sum(img) + 1.0)

    gx = np.asarray(jax.grad(lambda x: loss(x, "xla"))(tv))
    gp = np.asarray(jax.grad(lambda x: loss(x, "triton"))(tv))
    assert np.all(np.isfinite(gx))
    scale = np.abs(gx).max()
    np.testing.assert_allclose(gp, gx, atol=1e-4 * scale)
