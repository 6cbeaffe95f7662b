"""The generated scenes (utils/scenes.py): closed, deterministic meshes of
the advertised sizes, subdivision that keeps the geometry, and an atlas
whose UVs the sampler accepts -- through a save/load round trip."""

import jax.numpy as jnp
import numpy as np
import pytest

import neural_renderer_v2_jax as nr
from neural_renderer_v2_jax.utils.scenes import (
    procedural_atlas,
    subdivide,
    torus_knot,
)


def test_torus_knot_is_closed_and_seeded():
    v, f = torus_knot(seed=0)
    assert v.shape == (1232, 3) and f.shape == (2464, 3)
    assert v.dtype == np.float32 and f.dtype == np.int32
    assert np.abs(v).max() == pytest.approx(1.0)
    # closed: every undirected edge borders exactly two faces, once in
    # each direction (consistent winding)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    assert len({tuple(x) for x in e}) == len(e)
    und = np.sort(e, axis=1)
    _, counts = np.unique(und, axis=0, return_counts=True)
    assert (counts == 2).all()
    v2, f2 = torus_knot(seed=0)
    np.testing.assert_array_equal(v, v2)
    np.testing.assert_array_equal(f, f2)
    assert not np.array_equal(v, torus_knot(seed=1)[0])


def test_subdivide_to_deployment_size():
    v, f = torus_knot()
    for _ in range(3):
        v, f = subdivide(v, f)
    assert f.shape == (157_696, 3) and v.shape == (236_544, 3)
    # first-use vertex order: ids appear in increasing order of first use
    _, first = np.unique(f.reshape(-1), return_index=True)
    assert (np.diff(first) > 0).all()


def test_subdivide_keeps_the_silhouette(knot):
    v, f = knot
    r = nr.Renderer()
    r.image_size = 64
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 45)
    a = np.asarray(r.render_silhouettes(v[None], f))
    v2, f2 = subdivide(v, f)
    b = np.asarray(r.render_silhouettes(v2[None], f2))
    assert np.abs(a - b).mean() < 2e-3


def test_procedural_atlas_round_trip(knot, tmp_path):
    """A loaded-style atlas: UVs inside the texture, a textured render
    that changes with the texture, and the same render after save_obj ->
    load_obj."""
    v, f = knot
    vt, ft, tex = procedural_atlas(f.shape[0], 37, 61, seed=2)
    assert tex.shape == (3, 37, 61) and 0 <= tex.min() and tex.max() <= 1
    assert vt[:, 0].min() >= 0 and vt[:, 0].max() <= 60
    assert vt[:, 1].min() >= 0 and vt[:, 1].max() <= 36

    r = nr.Renderer()
    r.image_size = 48
    r.viewpoints = nr.get_points_from_angles(2.732, 30, 45)
    img = np.asarray(r.render(v[None], f, vt[None], ft, tex[None]))
    assert img.shape == (1, 4, 48, 48) and img[:, :3].std() > 0.01

    path = str(tmp_path / "knot.obj")
    nr.save_obj(path, v, f, vt.copy(), ft, tex)
    v2, f2, vt2, ft2, tex2 = nr.load_obj(path, load_textures=True, normalization=False)
    img2 = np.asarray(r.render(jnp.asarray(v2[None]), f2, vt2[None], ft2, tex2[None]))
    np.testing.assert_allclose(img2, img, atol=1e-2)
