"""OBJ I/O tests: loader semantics and the save->load->render round trip
(reference: tests_torch/test_save_obj.py:11-46)."""

import numpy as np

import neural_renderer_v2_jax as nr


def test_load_obj_teapot(reference_data):
    vertices, faces = nr.load_obj(str(reference_data / "teapot.obj"))
    assert vertices.shape == (1292, 3)
    assert faces.shape == (2464, 3)
    # normalized into a centred ~unit-2 cube (load_obj.py:157-161)
    assert np.abs(vertices).max() <= 1.0 + 1e-5
    assert faces.min() >= 0 and faces.max() < 1292


def test_load_obj_with_textures(reference_data):
    name = "4e49873292196f02574b5684eaec43e9"
    v, f, vt, ft, tex = nr.load_obj(
        str(reference_data / name / "model.obj"), load_textures=True
    )
    assert tex.ndim == 3 and tex.shape[0] == 3
    assert vt.ndim == 2 and vt.shape[1] == 2
    assert ft.shape == (f.shape[0], 3)
    # UVs are texel coordinates inside the atlas
    assert vt[:, 0].max() <= tex.shape[2] - 1 + 1e-3
    assert vt[:, 1].max() <= tex.shape[1] - 1 + 1e-3


def test_save_load_render_round_trip(reference_data, tmp_path):
    """Save a textured mesh, reload it, render both; images must match
    (reference asserts atol/rtol 1e-2)."""
    name = "4e49873292196f02574b5684eaec43e9"
    src = str(reference_data / name / "model.obj")
    v, f, vt, ft, tex = nr.load_obj(src, load_textures=True)

    renderer = nr.Renderer()
    renderer.draw_backside = False
    renderer.viewpoints = nr.get_points_from_angles(2.5, 10, -90)
    img_before = np.asarray(
        renderer.render(v[None], f, vt[None], ft, tex[None])
    )[0].transpose(1, 2, 0)

    tmp_obj = str(tmp_path / "tmp.obj")
    nr.save_obj(tmp_obj, v, f, vt.copy(), ft, tex)
    v2, f2, vt2, ft2, tex2 = nr.load_obj(tmp_obj, load_textures=True)
    img_after = np.asarray(
        renderer.render(v2[None], f2, vt2[None], ft2, tex2[None])
    )[0].transpose(1, 2, 0)

    np.testing.assert_allclose(img_before, img_after, atol=1e-2, rtol=1e-2)


def test_mesh_container(reference_data):
    mesh = nr.Mesh(str(reference_data / "teapot.obj"), texture_size=2)
    assert mesh.num_vertices == 1292
    assert mesh.num_faces == 2464
    v, f, t = mesh.get_batch(3)
    assert v.shape == (3, 1292, 3)
    assert f.shape == (3, 2464, 3)
    assert t.shape == (3, 2464, 2, 2, 2, 3)
    vt, ft, tex = mesh.init_uv_params()
    assert ft.shape == (2464, 3)
