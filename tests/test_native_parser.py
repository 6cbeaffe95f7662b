"""Native (C++) OBJ parser: bit-identical to the Python loader."""

import numpy as np
import pytest

from neural_renderer_v2_jax.utils import obj_io
from neural_renderer_v2_jax.utils import native_loader


@pytest.fixture
def force_python_loader():
    native_loader._failed = True
    saved = native_loader._lib
    native_loader._lib = None
    yield
    native_loader._failed = False
    native_loader._lib = saved


def test_native_matches_python(tmp_path, force_python_loader):
    from neural_renderer_v2_jax.utils.scenes import torus_knot

    p = str(tmp_path / "knot.obj")
    obj_io.save_obj(p, *torus_knot(seed=1))
    v_py, f_py = obj_io.load_obj(p, normalization=False)

    native_loader._failed = False
    native = native_loader.parse_obj_native(p)
    if native is None:
        pytest.skip("no C++ toolchain")
    v_nat, f_nat, _, _ = native
    np.testing.assert_array_equal(v_py, v_nat)
    np.testing.assert_array_equal(f_py, f_nat)


def test_native_quad_fan_and_uv(tmp_path):
    obj = tmp_path / "quad.obj"
    obj.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1 2/2 3/3 4/4\n"
    )
    native = native_loader.parse_obj_native(str(obj))
    if native is None:
        pytest.skip("no C++ toolchain")
    v, f, uvs, uvf = native
    assert v.shape == (4, 3)
    np.testing.assert_array_equal(f, [[0, 1, 2], [0, 2, 3]])
    assert uvs.shape == (4, 2)
    np.testing.assert_array_equal(uvf, [[0, 1, 2], [0, 2, 3]])


def test_native_missing_file():
    with pytest.raises(FileNotFoundError):
        if native_loader.parse_obj_native("/nonexistent/x.obj") is None:
            raise FileNotFoundError  # no toolchain: same outcome
