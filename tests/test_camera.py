"""Camera transform unit tests.

Analytic values from the reference suites:
  tests_torch/test_look_at.py:10-26, tests_torch/test_perspective.py:10-16.
"""

import numpy as np

import neural_renderer_v2_jax as nr


def test_look_at_analytic():
    viewpoints_list = [
        [1, 0, 1],
        [0, 0, -10],
        [-1, 1, 0],
    ]
    answers = [
        [-np.sqrt(2) / 2, 0, np.sqrt(2) / 2],
        [1, 0, 10],
        [0, np.sqrt(2) / 2, 3.0 / 2.0 * np.sqrt(2)],
    ]
    vertices = np.array([1, 0, 0], "float32")[None, None, :]
    for vp, ans in zip(viewpoints_list, answers):
        transformed = nr.look_at(vertices, np.array(vp, "float32"))
        np.testing.assert_allclose(
            np.asarray(transformed).flatten(), np.array(ans, "float32"), atol=1e-6
        )


def test_perspective_analytic():
    v_in = np.array([1, 2, 10], "float32")[None, None, :]
    v_out = np.array([np.sqrt(3) / 10, 2 * np.sqrt(3) / 10, 10], "float32")
    transformed = nr.perspective(v_in)
    np.testing.assert_allclose(
        np.asarray(transformed).flatten(), v_out, rtol=1e-4
    )


def test_look_matches_look_at_direction():
    # look with direction (at - eye) must equal look_at
    rng = np.random.RandomState(0)
    vertices = rng.randn(2, 5, 3).astype("float32")
    eye = np.array([[0.3, 0.2, -2.0], [0.1, -0.4, -3.0]], "float32")
    at = np.zeros((2, 3), "float32")
    a = nr.look_at(vertices, eye)
    b = nr.look(vertices, eye, direction=at - eye)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_get_points_from_angles_scalar_and_tensor_agree():
    import jax.numpy as jnp

    scalar = nr.get_points_from_angles(2.732, 30.0, 45.0)
    tensor = nr.get_points_from_angles(
        jnp.array([2.732]), jnp.array([30.0]), jnp.array([45.0])
    )
    np.testing.assert_allclose(
        np.asarray(tensor)[0], np.array(scalar), rtol=1e-5
    )


def test_cross_gradients_match_analytic():
    """chainer cross-op parity (tests_chainer/test_cross.py): value and
    the analytic backward ga = cross(b, g), gb = cross(g, a)."""
    import jax

    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    a = jnp.asarray(rng.randn(8, 3).astype("float32"))
    b = jnp.asarray(rng.randn(8, 3).astype("float32"))
    g = jnp.asarray(rng.randn(8, 3).astype("float32"))

    np.testing.assert_allclose(
        np.asarray(nr.cross(a, b)), np.cross(np.asarray(a), np.asarray(b)),
        rtol=1e-5, atol=1e-6,
    )
    ga, gb = jax.vjp(nr.cross, a, b)[1](g)
    np.testing.assert_allclose(
        np.asarray(ga), np.cross(np.asarray(b), np.asarray(g)), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(gb), np.cross(np.asarray(g), np.asarray(a)), rtol=1e-5, atol=1e-6
    )
