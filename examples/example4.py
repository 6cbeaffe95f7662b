"""Example 4: finding camera parameters by gradient descent.

Rework of examples_pytorch/example4.py: the trainable is the 3-vector
camera position itself; gradients flow image -> NMR backward ->
coordinate_map -> vertices-in-camera-space -> look_at -> camera position.
Stops when the loss drops below 70 (example4.py:121).  Without
``-io``/``-ir`` the mesh is the generated torus knot and the reference
silhouette is rendered from a camera at distance 2.732, elevation 30,
azimuth 60.
"""

import argparse
import os

import numpy as np

import neural_renderer_v2_jax as nr


def parse_arguments():
    parser = argparse.ArgumentParser()
    parser.add_argument("-io", "--input_obj_file", type=str, default=None,
                        help="an .obj mesh (default: the generated torus knot)")
    parser.add_argument("-ir", "--input_ref_file", type=str, default=None,
                        help="reference silhouette image (default: generated)")
    parser.add_argument("-or", "--output_res_file", type=str, default="./data/example4_res.gif")
    parser.add_argument("-n", "--max_steps", type=int, default=1000)
    parser.add_argument("-s", "--image_size", type=int, default=256,
                        help="render size; the 256px reference image is "
                             "subsampled and the stop threshold scaled")
    return parser.parse_args()


def run():
    import jax
    import jax.numpy as jnp
    import optax

    args = parse_arguments()
    working_dir = os.path.dirname(args.output_res_file) or "."
    os.makedirs(working_dir, exist_ok=True)

    if args.input_obj_file:
        vertices, faces = nr.load_obj(args.input_obj_file)
    else:
        from neural_renderer_v2_jax.utils.scenes import torus_knot

        vertices, faces = torus_knot()
    vertices = jnp.asarray(vertices[None])
    faces = jnp.asarray(faces)
    # the reference's loss<70 stop (example4.py:121) is an L2 SUM at 256^2
    stop_loss = 70.0 * (args.image_size / 256.0) ** 2

    renderer = nr.Renderer()
    renderer.image_size = args.image_size
    camera_position = jnp.array([6.0, 10.0, -14.0], jnp.float32)  # example4.py:32

    def render_from(camera_position):
        renderer.viewpoints = camera_position  # differentiable alias
        return renderer.render_silhouettes(vertices, faces)[0]

    if args.input_ref_file:
        image_ref = nr.imread(args.input_ref_file)
        if image_ref.ndim == 3:
            image_ref = image_ref.mean(-1)
        k = image_ref.shape[0] // args.image_size
        assert k * args.image_size == image_ref.shape[0], args.image_size
        image_ref = jnp.asarray(image_ref[::k, ::k])
    else:
        image_ref = render_from(jnp.asarray(
            np.array(nr.get_points_from_angles(2.732, 30, 60), "float32")))

    def loss_fn(camera_position):
        image = render_from(camera_position)
        return jnp.sum((image - image_ref) ** 2)

    opt = optax.adam(0.1)  # example4.py:100
    opt_state = opt.init(camera_position)

    @jax.jit
    def train_step(camera_position, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(camera_position)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(camera_position, updates), opt_state, loss

    losses = []
    for i in range(args.max_steps):
        camera_position, opt_state, loss = train_step(camera_position, opt_state)
        loss = float(loss)
        losses.append(loss)
        image = np.asarray(render_from(camera_position))
        nr.imsave("%s/_tmp_%04d.png" % (working_dir, i), np.clip(image, 0, 1))
        if i % 10 == 0:
            print("step %d: loss %.1f camera %s" % (i, loss, np.asarray(camera_position)))
        if loss < stop_loss:  # example4.py:121
            print("converged at step %d (loss %.1f)" % (i, loss))
            break

    nr.make_gif(working_dir, args.output_res_file)
    print("wrote", args.output_res_file)
    return losses


if __name__ == "__main__":
    run()
