"""Example 2: optimizing mesh vertices to match a reference silhouette.

Rework of examples_pytorch/example2.py: the model is a pure loss function
over a vertex pytree; one jitted optax train step replaces the torch
module/optimizer pair.  Without ``-io``/``-ir`` the mesh is the generated
torus knot and the reference silhouette is that knot grown by 15%,
rendered from the same camera.
"""

import argparse
import os

import numpy as np

import neural_renderer_v2_jax as nr

CAMERA_DISTANCE = 2.732
ELEVATION = 0
AZIMUTH = 90


def parse_arguments():
    parser = argparse.ArgumentParser()
    parser.add_argument("-io", "--input_obj_file", type=str, default=None,
                        help="an .obj mesh (default: the generated torus knot)")
    parser.add_argument("-ir", "--input_ref_file", type=str, default=None,
                        help="reference silhouette image (default: generated)")
    parser.add_argument("-oo", "--output_opt_file", type=str, default="./data/example2_opt.gif")
    parser.add_argument("-or", "--output_res_file", type=str, default="./data/example2_res.gif")
    parser.add_argument("-n", "--num_steps", type=int, default=300)
    parser.add_argument("-s", "--image_size", type=int, default=256,
                        help="render size; the 256px reference image is "
                             "subsampled to match")
    parser.add_argument("--sweep_step", type=int, default=4,
                        help="azimuth stride of the final turntable")
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
    vertices = jnp.asarray(vertices)
    faces = jnp.asarray(faces)

    renderer = nr.Renderer()
    renderer.image_size = args.image_size
    eye = jnp.asarray(
        np.array(nr.get_points_from_angles(CAMERA_DISTANCE, ELEVATION, AZIMUTH), "float32")
    )

    def render_silhouette(vertices, viewpoint):
        renderer.viewpoints = viewpoint
        return renderer.render_silhouettes(vertices[None], faces)[0]

    if args.input_ref_file:
        image_ref = nr.imread(args.input_ref_file).mean(-1)
        k = image_ref.shape[0] // args.image_size
        assert k * args.image_size == image_ref.shape[0], args.image_size
        image_ref = jnp.asarray(image_ref[::k, ::k])
    else:
        image_ref = render_silhouette(vertices * 1.15, eye)

    def loss_fn(vertices):
        image = render_silhouette(vertices, eye)
        return jnp.sum((image - image_ref) ** 2)

    opt = optax.adam(1e-3)  # torch.optim.Adam defaults (example2.py:69)
    opt_state = opt.init(vertices)

    @jax.jit
    def train_step(vertices, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(vertices)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(vertices, updates), opt_state, loss

    losses = []
    for i in range(args.num_steps):
        vertices, opt_state, loss = train_step(vertices, opt_state)
        losses.append(float(loss))
        if i % 10 == 0 or i == args.num_steps - 1:
            print("step %d: loss %.3f" % (i, losses[-1]))
        image = np.asarray(render_silhouette(vertices, eye))
        lo, hi = image.min(), image.max()
        nr.imsave("%s/_tmp_%04d.png" % (working_dir, i), (image - lo) / max(hi - lo, 1e-8))
    nr.make_gif(working_dir, args.output_opt_file)

    # render the optimized mesh from a sweep of azimuths
    for num, azimuth in enumerate(range(0, 360, args.sweep_step)):
        vp = jnp.asarray(np.array(
            nr.get_points_from_angles(CAMERA_DISTANCE, ELEVATION, azimuth), "float32"))
        image = np.asarray(render_silhouette(vertices, vp))
        lo, hi = image.min(), image.max()
        nr.imsave("%s/_tmp_%04d.png" % (working_dir, num), (image - lo) / max(hi - lo, 1e-8))
    nr.make_gif(working_dir, args.output_res_file)
    print("wrote", args.output_opt_file, args.output_res_file)
    return losses


if __name__ == "__main__":
    run()
