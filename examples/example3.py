"""Example 3: optimizing a texture atlas under random viewpoints.

Rework of examples_pytorch/example3.py: tanh-parameterized texture
atlas, orthographic camera (renderer.perspective = False), random azimuth
per step via jax.random (threaded PRNG key instead of np.random inside
the step, so the whole step jits).  Without ``-io``/``-ir`` the mesh is the
generated torus knot and the reference image is the knot under a seeded
random texture, seen from azimuth 0.
"""

import argparse
import os

import numpy as np

import neural_renderer_v2_jax as nr

CAMERA_DISTANCE = 2.732
ELEVATION = 0


def parse_arguments():
    parser = argparse.ArgumentParser()
    parser.add_argument("-io", "--input_obj_file", type=str, default=None,
                        help="an .obj mesh (default: the generated torus knot)")
    parser.add_argument("-ir", "--input_ref_file", type=str, default=None,
                        help="reference RGB image (default: generated)")
    parser.add_argument("-or", "--output_res_file", type=str, default="./data/example3_res.gif")
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
    vertices = jnp.asarray(vertices[None])
    faces = jnp.asarray(faces)
    vertices_t, faces_t, textures = nr.create_textures(faces.shape[0], texture_size=4)
    vertices_t = jnp.asarray(vertices_t[None])
    faces_t = jnp.asarray(faces_t)
    texture_param = jnp.asarray(textures[None])  # trainable, squashed by tanh

    renderer = nr.Renderer()
    renderer.image_size = args.image_size
    renderer.perspective = False  # orthographic (example3.py:40)
    renderer.texture_size = 4     # create_textures tiling -> gather-free sampling

    def render_rgb(texture_param, viewpoint):
        renderer.viewpoints = viewpoint
        return renderer.render_rgb(
            vertices, faces, vertices_t, faces_t, jnp.tanh(texture_param)
        )

    if args.input_ref_file:
        image_ref = nr.imread(args.input_ref_file)[..., :3]
        k = image_ref.shape[0] // args.image_size
        assert k * args.image_size == image_ref.shape[0], args.image_size
        image_ref = jnp.asarray(image_ref[::k, ::k])
    else:
        rng = np.random.RandomState(0)
        target = jnp.asarray(rng.uniform(-1, 1, texture_param.shape).astype("float32"))
        vp = jnp.asarray(np.array(
            nr.get_points_from_angles(CAMERA_DISTANCE, 0.0, 0.0), "float32"))
        image_ref = render_rgb(target, vp)[0].transpose(1, 2, 0)

    def loss_fn(texture_param, viewpoint):
        images = render_rgb(texture_param, viewpoint)
        return jnp.sum((images[0] - jnp.transpose(image_ref, (2, 0, 1))) ** 2)

    opt = optax.adam(0.01)
    opt_state = opt.init(texture_param)

    @jax.jit
    def train_step(texture_param, opt_state, key):
        azimuth = jax.random.uniform(key, (), minval=0.0, maxval=360.0)
        viewpoint = nr.get_points_from_angles(
            jnp.asarray([CAMERA_DISTANCE]), jnp.asarray([0.0]), azimuth[None]
        )
        loss, grads = jax.value_and_grad(loss_fn)(texture_param, viewpoint)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(texture_param, updates), opt_state, loss

    # per-step losses are sampled at RANDOM viewpoints and so aren't
    # comparable step to step; progress is measured at a fixed viewpoint
    eval_vp = jnp.asarray(np.array(
        nr.get_points_from_angles(CAMERA_DISTANCE, 0.0, 0.0), "float32"))
    eval_loss = jax.jit(lambda p: loss_fn(p, eval_vp))

    key = jax.random.PRNGKey(0)
    losses = [float(eval_loss(texture_param))]
    for i in range(args.num_steps):
        key, sub = jax.random.split(key)
        texture_param, opt_state, loss = train_step(texture_param, opt_state, sub)
        if i % 20 == 0 or i == args.num_steps - 1:
            print("step %d: loss %.3f" % (i, float(loss)))
    losses.append(float(eval_loss(texture_param)))
    print("eval loss (fixed view): %.3f -> %.3f" % (losses[0], losses[-1]))

    for num, azimuth in enumerate(range(0, 360, args.sweep_step)):
        vp = jnp.asarray(np.array(
            nr.get_points_from_angles(CAMERA_DISTANCE, ELEVATION, azimuth), "float32"))
        images = np.asarray(render_rgb(texture_param, vp))
        image = np.maximum(images[0].transpose(1, 2, 0), 0)
        nr.imsave("%s/_tmp_%04d.png" % (working_dir, num), image)
    nr.make_gif(working_dir, args.output_res_file)
    print("wrote", args.output_res_file)
    return losses


if __name__ == "__main__":
    run()
