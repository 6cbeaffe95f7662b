"""Example 1: drawing a mesh from multiple viewpoints.

Rework of examples_pytorch/example1.py: instead of re-tracing per camera,
all 90 azimuths render as ONE batched jit call (the camera is a [90, 3]
array swept through look_at/perspective) -- the idiomatic JAX shape for a
multi-view sweep.  Without ``-i`` the mesh is the generated torus knot
(utils/scenes.py).
"""

import argparse
import os

import numpy as np

import neural_renderer_v2_jax as nr

CAMERA_DISTANCE = 2.732
ELEVATION = 30


def parse_arguments():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "-i", "--input_file", type=str, default=None,
        help="an .obj mesh (default: the generated torus knot)",
    )
    parser.add_argument("-o", "--output_file", type=str, default="./data/example1.gif")
    parser.add_argument("-b", "--batch", type=int, default=30, help="cameras per call")
    parser.add_argument("-s", "--image_size", type=int, default=256)
    parser.add_argument("--azimuth_step", type=int, default=4)
    # accepted for run.sh arg-forwarding symmetry with examples 2-5
    # (a render-only sweep has no optimization steps): caps the number
    # of rendered views when given
    parser.add_argument("-n", "--num_views", type=int, default=None)
    return parser.parse_args()


def run():
    import jax.numpy as jnp

    args = parse_arguments()
    working_dir = os.path.dirname(args.output_file) or "."
    os.makedirs(working_dir, exist_ok=True)

    if args.input_file is None:
        from neural_renderer_v2_jax.utils.scenes import torus_knot

        vertices, faces = torus_knot()
    elif not args.input_file.endswith(".obj"):
        raise RuntimeError("Only .obj files are currently supported as input.")
    else:
        vertices, faces = nr.load_obj(args.input_file)
    renderer = nr.Renderer()
    renderer.image_size = args.image_size

    azimuths = np.arange(0, 360, args.azimuth_step, dtype="float32")
    if args.num_views is not None:
        azimuths = azimuths[: args.num_views]
    num = 0
    for start in range(0, len(azimuths), args.batch):
        batch_az = azimuths[start : start + args.batch]
        bs = len(batch_az)
        renderer.viewpoints = nr.get_points_from_angles(
            jnp.full((bs,), CAMERA_DISTANCE),
            jnp.full((bs,), float(ELEVATION)),
            jnp.asarray(batch_az),
        )
        batch_vertices = jnp.broadcast_to(
            jnp.asarray(vertices)[None], (bs,) + vertices.shape
        )
        images = np.asarray(renderer.render_silhouettes(batch_vertices, faces))
        for image in images:
            lo, hi = image.min(), image.max()
            frame = (image - lo) / max(hi - lo, 1e-8)
            nr.imsave("%s/_tmp_%04d.png" % (working_dir, num), frame)
            num += 1

    nr.make_gif(working_dir, args.output_file)
    print("wrote", args.output_file)


if __name__ == "__main__":
    run()
