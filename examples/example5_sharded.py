"""Example 5: multi-device sharded rendering.

Renders a batch of camera sweeps over a (data, tile[, face]) device mesh
and runs a short sharded vertex-optimization loop -- the same NMR
gradients as example 2, but with the batch split over the ``data`` axis,
image rows over ``tile``, and (with >= 8 devices) the z-resolve's face
loop over ``face``.  Works on any device set: the GPUs of a host, or CPU
with
  XLA_FLAGS=--xla_force_host_platform_device_count=8 python examples/example5_sharded.py
From several processes call ``parallel.distributed.initialize(...)``
first (see docs/SCALING.md).  Without ``-i`` the mesh is the generated
torus knot.

The reference has no distributed runtime (SURVEY.md §2.2); this is the
capability the north-star scaling target adds.
"""

import argparse
import os


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("-i", "--input_file", type=str, default=None,
                   help="an .obj mesh (default: the generated torus knot)")
    p.add_argument("-o", "--output_file", type=str, default="./data/example5.gif")
    p.add_argument("-n", "--num_steps", type=int, default=60)
    p.add_argument("-s", "--image_size", type=int, default=128)
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="force N virtual CPU devices (testing without GPUs)")
    return p.parse_args()


def main():
    args = parse_args()
    if args.cpu_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu_devices}"
        ).strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    import neural_renderer_v2_jax as nr
    from neural_renderer_v2_jax.ops.camera import look_at, perspective
    from neural_renderer_v2_jax.ops.rasterize import RasterizeHyperparam
    from neural_renderer_v2_jax.parallel import (
        make_mesh,
        rasterize_silhouettes_sharded,
    )

    # use the largest power-of-two device count (the tile axis must
    # divide the render height), split data/tile/face like the dry run
    n = len(jax.devices())
    n2 = 1
    while n2 * 2 <= n:
        n2 *= 2
    data = 2 if n2 >= 4 else 1
    face = 2 if n2 // data >= 4 else 1
    mesh = make_mesh(
        data=data, tile=n2 // (data * face), face=face,
        devices=jax.devices()[:n2],
    )
    print(f"devices: {n} (using {n2}), mesh: {dict(mesh.shape)}")

    if args.input_file:
        vertices, faces = nr.load_obj(args.input_file)
    else:
        from neural_renderer_v2_jax.utils.scenes import torus_knot

        vertices, faces = torus_knot()
    bs = 2 * data
    eyes = np.stack([
        np.array(nr.get_points_from_angles(2.732, 30, a), "float32")
        for a in np.linspace(0, 360, bs, endpoint=False)
    ])
    hp = RasterizeHyperparam(image_size=args.image_size, anti_aliasing=False)

    # target: the sharded render of the unperturbed mesh
    V0 = jnp.asarray(np.tile(vertices[None], (bs, 1, 1)))
    tv0 = perspective(look_at(V0, eyes), angle=30.0)
    target = rasterize_silhouettes_sharded(tv0, faces, None, hp, mesh=mesh)
    jax.block_until_ready(target)

    # optimize perturbed vertices back to the target, sharded end to end
    rng = np.random.RandomState(0)
    v = jnp.asarray(vertices + 0.05 * rng.randn(*vertices.shape).astype("float32"))
    opt = optax.adam(5e-3)
    state = opt.init(v)

    @jax.jit
    def step(v, state, target):
        # target is an argument, not a closure constant, so one compiled
        # step serves every target
        def loss_fn(v):
            vb = jnp.broadcast_to(v[None], (bs,) + v.shape)
            tv = perspective(look_at(vb, eyes), angle=30.0)
            im = rasterize_silhouettes_sharded(tv, faces, None, hp, mesh=mesh)
            return jnp.mean((im - target) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(v)
        updates, state = opt.update(g, state)
        return optax.apply_updates(v, updates), state, loss

    for i in range(args.num_steps):
        v, state, loss = step(v, state, target)
        if i % 10 == 0 or i == args.num_steps - 1:
            print(f"step {i}: loss {float(loss):.6f}")

    # render a turntable of the result and write a gif
    import tempfile

    renderer = nr.Renderer()
    renderer.image_size = args.image_size
    os.makedirs(os.path.dirname(args.output_file) or ".", exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        for i, az in enumerate(range(0, 360, 30)):
            renderer.viewpoints = nr.get_points_from_angles(2.732, 30, az)
            frame = np.asarray(renderer.render_silhouettes(v[None], faces))[0]
            nr.imsave(os.path.join(tmp, "_tmp_%04d.png" % i), frame)
        nr.make_gif(tmp, args.output_file)
    print("wrote", args.output_file)


if __name__ == "__main__":
    main()
