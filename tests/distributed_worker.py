"""Worker for the 2-process jax.distributed dryrun (test_examples.py).

Run as: python distributed_worker.py <process_id> <num_processes> <port>

Each process owns 2 virtual CPU devices; the workers bring up the
multi-process runtime through ``parallel.distributed.initialize`` (the
multi-process entry point), build a global
(data, tile) mesh spanning both processes, render a sharded silhouette,
and check the cross-process result against a locally computed oracle.

Then :func:`full_train_step_parity` runs the FULL textured fwd+bwd train
step (generated torus knot, AA on) with replicated trainable vertices/textures on (a)
the (data, tile) mesh, whose data axis spans the processes -- the
parameter-gradient psums ride the gloo link -- and (b) a
deliberately permuted mesh whose FACE axis crosses the processes, so the
ordered z-combine's all_gather does too; image, loss, and vertex/texture
gradients are asserted against the single-device oracle in every case.
"""

import os
import sys


def main():
    process_id, num_processes, port = (int(a) for a in sys.argv[1:4])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    # cross-process CPU collectives
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from neural_renderer_v2_jax.parallel import distributed

    assert distributed.initialize(
        coordinator_address="localhost:%d" % port,
        num_processes=num_processes,
        process_id=process_id,
    )
    assert jax.process_count() == num_processes, jax.process_count()
    n_global = num_processes * 2
    assert len(jax.devices()) == n_global, jax.devices()

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import neural_renderer_v2_jax as nr
    from neural_renderer_v2_jax.ops.rasterize import (
        RasterizeHyperparam,
        rasterize_silhouettes,
    )
    from neural_renderer_v2_jax.parallel import rasterize_silhouettes_sharded

    mesh = distributed.global_mesh(data=2)  # tile = n_global // 2
    assert mesh.shape["data"] == 2 and mesh.shape["tile"] == n_global // 2
    # a second mesh with a face axis (innermost, global_mesh's production
    # layout = within a host; full_train_step_parity below builds the
    # deliberately-permuted mesh whose face axis CROSSES the processes)
    mesh_face = distributed.global_mesh(data=1, tile=n_global // 2, face=2)

    vertices = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        "float32",
    )
    faces = np.array(
        [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
         [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]],
        "int32",
    )
    renderer = nr.Renderer()
    bs = 2
    eyes = np.stack(
        [np.array(nr.get_points_from_angles(2.732, 20, 50 * (i + 1)), "float32")
         for i in range(bs)]
    )
    renderer.viewpoints = jnp.asarray(eyes)
    tv = renderer.transform_vertices(jnp.asarray(np.tile(vertices[None], (bs, 1, 1))))
    hp = RasterizeHyperparam(image_size=32, anti_aliasing=False)

    # shard the (replicated host) inputs onto the global mesh
    tv_sharded = jax.device_put(tv, NamedSharding(mesh, P("data")))
    out = rasterize_silhouettes_sharded(
        tv_sharded, jnp.asarray(faces), None, hp, mesh=mesh
    )
    # replicate across processes for comparison (an all_gather over DCN)
    gathered = jax.jit(
        lambda x: x, out_shardings=NamedSharding(mesh, P(None))
    )(out)
    got = np.asarray(gathered.addressable_data(0))

    want = np.asarray(rasterize_silhouettes(tv, jnp.asarray(faces), None, hp))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0  # the octahedron is visible

    # face-sharded across the process boundary: each process resolves a
    # face range and the ordered z-combine all_gathers winners over the
    # (gloo / DCN-like) link
    tv_f = jax.device_put(tv, NamedSharding(mesh_face, P()))
    out_f = rasterize_silhouettes_sharded(
        tv_f, jnp.asarray(faces), None, hp, mesh=mesh_face
    )
    got_f = np.asarray(
        jax.jit(lambda x: x, out_shardings=NamedSharding(mesh_face, P()))(
            out_f
        ).addressable_data(0)
    )
    np.testing.assert_array_equal(got_f, want)

    # ---- full textured fwd+bwd train step across the process boundary ----
    # The north star's headline collective is the vertex/texture gradient
    # all-reduce across hosts (BASELINE.json configs[4]); everything below
    # forces those psums over the gloo (DCN-stand-in) link and asserts
    # image AND gradient parity against a process-local single-device
    # oracle.
    full_train_step_parity(mesh)

    print("distributed_worker %d/%d OK" % (process_id, num_processes), flush=True)


def full_train_step_parity(mesh):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import neural_renderer_v2_jax as nr
    from neural_renderer_v2_jax.ops.camera import look_at, perspective
    from neural_renderer_v2_jax.ops.rasterize import (
        RasterizeHyperparam,
        RasterizeParam,
        rasterize_rgba,
    )
    from neural_renderer_v2_jax.parallel import rasterize_rgba_sharded
    from neural_renderer_v2_jax.parallel.mesh import make_mesh

    # the grad psums must actually cross processes: 'data' (the axis the
    # replicated-parameter psums run over) spans both on this mesh
    md = mesh.devices
    assert md[0, 0].process_index != md[1, 0].process_index, md

    from neural_renderer_v2_jax.utils.scenes import torus_knot

    verts_np, faces_np = torus_knot(seed=0)
    nf = faces_np.shape[0]
    vt, ft, tex = nr.create_textures(nf, texture_size=2)
    bs = 2
    eyes = jnp.asarray(np.stack(
        [np.array(nr.get_points_from_angles(2.732, 20, 50 * (i + 1)), "float32")
         for i in range(bs)]
    ))
    hp = RasterizeHyperparam(image_size=32, anti_aliasing=True)  # AA ON
    faces_j = jnp.asarray(faces_np)
    vt_b = jnp.asarray(np.tile(vt[None], (bs, 1, 1)))
    ft_j = jnp.asarray(ft)

    def render(vb, texb, rasterize_fn, **kw):
        # trainable params are REPLICATED (vb [nv,3], texb [3,th,tw]);
        # the batch broadcast's transpose is the cross-process psum
        v = jnp.broadcast_to(vb[None], (bs,) + vb.shape)
        tv = perspective(look_at(v, eyes), angle=30.0)
        texs = jnp.broadcast_to(texb[None], (bs,) + texb.shape)
        p = RasterizeParam(
            vertices_textures=vt_b, faces_textures=ft_j, textures=texs
        )
        return rasterize_fn(tv, faces_j, p, hp, **kw)

    def loss_sharded(vb, texb):
        return jnp.sum(render(vb, texb, rasterize_rgba_sharded, mesh=mesh) ** 2)

    def loss_single(vb, texb):
        return jnp.sum(render(vb, texb, rasterize_rgba) ** 2)

    vb0 = jnp.asarray(verts_np)
    texb0 = jnp.asarray(tex)
    l_sh, (gv_sh, gt_sh) = jax.value_and_grad(loss_sharded, argnums=(0, 1))(
        vb0, texb0
    )
    l_si, (gv_si, gt_si) = jax.value_and_grad(loss_single, argnums=(0, 1))(
        vb0, texb0
    )

    def fetch(x, m):
        return np.asarray(
            jax.jit(lambda y: y, out_shardings=NamedSharding(m, P()))(
                x
            ).addressable_data(0)
        )

    def check(got, want, tol, what):
        scale = max(np.abs(want).max(), 1e-6)
        err = np.abs(got - want).max() / scale
        assert err <= tol, (what, err)

    check(fetch(l_sh, mesh), np.asarray(l_si), 1e-5, "loss")
    check(fetch(gv_sh, mesh), np.asarray(gv_si), 1e-4, "vertex grad")
    check(fetch(gt_sh, mesh), np.asarray(gt_si), 1e-4, "texture grad")

    # ---- the same step on a mesh whose FACE axis spans the processes ----
    # (global_mesh keeps face innermost = within a host; permute devices
    # so the ordered z-combine's all_gather and the attribute-gather grad
    # psums cross the process boundary here)
    devs = jax.devices()
    by_face = [devs[0], devs[2], devs[1], devs[3]]
    mesh_xf = make_mesh(data=1, tile=2, face=2, devices=by_face)
    xd = mesh_xf.devices
    assert xd[0, 0, 0].process_index != xd[0, 0, 1].process_index, xd

    def loss_xf(vb, texb):
        return jnp.sum(
            render(vb, texb, rasterize_rgba_sharded, mesh=mesh_xf) ** 2
        )

    l_xf, (gv_xf, gt_xf) = jax.value_and_grad(loss_xf, argnums=(0, 1))(
        vb0, texb0
    )
    check(fetch(l_xf, mesh_xf), np.asarray(l_si), 1e-5, "face-mesh loss")
    check(fetch(gv_xf, mesh_xf), np.asarray(gv_si), 1e-4, "face-mesh vertex grad")
    check(fetch(gt_xf, mesh_xf), np.asarray(gt_si), 1e-4, "face-mesh texture grad")
    print("train-step parity OK (data-mesh + cross-process face mesh)", flush=True)


if __name__ == "__main__":
    main()
