"""Benchmark harness: forward/backward wall-clock for silhouette and
textured rendering over a sweep of azimuths.

Replacement for the reference's stale chainer-era harness
(misc/measure_time.py:96-106): jit-compiled steps, ``block_until_ready``
device sync (instead of ``.get()``), optional ``jax.profiler`` trace, and
an enqueue-N/block-once protocol that measures device throughput rather
than per-call host dispatch latency.  Without ``--obj`` the mesh is the
generated 2,464-face torus knot.

Usage:
  python benchmarks/measure_time.py [--image-size 256] [--batch 1]
      [--iters 24] [--backend auto|xla|triton] [--profile DIR]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--obj", default=None,
                   help="an .obj mesh (default: the generated torus knot)")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--texture-size", type=int, default=2)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=24, help="azimuth steps (reference: 24)")
    p.add_argument("--backend", default="auto", choices=["auto", "xla", "triton"])
    p.add_argument("--profile", default=None, help="write a jax.profiler trace here")
    return p.parse_args()


def timed(step, args_list, label):
    import jax

    out = step(*args_list[0])
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for a in args_list:
        out = step(*a)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / len(args_list)
    print("%-28s %8.3f ms / call" % (label, dt * 1e3))
    return dt


def run():
    import jax
    import jax.numpy as jnp

    import neural_renderer_v2_jax as nr
    from neural_renderer_v2_jax.ops.camera import look_at, perspective
    from neural_renderer_v2_jax.ops.rasterize import (
        RasterizeHyperparam,
        RasterizeParam,
        rasterize_rgb,
        rasterize_silhouettes,
    )

    args = parse_args()
    print("platform:", jax.default_backend(), jax.devices())

    if args.obj:
        vertices, faces = nr.load_obj(args.obj)
    else:
        from neural_renderer_v2_jax.utils.scenes import torus_knot

        vertices, faces = torus_knot()
    vt, ft, tex = nr.create_textures(faces.shape[0], texture_size=args.texture_size)
    bs = args.batch
    vertices = jnp.asarray(np.tile(vertices[None], (bs, 1, 1)))
    faces = jnp.asarray(faces)
    vt = jnp.asarray(np.tile(vt[None], (bs, 1, 1)))
    ft = jnp.asarray(ft)
    tex = jnp.asarray(np.tile(tex[None], (bs, 1, 1, 1)))

    hp = RasterizeHyperparam(image_size=args.image_size, backend=args.backend)
    eyes = [
        jnp.asarray(np.array(nr.get_points_from_angles(2.732, 30, az), "float32"))
        for az in np.linspace(0, 360, args.iters, endpoint=False)
    ]

    def sil_fwd(vertices, eye):
        tv = perspective(look_at(vertices, eye), angle=30.0)
        return rasterize_silhouettes(tv, faces, None, hp)

    def sil_loss(vertices, eye):
        return jnp.sum(sil_fwd(vertices, eye) ** 2)

    def rgb_fwd(vertices, tex, eye):
        tv = perspective(look_at(vertices, eye), angle=30.0)
        # create_textures atlas -> the gather-free per-face-patch sampler
        # (and its face-scatter texture backward) applies
        p = RasterizeParam(
            vertices_textures=vt, faces_textures=ft, textures=tex,
            texture_size=args.texture_size,
        )
        return rasterize_rgb(tv, faces, p, hp)

    def rgb_loss(vertices, tex, eye):
        return jnp.sum(rgb_fwd(vertices, tex, eye) ** 2)

    sil_f = jax.jit(sil_fwd)
    sil_fb = jax.jit(jax.grad(sil_loss))
    rgb_f = jax.jit(rgb_fwd)
    rgb_fb = jax.jit(jax.grad(rgb_loss, argnums=(0, 1)))

    ctx = None
    if args.profile:
        ctx = jax.profiler.trace(args.profile)
        ctx.__enter__()

    t_sf = timed(sil_f, [(vertices, e) for e in eyes], "silhouette forward")
    t_sb = timed(sil_fb, [(vertices, e) for e in eyes], "silhouette forward+backward")
    t_rf = timed(rgb_f, [(vertices, tex, e) for e in eyes], "textured forward")
    t_rb = timed(rgb_fb, [(vertices, tex, e) for e in eyes], "textured forward+backward")

    if ctx is not None:
        ctx.__exit__(None, None, None)
        print("profile trace written to", args.profile)

    px = bs * args.image_size ** 2
    print("throughput: %.2f Mpx/s silhouette fwd+bwd, %.2f Mpx/s textured fwd+bwd"
          % (px / t_sb / 1e6, px / t_rb / 1e6))


if __name__ == "__main__":
    run()
