"""Proof that the renderer runs on an NVIDIA GPU, through its normal entry
points, at deployment size.

    python chip_smoke.py          # one GPU: every phase below but the last
    python chip_smoke.py --four   # four GPUs: the sharded training step only

Phases (one process; any failure exits non-zero):
  1. device      -- card name and power limit (nvidia-smi, a child off JAX),
                    JAX version and devices; no GPU -> exit 2
  2. chip tests  -- the tests marked ``chip``, in process
  3. resolve     -- the Triton resolve against the XLA scan at (a) and (b)
  4. step        -- forward+backward at (a) and (b) on both resolves:
                    images and gradients compared, memory_analysis, and
                    step times (median and quartiles, interleaved
                    kernel, XLA, XLA, kernel)
  5. trainer     -- 10 Adam steps of a silhouette fit through Renderer at (a)
  6. sharded     -- (--four) the sharded training step on a (data 1,
                    tile 2, face 2) mesh against the single-device step

Scenes, generated by utils/scenes.py:
  (a) 256^2 silhouette, anti-aliasing on (512^2 internal), batch 1, the
      2,464-face torus knot;
  (b) 512^2 textured RGB (per-face atlas, texture_size=2) with ambient and
      directional lights, anti-aliasing off, 8 views of the knot
      subdivided to 157,696 faces.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR", os.path.join(REPO, ".jax_cache")
)

import numpy as np  # noqa: E402

# Index-map agreement of the Triton resolve with the XLA scan on the card.
# Both evaluate the same expressions, but Triton and XLA contract
# multiply-adds into FMAs differently, so a pixel centre lying on an edge
# (to the last bit) or two faces within rounding of the 1e-4 accept band
# can resolve differently.  On the CPU, in interpret mode, the maps are
# bit-exact (tests/test_resolve_triton.py).
RESOLVE_MIN_EQUAL = 0.9999
# Gradients: atomic scatter-adds reorder f32 sums from run to run.
GRAD_RTOL = 1e-4


def log(msg):
    print(msg, flush=True)


def card_info():
    """``name, power.limit`` lines from nvidia-smi, read by a child process
    that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# --------------------------------------------------------------------------
# scenes


def scene_a(image_size=256, seed=0):
    """(a): silhouette, AA on, batch 1, the 2,464-face knot."""
    import neural_renderer_v2_jax as nr
    from neural_renderer_v2_jax.utils.scenes import torus_knot

    v, f = torus_knot(seed)
    eyes = np.array([nr.get_points_from_angles(2.732, 30, 45)], np.float32)
    hp = nr.RasterizeHyperparam(image_size=image_size, anti_aliasing=True)
    return dict(name="a", vertices=v, faces=f, eyes=eyes, hp=hp)


def scene_b(image_size=512, views=8, subdivisions=3, seed=0):
    """(b): textured RGB with two lights, AA off, ``views`` views of the
    knot subdivided ``subdivisions`` times (3 -> 157,696 faces)."""
    import neural_renderer_v2_jax as nr
    from neural_renderer_v2_jax.utils.scenes import subdivide, torus_knot

    v, f = torus_knot(seed)
    for _ in range(subdivisions):
        v, f = subdivide(v, f)
    rng = np.random.RandomState(seed)
    vt, ft, tex = nr.create_textures(f.shape[0], texture_size=2)
    tex = rng.uniform(0.2, 1.0, tex.shape).astype(np.float32)
    eyes = np.array(
        [nr.get_points_from_angles(2.732, 30, 360.0 * i / views)
         for i in range(views)],
        np.float32,
    )
    hp = nr.RasterizeHyperparam(image_size=image_size, anti_aliasing=False)
    return dict(
        name="b", vertices=v, faces=f, eyes=eyes, hp=hp, vt=vt, ft=ft,
        textures=tex,
    )


def _face_vertices(scene):
    import jax.numpy as jnp

    from neural_renderer_v2_jax.ops.camera import look_at, perspective

    n = scene["eyes"].shape[0]
    v = jnp.broadcast_to(jnp.asarray(scene["vertices"]), (n,) + scene["vertices"].shape)
    tv = perspective(look_at(v, scene["eyes"]), angle=30.0)
    return jnp.take(tv, jnp.asarray(scene["faces"]), axis=1)


def _loss_fn(scene, backend, interpret):
    """Scalar loss of one forward pass of the scene through the public
    rasterize entry points; differentiable in (vertices, textures)."""
    import jax.numpy as jnp

    import neural_renderer_v2_jax as nr
    from neural_renderer_v2_jax.models.lights import AmbientLight, DirectionalLight
    from neural_renderer_v2_jax.ops.camera import look_at, perspective

    hp = scene["hp"].replace(backend=backend, interpret=interpret)
    faces, eyes = scene["faces"], scene["eyes"]
    n = eyes.shape[0]

    def transform(vertices):
        v = jnp.broadcast_to(vertices[None], (n,) + vertices.shape)
        return perspective(look_at(v, eyes), angle=30.0)

    if scene["name"] == "a":
        def loss(vertices, textures):
            img = nr.rasterize_silhouettes(transform(vertices), faces, None, hp)
            return jnp.sum(img * img) / (jnp.sum(img) + 1.0), img
        return loss

    lights = (
        AmbientLight(color=jnp.full((n, 3), 0.4, jnp.float32)),
        DirectionalLight(
            color=jnp.full((n, 3), 0.6, jnp.float32),
            direction=jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32), (n, 1)),
        ),
    )

    def loss(vertices, textures):
        params = nr.RasterizeParam(
            vertices_textures=jnp.broadcast_to(
                jnp.asarray(scene["vt"])[None], (n,) + scene["vt"].shape
            ),
            faces_textures=scene["ft"],
            textures=jnp.broadcast_to(textures[None], (n,) + textures.shape),
            texture_size=2,
            lights=lights,
        )
        img = nr.rasterize_rgb(transform(vertices), faces, params, hp)
        return jnp.mean((img - 0.5) ** 2), img

    return loss


def _args(scene):
    import jax.numpy as jnp

    tex = scene.get("textures", np.zeros((3, 2, 2), np.float32))
    return jnp.asarray(scene["vertices"]), jnp.asarray(tex)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


# --------------------------------------------------------------------------
# phases


def phase_resolve(scene, interpret=False):
    """Triton resolve vs the XLA scan on the scene's face vertices."""
    from neural_renderer_v2_jax.ops.resolve import compute_face_index_map
    from neural_renderer_v2_jax.ops.resolve_triton import (
        compute_face_index_map_triton,
    )

    hp = scene["hp"]
    size = hp.image_size * (2 if hp.anti_aliasing else 1)
    fv = _face_vertices(scene)
    args = (fv, size, hp.near, hp.far, hp.draw_backside)
    ik, dk = compute_face_index_map_triton(*args, return_depth=True, interpret=interpret)
    ix, dx = compute_face_index_map(*args, return_depth=True)
    ik, dk, ix, dx = (np.asarray(x) for x in (ik, dk, ix, dx))
    same = ik == ix
    fg = same & (ix >= 0)
    res = dict(
        faces=int(fv.shape[1]), pixels=int(ix.size),
        foreground=float((ix >= 0).mean()), equal=float(same.mean()),
        differing=int((~same).sum()),
        depth_rel=float(
            (np.abs(dk - dx)[fg] / dx[fg]).max() if fg.any() else 0.0
        ),
    )
    log("resolve (%s): %s" % (scene["name"], json.dumps(res)))
    if res["foreground"] <= 0.01:
        raise AssertionError("scene (%s) renders almost nothing" % scene["name"])
    if res["equal"] < RESOLVE_MIN_EQUAL or res["depth_rel"] > 1e-4:
        raise AssertionError(
            "Triton resolve disagrees with the XLA scan at (%s): %s"
            % (scene["name"], res)
        )
    return res


def phase_step(scene, steps=20, interpret=False, card=""):
    """Forward+backward with both resolves: images and gradients against
    the XLA pipeline, compiled memory, and step times."""
    import jax

    args = _args(scene)
    fns, outs = {}, {}
    for backend in ("triton", "xla"):
        vg = jax.value_and_grad(
            _loss_fn(scene, backend, interpret), argnums=(0, 1), has_aux=True
        )
        fn = jax.jit(vg)
        mem = fn.lower(*args).compile().memory_analysis()
        log("memory_analysis (%s, %s): %s" % (scene["name"], backend, mem))
        (loss, img), grads = jax.block_until_ready(fn(*args))
        fns[backend] = fn
        outs[backend] = (float(loss), np.asarray(img), [np.asarray(g) for g in grads])

    (lk, ik, gk), (lx, ix, gx) = outs["triton"], outs["xla"]
    diff = np.abs(ik - ix)
    res = dict(
        loss=lx, loss_rel=abs(lk - lx) / max(abs(lx), 1e-12),
        image_max=float(diff.max()), image_mean=float(diff.mean()),
        image_off=float((diff > 1e-5).mean()),
        grad_rel=[_rel(a, b) for a, b in zip(gk, gx)],
        grad_scale=[float(np.abs(b).max()) for b in gx],
    )
    log("step parity (%s): %s" % (scene["name"], json.dumps(res)))
    if not (np.isfinite(lx) and all(np.isfinite(g).all() for g in gx + gk)):
        raise AssertionError("non-finite loss or gradients at (%s)" % scene["name"])
    used = [r for r, s in zip(res["grad_rel"], res["grad_scale"]) if s > 0]
    if res["image_off"] > 1 - RESOLVE_MIN_EQUAL or any(r > GRAD_RTOL for r in used):
        raise AssertionError("kernel pipeline disagrees with XLA at (%s)" % scene["name"])

    times = {"triton": [], "xla": []}
    for backend in ("triton", "xla", "xla", "triton"):
        fn = fns[backend]
        for _ in range(max(steps // 2, 1)):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            times[backend].append(time.perf_counter() - t0)
    for backend, ts in times.items():
        q1, med, q3 = (float(x) * 1e3 for x in np.percentile(ts, [25, 50, 75]))
        res["ms_" + backend] = med
        log(
            "step time (%s, %s): median %.4f ms, quartiles [%.4f, %.4f] ms, "
            "n=%d | %s" % (scene["name"], backend, med, q1, q3, len(ts), card)
        )
    return res


def phase_trainer(image_size=256, steps=10):
    """Adam on the vertices of a shrunken knot, to the silhouette of the
    knot, through the Renderer facade; the loss must fall."""
    import jax
    import jax.numpy as jnp
    import optax

    import neural_renderer_v2_jax as nr
    from neural_renderer_v2_jax.utils.scenes import torus_knot

    v, f = torus_knot(0)
    renderer = nr.Renderer()
    renderer.image_size = image_size
    renderer.viewpoints = nr.get_points_from_angles(2.732, 30, 45)
    target = renderer.render_silhouettes(jnp.asarray(v[None]), f)
    opt = optax.adam(0.01)

    @jax.jit
    def step(vertices, state):
        def loss_fn(x):
            sil = renderer.render_silhouettes(x[None], f)
            return jnp.mean((sil - target) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(vertices)
        updates, state = opt.update(g, state)
        return optax.apply_updates(vertices, updates), state, loss

    vertices = jnp.asarray(v * 0.9)
    state = opt.init(vertices)
    losses = []
    for _ in range(steps):
        vertices, state, loss = step(vertices, state)
        losses.append(float(loss))
    log("trainer losses: %s" % ["%.6f" % x for x in losses])
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("trainer loss did not fall: %s" % losses)
    return losses


def phase_sharded(n_devices=4, data=1, tile=2, face=2, image_size=128,
                  backend="auto", interpret=False):
    """One sharded training step on a (data, tile, face) mesh against the
    single-device step: textured RGBA, AA on, the knot with its last face
    dropped (an odd face count exercises the face axis's padding)."""
    import jax
    import jax.numpy as jnp
    import optax

    import neural_renderer_v2_jax as nr
    from neural_renderer_v2_jax.ops.camera import look_at, perspective
    from neural_renderer_v2_jax.parallel import make_mesh
    from neural_renderer_v2_jax.ops.rasterize import rasterize_core
    from neural_renderer_v2_jax.parallel.render import rasterize_core_sharded
    from neural_renderer_v2_jax.utils.scenes import torus_knot

    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise AssertionError("%d devices, need %d" % (len(jax.devices()), n_devices))
    mesh = make_mesh(data=data, tile=tile, face=face, devices=devices)
    bs = max(data, 2)
    v_np, f_np = torus_knot(0)
    f_np = f_np[:-1]
    nf = f_np.shape[0]
    vt, ft, tex = nr.create_textures(nf, texture_size=2)
    eyes = jnp.asarray(np.array(
        [nr.get_points_from_angles(2.732, 20, 40 * i) for i in range(bs)],
        np.float32,
    ))
    target = jnp.full((bs, 4, image_size, image_size), 0.3, jnp.float32)
    hp = nr.RasterizeHyperparam(
        image_size=image_size, anti_aliasing=True, draw_rgb=True,
        draw_silhouettes=True, draw_depth=False, backend=backend,
        interpret=interpret,
    )
    faces = jnp.asarray(f_np)
    trainable = {"vertices": jnp.asarray(v_np), "textures": jnp.asarray(tex)}

    def loss_fn(tr, sharded):
        v = jnp.broadcast_to(tr["vertices"][None], (bs,) + tr["vertices"].shape)
        params = nr.RasterizeParam(
            vertices_textures=jnp.broadcast_to(jnp.asarray(vt)[None], (bs,) + vt.shape),
            faces_textures=jnp.asarray(ft),
            textures=jnp.broadcast_to(tr["textures"][None], (bs,) + tr["textures"].shape),
            texture_size=2,
        )
        tv = perspective(look_at(v, eyes), angle=30.0)
        if sharded:
            images = rasterize_core_sharded(tv, faces, params, hp, mesh)
        else:
            images = rasterize_core(tv, faces, params, hp)
        return jnp.mean((images - target) ** 2), images

    def grads(sharded):
        return jax.jit(jax.value_and_grad(
            lambda tr: loss_fn(tr, sharded), has_aux=True
        ))(trainable)

    (loss_s, img_s), g_s = grads(True)
    (loss_1, img_1), g_1 = grads(False)
    res = dict(
        mesh=dict(mesh.shape), faces=nf,
        image_max=float(jnp.max(jnp.abs(img_s - img_1))),
        loss_rel=abs(float(loss_s) - float(loss_1)) / abs(float(loss_1)),
        grad_rel={k: _rel(g_s[k], g_1[k]) for k in g_1},
    )

    opt = optax.adam(1e-2)

    @jax.jit
    def train_step(tr, state):
        (loss, _), g = jax.value_and_grad(lambda t: loss_fn(t, True), has_aux=True)(tr)
        updates, state = opt.update(g, state)
        return optax.apply_updates(tr, updates), state, loss

    tr, _, loss = train_step(trainable, opt.init(trainable))
    res["step_loss"] = float(loss)
    res["moved"] = float(jnp.linalg.norm(tr["vertices"] - trainable["vertices"]))
    log("sharded step: %s" % json.dumps(res))
    if res["image_max"] >= 1e-5 or res["loss_rel"] >= 1e-4:
        raise AssertionError("sharded images diverge: %s" % res)
    if any(r >= GRAD_RTOL for r in res["grad_rel"].values()):
        raise AssertionError("sharded gradients diverge: %s" % res)
    if not (np.isfinite(res["step_loss"]) and res["moved"] > 0):
        raise AssertionError("the training step did not move the vertices")
    return res


def phase_chip_tests():
    """The tests marked ``chip``, run in this process (JAX already holds
    the card, so no second process competes for its memory)."""
    import pytest

    os.environ["JAX_PLATFORMS"] = "cuda"  # conftest keeps a named platform
    rc = pytest.main(
        ["-q", "-rs", "-m", "chip", "-p", "no:cacheprovider",
         os.path.join(REPO, "tests")]
    )
    if rc != 0:
        raise AssertionError("chip-marked tests failed (pytest exit %d)" % rc)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded step on four GPUs")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print("chip_smoke: no GPU (JAX platform %r)" % jax.default_backend(),
              file=sys.stderr)
        return 2
    card = card_info()
    log("card: %s" % card)
    card = card.replace("\n", " | ")
    log("jax %s, devices %s" % (jax.__version__, jax.devices()))

    if args.four:
        phase_sharded(n_devices=4)
    else:
        phase_chip_tests()
        a, b = scene_a(), scene_b()
        phase_resolve(a)
        phase_resolve(b)
        phase_step(a, card=card)
        phase_step(b, card=card)
        phase_trainer()

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
