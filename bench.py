"""Headline benchmark: pixels/s of the forward+backward step, 256x256
silhouette of the generated 2,464-face torus knot (the reference harness's
scene shape, misc/measure_time.py:13-24: distance 2.732, elevation 30,
image_size 256, batch 1, renderer defaults => AA on, i.e. the z-resolve
runs at 512x512 internally).

Runs on a GPU only; without one it exits non-zero.  Prints ONE JSON line:
{"metric", "value", "unit", "median_ms", "quartiles_ms", "steps",
"device": {"platform", "kind", "count"}, "card"}.

Environment: NR_BENCH_IMAGE_SIZE (256), NR_BENCH_BATCH (1),
NR_BENCH_ITERS (50 timed steps).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"),
)


def main():
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        print("bench.py: no GPU (JAX platform %r)" % jax.default_backend(),
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().replace("\n", " | ")

    import neural_renderer_v2_jax as nr
    from neural_renderer_v2_jax.ops.camera import look_at, perspective
    from neural_renderer_v2_jax.utils.scenes import torus_knot

    image_size = int(os.environ.get("NR_BENCH_IMAGE_SIZE", "256"))
    batch_size = int(os.environ.get("NR_BENCH_BATCH", "1"))
    n_iters = int(os.environ.get("NR_BENCH_ITERS", "50"))

    vertices, faces = torus_knot()
    vertices = jnp.asarray(np.tile(vertices[None], (batch_size, 1, 1)))
    eye = np.array(nr.get_points_from_angles(2.732, 30, 0), "float32")
    hp = nr.RasterizeHyperparam(image_size=image_size)  # AA on (defaults)

    @jax.jit
    def step(vertices):
        def loss_fn(vertices):
            tv = perspective(look_at(vertices, eye), angle=30.0)
            images = nr.rasterize_silhouettes(tv, faces, None, hp)
            # IoU-style scalar so the full NMR backward runs
            return jnp.sum(images * images) / (jnp.sum(images) + 1.0)

        return jax.value_and_grad(loss_fn)(vertices)

    jax.block_until_ready(step(vertices))  # compile + warm up
    times = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        jax.block_until_ready(step(vertices))
        times.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    d = jax.devices()[0]
    print(json.dumps({
        "metric": "pixels/s fwd+bwd 256x256 torus-knot silhouette",
        "value": batch_size * image_size * image_size / med,
        "unit": "pixels/s",
        "median_ms": med * 1e3,
        "quartiles_ms": [q1 * 1e3, q3 * 1e3],
        "steps": n_iters,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
