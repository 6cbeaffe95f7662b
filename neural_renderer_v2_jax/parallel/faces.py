"""Face-sharded z-resolve: distribute the O(pixels x faces) hot loop over
a ``face`` mesh axis with an ordered z-combine.

This is the "tensor-parallel" axis of the rasterizer (SURVEY.md section 2.2
parallelism inventory; the reference has none): vertices/faces are small
and replicated, but the resolve's compute scales with faces, so each
device rasterizes a contiguous face-id range and the per-pixel
(depth, face_id) states combine across devices.

Combine semantics
-----------------
The reference's z-buffer accept is sequential with a depth tolerance:
face f wins only if ``z_f <= depth_min - 1e-4`` against the running
minimum, in face order (rasterize_cuda_kernel.cu:145-148).  That rule is
not associative, so an exact parallel reduction does not exist; however
any sequential winner provably lies within ``[z_min, z_min + 1e-4)``:
an accept strictly lowers the running depth by >= 1e-4, so a candidate
more than 1e-4 below the final winner would have accepted after it
(contradiction -- it was the last accept) or forced it to reject
(contradiction -- depth only decreases).  We therefore fold the per-shard
winners in ascending face-id order with the same rule,
``accept = z_right <= z_left - 1e-4``.  This matches the sequential
result exactly unless two faces from DIFFERENT shards land within 1e-4
of each other at the same pixel, and even then the reported depth is
within 1e-4 of the sequential one.  Single-device rendering (the parity
surface against the reference) is unaffected.

Cost: the combine is one all_gather of 2 planes (depth f32 + id i32) per
pixel band, then an n_shard-step fold -- O(n) tiny elementwise work; the
O(pixels x faces / n) resolve dominates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.gather_resolve import face_index_map
from ..ops.resolve import DEPTH_MIN_DELTA


def ordered_z_combine(depth_index_pairs):
    """Fold per-shard (depth, index) maps in shard order with the
    reference's tolerance rule.  ``depth_index_pairs`` is a pair of
    stacked arrays ([n, ...] depths, [n, ...] indices), shard-major in
    ascending face-id order."""
    depths, indices = depth_index_pairs

    def fold(carry, x):
        d, i = carry
        d2, i2 = x
        accept = d2 <= d - DEPTH_MIN_DELTA
        return (jnp.where(accept, d2, d), jnp.where(accept, i2, i)), None

    (d, i), _ = jax.lax.scan(fold, (depths[0], indices[0]), (depths[1:], indices[1:]))
    return d, i


def compute_face_index_map_face_sharded(
    face_vertices,
    image_size,
    near=0.1,
    far=100.0,
    draw_backside=True,
    face_chunk=None,
    row_start=0,
    num_rows=None,
    axis="face",
    backend="xla",
    interpret=False,
):
    """Per-pixel z-buffered visible-face id, compute sharded over ``axis``.

    Must run inside ``shard_map`` on a mesh that has the ``axis``;
    ``face_vertices`` [bs, nf, 3, 3] is the FULL (replicated) face set --
    each shard resolves its contiguous 1/n slice on ``backend`` ('xla'
    or 'triton', see :func:`..ops.gather_resolve.face_index_map`) and the
    winners combine with :func:`ordered_z_combine`.  Returns the combined
    (replicated) [bs, num_rows, W] int32 map with GLOBAL face ids.

    ``face_chunk`` sets the XLA scan's chunk (None -> 16).
    """
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    bs, nf = face_vertices.shape[:2]
    per = -(-nf // n)
    pad = n * per - nf
    if pad:
        # zero faces are degenerate (|det| < 1e-8) and can never win
        face_vertices = jnp.pad(
            face_vertices, ((0, 0), (0, pad), (0, 0), (0, 0))
        )
    start = idx * per
    local = jax.lax.dynamic_slice_in_dim(face_vertices, start, per, axis=1)

    index, depth = face_index_map(
        local, image_size, near, far, draw_backside, backend,
        row_start=row_start, num_rows=num_rows, return_depth=True,
        interpret=interpret, face_chunk=face_chunk,
    )
    index = jnp.where(index >= 0, index + start, -1)

    depths = jax.lax.all_gather(depth, axis)   # [n, bs, H, W]
    indices = jax.lax.all_gather(index, axis)
    _, combined = ordered_z_combine((depths, indices))
    return combined
