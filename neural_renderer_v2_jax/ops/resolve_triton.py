"""Tiled z-buffer resolve for the GPU: a Pallas kernel through Triton.

Same result as :func:`.resolve.compute_face_index_map` (the XLA scan, the
plain reference), by a different schedule.  The scan streams every face
past the whole canvas and writes the depth and index planes back to
device memory once per chunk of 16 faces.  Here one program owns one
(image, pixel tile) pair and keeps that tile's depth and index in
registers for the whole walk over the faces, in face order, so the
canvas leaves the chip once.  A program skips whole chunks of faces,
and then single faces, whose screen bounding box misses its tile.

The raster math is shared with the XLA resolve: the per-face constants
come from :func:`.resolve.face_constants` (computed by XLA before the
kernel), the per-pixel test is :func:`.resolve.face_candidate`, and the
accept rule is the reference's sequential ``zp <= depth_min - 1e-4``.
Degenerate and culled back faces get an empty bounding box before the
kernel, so the box tests drop them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .resolve import (
    DEGENERATE_EPS,
    DEPTH_MIN_DELTA,
    _pixel_grid,
    face_backside,
    face_candidate,
    face_constants,
)

# One program per TILE pixels (Triton needs power-of-two block shapes);
# one union box test skips FACE_CHUNK faces.  Chosen by a sweep of tiles
# (4..32 rows x 16..64 columns), chunks (16..128) and warps (1, 2, 4) on
# an H100 at both chip_smoke.py scenes; PERF.md has the numbers.
TILE = (8, 32)
FACE_CHUNK = 64
NUM_WARPS = 4


def _kernel(yp_ref, xp_ref, boxes_ref, consts_ref, index_ref, depth_ref,
            *, n_chunks, chunk, near, far):
    th, tw = index_ref.shape
    yp = yp_ref[...]
    xp = xp_ref[...]
    Y = jnp.broadcast_to(yp[:, None], (th, tw))
    X = jnp.broadcast_to(xp[None, :], (th, tw))
    tx0, tx1 = jnp.min(xp), jnp.max(xp)
    ty0, ty1 = jnp.min(yp), jnp.max(yp)

    def misses(xmin, xmax, ymin, ymax):
        # every pixel of the tile fails face_candidate's strict bbox test
        return (tx1 < xmin) | (xmax < tx0) | (ty1 < ymin) | (ymax < ty0)

    def face(f, carry):
        bbox = tuple(consts_ref[f, 13 + j] for j in range(4))

        def draw(carry):
            depth, index = carry
            c = [consts_ref[f, j] for j in range(13)]
            out, zp = face_candidate(
                X, Y, c[0:9], c[9:12], c[12], bbox, near, far
            )
            zc = jnp.where(out, jnp.inf, zp)
            accept = zc <= depth - DEPTH_MIN_DELTA
            return jnp.where(accept, zc, depth), jnp.where(accept, f, index)

        return jax.lax.cond(misses(*bbox), lambda c: c, draw, carry)

    def chunk_body(k, carry):
        box = tuple(boxes_ref[k, j] for j in range(4))
        return jax.lax.cond(
            misses(*box),
            lambda c: c,
            lambda c: jax.lax.fori_loop(k * chunk, (k + 1) * chunk, face, c),
            carry,
        )

    init = (
        jnp.full((th, tw), far, jnp.float32),
        jnp.full((th, tw), -1, jnp.int32),
    )
    depth, index = jax.lax.fori_loop(0, n_chunks, chunk_body, init)
    index_ref[...] = index
    depth_ref[...] = depth


@functools.partial(
    jax.jit,
    static_argnames=(
        "image_size", "near", "far", "draw_backside", "num_rows",
        "return_depth", "interpret", "tile", "chunk",
    ),
)
def compute_face_index_map_triton(
    faces,
    image_size,
    near=0.1,
    far=100.0,
    draw_backside=True,
    row_start=0,
    num_rows=None,
    return_depth=False,
    interpret=False,
    tile=TILE,
    chunk=FACE_CHUNK,
):
    """Per-pixel z-buffered visible-face id; the arguments and results of
    :func:`.resolve.compute_face_index_map` (without its ``face_chunk``).

    Compiles for the GPU.  ``interpret=True`` runs the kernel in the
    Pallas interpreter instead, on any platform; without it a platform
    other than the GPU is an error, never a silent fallback.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the Triton resolve compiles for the GPU only (platform %r); "
            "pass interpret=True to run it in the Pallas interpreter"
            % jax.default_backend()
        )
    bs, nf = faces.shape[:2]
    if num_rows is None:
        num_rows = image_size
    th, tw = tile

    consts = face_constants(faces)  # [bs, nf, 17]
    coef = tuple(consts[..., j] for j in range(9))
    culled = jnp.abs(consts[..., 12]) < DEGENERATE_EPS
    if not draw_backside:
        culled |= face_backside(coef)
    # empty box (min > max) for culled faces; padding faces are culled too
    empty = jnp.asarray([jnp.inf, -jnp.inf, jnp.inf, -jnp.inf], jnp.float32)
    consts = consts.at[..., 13:].set(
        jnp.where(culled[..., None], empty, consts[..., 13:])
    )
    pad = (-nf) % chunk
    if pad:
        filler = jnp.zeros((bs, pad, 17), jnp.float32).at[..., 13:].set(empty)
        consts = jnp.concatenate([consts, filler], axis=1)
    n_chunks = (nf + pad) // chunk
    b = consts[..., 13:].reshape(bs, n_chunks, chunk, 4)
    boxes = jnp.stack(
        [
            b[..., 0].min(-1), b[..., 1].max(-1),
            b[..., 2].min(-1), b[..., 3].max(-1),
        ],
        axis=-1,
    )  # [bs, n_chunks, 4] union box of each chunk

    xp, yp = _pixel_grid(image_size, row_start, num_rows)
    hp, wp = -(-num_rows // th) * th, -(-image_size // tw) * tw
    # edge padding keeps the last tile's extent (and so its culling) tight
    yp = jnp.pad(yp[:, 0], (0, hp - num_rows), mode="edge")
    xp = jnp.pad(xp[0], (0, wp - image_size), mode="edge")

    kernel = functools.partial(
        _kernel, n_chunks=n_chunks, chunk=chunk, near=near, far=far
    )
    tile_spec = pl.BlockSpec((None, th, tw), lambda i, r, c: (i, r, c))
    index, depth = pl.pallas_call(
        kernel,
        grid=(bs, hp // th, wp // tw),
        in_specs=[
            pl.BlockSpec((th,), lambda i, r, c: (r,)),
            pl.BlockSpec((tw,), lambda i, r, c: (c,)),
            pl.BlockSpec((None, n_chunks, 4), lambda i, r, c: (i, 0, 0)),
            pl.BlockSpec((None, n_chunks * chunk, 17), lambda i, r, c: (i, 0, 0)),
        ],
        out_specs=[tile_spec, tile_spec],
        out_shape=[
            jax.ShapeDtypeStruct((bs, hp, wp), jnp.int32),
            jax.ShapeDtypeStruct((bs, hp, wp), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="resolve_tiles",
    )(yp, xp, boxes, consts)
    index = index[:, :num_rows, :image_size]
    if return_depth:
        return index, depth[:, :num_rows, :image_size]
    return index
