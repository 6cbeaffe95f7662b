"""Scenes the repository generates itself: a seeded closed mesh, midpoint
subdivision and a procedural texture atlas.

Tests, examples and benchmarks render these instead of reading assets
from disk, so every entry point runs on a fresh checkout.  Everything is
numpy and deterministic for a given seed.
"""

from __future__ import annotations

import numpy as np


def torus_knot(seed=0, tubular=88, radial=14, p=2, q=3, tube=0.22, jitter=0.05):
    """A closed (p, q) torus-knot tube, normalized like ``load_obj``.

    The default 88 x 14 grid has 2,464 faces and 1,232 vertices, the size
    of the reference's teapot, and its depth complexity (the tube passes
    in front of itself) exercises the z-buffer.  ``seed`` jitters each
    vertex along its tube normal by up to ``jitter`` of the tube radius,
    so two seeds give two generic (non-symmetric) meshes.  Faces are
    wound like the reference's meshes: clockwise seen from outside, which
    is what the back-face test (``draw_backside=False``) keeps.

    Returns (vertices [tubular*radial, 3] float32 in [-1, 1],
    faces [2*tubular*radial, 3] int32).
    """
    rng = np.random.RandomState(seed)
    t = np.arange(tubular) * (2 * np.pi / tubular)

    def curve(t):
        r = 2.0 + np.cos(q * t)
        return np.stack(
            [r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t)], -1
        )

    c = curve(t)
    tangent = curve(t + 1e-3) - curve(t - 1e-3)
    tangent /= np.linalg.norm(tangent, axis=-1, keepdims=True)
    normal = np.cross(tangent, curve(t + 1e-3) + curve(t - 1e-3) - 2 * c)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    binormal = np.cross(tangent, normal)

    s = np.arange(radial) * (2 * np.pi / radial)
    ring = (
        np.cos(s)[None, :, None] * normal[:, None]
        + np.sin(s)[None, :, None] * binormal[:, None]
    )  # [tubular, radial, 3] unit offsets from the centre curve
    radius = 2.0 * tube * (
        1.0 + jitter * rng.uniform(-1.0, 1.0, size=(tubular, radial, 1))
    )
    v = (c[:, None] + radius * ring).reshape(-1, 3)

    i = np.arange(tubular)[:, None]
    j = np.arange(radial)[None, :]
    a = i * radial + j
    b = ((i + 1) % tubular) * radial + j
    c1 = ((i + 1) % tubular) * radial + (j + 1) % radial
    d = i * radial + (j + 1) % radial
    faces = np.stack(
        [np.stack([a, b, c1], -1), np.stack([a, c1, d], -1)], 2
    ).reshape(-1, 3)
    # clockwise from outside: the first face's right-hand normal must
    # point into the tube, towards its centre curve
    v0, v1, v2 = v[faces[0]]
    if np.dot(np.cross(v1 - v0, v2 - v0), v0 - c[0]) > 0:
        faces = faces[:, ::-1]

    # load_obj's normalization: centre the bounding box, scale into [-1, 1]
    v = v - (v.min(0) + v.max(0)) / 2
    v = v / np.abs(v).max()
    return v.astype(np.float32), np.ascontiguousarray(faces, dtype=np.int32)


def subdivide(v, f):
    """Midpoint 1:4 triangle subdivision (no dedup; geometry identical).

    Children are emitted adjacent to their parent and vertices renumbered
    in first-use order -- the coherent layout every real mesh pipeline
    produces (loaders emit vertices in file order, subdividers per
    parent)."""
    v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    m01, m12, m20 = (v0 + v1) / 2, (v1 + v2) / 2, (v2 + v0) / 2
    nv = np.concatenate([v0, v1, v2, m01, m12, m20], 0)
    n = f.shape[0]
    i = np.arange(n)
    A, B, C, AB, BC, CA = i, i + n, i + 2 * n, i + 3 * n, i + 4 * n, i + 5 * n
    # children interleaved per parent: [A-corner, B-corner, C-corner, center]
    nf = np.stack(
        [np.stack([A, AB, CA], 1), np.stack([AB, B, BC], 1),
         np.stack([CA, BC, C], 1), np.stack([AB, BC, CA], 1)], 1,
    ).reshape(-1, 3)
    # renumber vertices in first-use order
    flat = nf.reshape(-1)
    _, first = np.unique(flat, return_index=True)
    order = flat[np.sort(first)]
    remap = np.empty(nv.shape[0], np.int64)
    remap[order] = np.arange(order.shape[0])
    return nv[order].astype("float32"), remap[flat].reshape(-1, 3).astype("int32")


def procedural_atlas(num_faces, height, width, seed=0):
    """A smooth random texture atlas of ``height`` x ``width`` texels and
    one UV triangle per face inside it, laid out on a grid of cells.

    Returns (vertices_t [num_faces*3, 2] texel coordinates, faces_t
    [num_faces, 3] int32, textures [3, height, width] float32 in [0, 1]),
    the layout ``load_obj(..., load_textures=True)`` gives a loaded atlas.
    Every UV lies in [0, width-1] x [0, height-1], as the atlas sampler
    requires.
    """
    rng = np.random.RandomState(seed)
    y = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :]
    textures = np.empty((3, height, width), np.float32)
    for ch in range(3):
        fx, fy, px, py = rng.uniform(1.0, 8.0, 2).tolist() + rng.uniform(
            0.0, 2 * np.pi, 2
        ).tolist()
        textures[ch] = 0.5 + 0.25 * (
            np.sin(2 * np.pi * fx * x + px) + np.cos(2 * np.pi * fy * y + py)
        )

    cols = int(np.ceil(np.sqrt(num_faces * width / height)))
    rows = -(-num_faces // cols)
    cw = (width - 1) / cols
    ch_ = (height - 1) / rows
    k = np.arange(num_faces)
    x0 = (k % cols) * cw
    y0 = (k // cols) * ch_
    vt = np.stack(
        [
            np.stack([x0, y0], -1),
            np.stack([x0, y0 + ch_], -1),
            np.stack([x0 + cw, y0 + ch_], -1),
        ],
        1,
    ).reshape(-1, 2)
    faces_t = np.arange(num_faces * 3, dtype=np.int32).reshape(num_faces, 3)
    return vt.astype(np.float32), faces_t, textures
