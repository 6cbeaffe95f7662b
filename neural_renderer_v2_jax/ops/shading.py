"""Texture sampling, depth/coordinate maps, normals and lighting.

All of this layer is plain XLA: interpolation, bilinear texture taps and
the lighting accumulation are elementwise/gather math that the compiler
fuses around the resolve.  The only matmul-shaped op (vertex-normal
accumulation) is a segment-sum, which XLA lowers to a scatter-add (atomic
on a GPU, like the chainer twin's atomicAdd).

References:
  sample_textures        -- neural_renderer_torch/rasterize.py:100-153
  compute_depth_map      -- neural_renderer_torch/rasterize.py:80-88
  compute_coordinate_map -- neural_renderer_torch/rasterize.py:91-97
  compute_normal_map     -- neural_renderer_torch/rasterize.py:162-190
  lighting loop          -- neural_renderer_torch/rasterize.py:252-283
  blend_backgrounds      -- chainer rasterize.py:574-577 (the torch copy
                            is broken: calls .astype on a tensor)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models import lights as light_lib
from .maps import mask_foreground, to_map


def compute_depth_map_from(faces_z_map, face_index_map, weight_map):
    """Perspective-correct depth 1 / sum(w / z) from the pre-gathered
    per-pixel vertex depths [bs, H, W, 3]; masked to foreground."""
    depth_map = 1.0 / jnp.sum(weight_map / faces_z_map, axis=-1)
    return mask_foreground(depth_map, face_index_map)


def compute_depth_map(faces, face_index_map, weight_map):
    """Gather-based variant (reference rasterize.py:80-88 shape)."""
    faces_z_map = to_map(faces[:, :, :, -1:], face_index_map)[:, :, :, :, 0]
    return compute_depth_map_from(faces_z_map, face_index_map, weight_map)


def compute_coordinate_map_from(face_vertex_map, weight_map):
    """Barycentric-interpolated screen XY from the pre-gathered winner
    vertices [bs, H, W, 3, 3].  This is THE gradient port: the NMR
    backward flows into vertices only through this map (weight_map is a
    stopped constant)."""
    return jnp.sum(
        face_vertex_map[..., :2] * weight_map[:, :, :, :, None], axis=-2
    )


def compute_coordinate_map(faces, face_index_map, weight_map):
    """Gather-based variant (reference rasterize.py:91-97 shape)."""
    faces_map = to_map(faces, face_index_map)  # [bs,H,W,3,3]
    return compute_coordinate_map_from(faces_map, weight_map)


def _uv_coords(z, u, v, w, fg, eps):
    """Perspective-correct interpolated texel coordinates (x, y) from
    per-vertex planes, clamped into the winning face's own uv-bbox minus
    eps (reference rasterize.py:113-121, with its exact epsilons).

    Args: tuples of three [bs, H, W] planes (per face vertex) for depth
    ``z``, texel coords ``u``/``v``, barycentric weights ``w``; ``fg`` is
    the [bs, H, W] foreground mask.  Shared by every texture sampler
    (atlas and gathered-texel, planar and NHWC shims).
    """
    depth = 1.0 / (
        w[0] / (z[0] + 1e-10) + 1e-10
        + w[1] / (z[1] + 1e-10) + 1e-10
        + w[2] / (z[2] + 1e-10) + 1e-10
    )

    def interp(c):
        val = (
            w[0] * c[0] / (z[0] + 1e-10)
            + w[1] * c[1] / (z[1] + 1e-10)
            + w[2] * c[2] / (z[2] + 1e-10)
        ) * depth
        lo = jnp.minimum(jnp.minimum(c[0], c[1]), c[2])
        hi = jnp.maximum(jnp.maximum(c[0], c[1]), c[2]) - eps
        return jnp.where(fg, jnp.clip(val, lo, hi), 0.0)

    return interp(u), interp(v)


def _bilinear_taps(x, y):
    """Bilinear 4-tap decomposition of texel coords: returns the integer
    floor coords and the four corner weights, in the reference's corner
    order (floor/floor, floor-y/ceil-x, ceil-y/floor-x, ceil/ceil)."""
    x0f, y0f = jnp.floor(x), jnp.floor(y)
    wx0, wx1 = x0f + 1 - x, x - x0f
    wy0, wy1 = y0f + 1 - y, y - y0f
    x0, y0 = x0f.astype(jnp.int32), y0f.astype(jnp.int32)
    return x0, y0, (wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _atlas_taps(flat, idx00, tw):
    """The four bilinear taps [bs, 4, 3, P] from a flattened atlas
    [bs, 3, T], anchored at ``idx00`` [bs, P] (the floor-corner texel id;
    the other taps are +1, +tw, +tw+1).

    Forward is four row gathers.  The custom backward scatters all four
    taps' gradients as 12 channels at the ONE anchor id (one scatter-add
    instead of four), then three shifted adds fold the quad channels onto
    their true texels.  Anchors are clamped so all four taps stay
    in-bounds.

    PRECONDITION: texel coords (hence ``vertices_textures``) must lie in
    [0, tw-1] x [0, th-1].  The quad anchor is clamped as a UNIT (all
    four taps shift together), unlike the reference's per-tap index clip
    (rasterize.py:139-144), so for UVs outside the atlas the two paths
    diverge; in-bounds UVs (anything a loader or ``create_textures``
    produces) are unaffected because the uv-bbox-minus-eps clamp already
    keeps x in [x0, x1-eps] within the atlas.
    """
    return _atlas_taps_impl(flat, idx00, tw)


def _atlas_taps_impl(flat, idx00, tw):
    bs, _, T = flat.shape
    idx00 = jnp.clip(idx00, 0, T - tw - 2)
    taps = [
        jnp.take_along_axis(flat, (idx00 + off)[:, None], axis=2)
        for off in (0, 1, tw, tw + 1)
    ]
    return jnp.stack(taps, axis=1)  # [bs, 4, 3, P]


def _atlas_taps_fwd(flat, idx00, tw):
    return _atlas_taps_impl(flat, idx00, tw), (idx00, flat.shape[-1])


def _atlas_taps_bwd(tw, residuals, g):
    idx00, T = residuals
    P = g.shape[-1]
    anchors = jnp.clip(idx00, 0, T - tw - 2)

    def per(gb, ib):
        return jnp.zeros((T, 12), jnp.float32).at[ib].add(
            gb.reshape(12, P).T
        )

    quad = jax.vmap(per)(g, anchors)

    def shifted(a, k):  # anchor t contributed to texel t + k
        return jnp.pad(a, ((0, 0), (k, 0), (0, 0)))[:, :T]

    g_flat = (
        quad[..., 0:3]
        + shifted(quad[..., 3:6], 1)
        + shifted(quad[..., 6:9], tw)
        + shifted(quad[..., 9:12], tw + 1)
    )
    g_idx = np.zeros(idx00.shape, jax.dtypes.float0)
    return g_flat.transpose(0, 2, 1), g_idx


_atlas_taps.defvjp(_atlas_taps_fwd, _atlas_taps_bwd)


def sample_textures_atlas_planes(
    fvm_planar, uv_planes, textures, face_index_map, weight_planes, eps
):
    """General (loaded-atlas) texture sampler, channel-planar.

    The four bilinear taps gather from the atlas held as [bs, 3, th*tw]
    channel planes (:func:`_atlas_taps`: row gathers forward, one
    quad-merged scatter-add for the texture-gradient transpose).
    Reference semantics: rasterize.py:100-153 (perspective-correct UV,
    uv-bbox-minus-eps clamp, 4-tap bilinear).

    Args:
      fvm_planar: [bs, 9, H, W] gathered winner coords (z at planes 2,5,8).
      uv_planes: [bs, 6, H, W] gathered UV triangle (u0,v0,u1,v1,u2,v2).
      textures: [bs, 3, th, tw] atlas (differentiable).
      weight_planes: [bs, 3, H, W].

    Returns [bs, 3, H, W] RGB.
    """
    bs, _, H, W = fvm_planar.shape
    th, tw = textures.shape[2:]
    fg = face_index_map >= 0
    x, y = _uv_coords(
        (fvm_planar[:, 2], fvm_planar[:, 5], fvm_planar[:, 8]),
        (uv_planes[:, 0], uv_planes[:, 2], uv_planes[:, 4]),
        (uv_planes[:, 1], uv_planes[:, 3], uv_planes[:, 5]),
        (weight_planes[:, 0], weight_planes[:, 1], weight_planes[:, 2]),
        fg, eps,
    )
    x0, y0, tap_w = _bilinear_taps(x, y)

    flat = textures.reshape(bs, 3, th * tw)
    idx00 = (y0 * tw + x0).reshape(bs, H * W)
    taps4 = _atlas_taps(flat, idx00, tw).reshape(bs, 4, 3, H, W)
    images = sum(w[:, None] * taps4[:, i] for i, w in enumerate(tap_w))
    return jnp.where(fg[:, None], images, 0.0)


def sample_textures_from(
    faces_z_map, vertices_textures_map, textures, face_index_map, weight_map, eps
):
    """Reference-shaped (NHWC) atlas sampler: layout shim over the planar
    helpers above.

    Args:
      faces_z_map: [bs, H, W, 3] winner vertex depths (differentiable).
      vertices_textures_map: [bs, H, W, 3, 2] winner UV triangle (texel
        coords, differentiable).
      textures: [bs, 3, th, tw] atlas.
      face_index_map: [bs, H, W] int32.
      weight_map: [bs, H, W, 3].
      eps: UV clamp margin (hyperparams.eps, default 1e-5).

    Returns [bs, H, W, 3] RGB.  Differentiable w.r.t. textures, vertex
    depths and UVs, matching the torch path (rasterize.py:100-153; the
    chainer twin detaches faces/UVs -- torch semantics are primary).
    """
    bs, H, W = face_index_map.shape
    th, tw = textures.shape[2:]
    fg = face_index_map >= 0
    x, y = _uv_coords(
        tuple(faces_z_map[..., i] for i in range(3)),
        tuple(vertices_textures_map[..., i, 0] for i in range(3)),
        tuple(vertices_textures_map[..., i, 1] for i in range(3)),
        tuple(weight_map[..., i] for i in range(3)),
        fg, eps,
    )
    x0, y0, tap_w = _bilinear_taps(x, y)

    flat = textures.transpose(0, 2, 3, 1).reshape(bs, th * tw, 3)

    def tap(yi, xi):
        return to_map(flat, yi * tw + xi)

    taps = (tap(y0, x0), tap(y0, x0 + 1), tap(y0 + 1, x0), tap(y0 + 1, x0 + 1))
    images = sum(w[..., None] * t for w, t in zip(tap_w, taps))
    return jnp.where(fg[..., None], images, 0.0)


def face_texel_attrs(textures, num_faces, texture_size):
    """Per-face texel patches from a ``create_textures``-style tiled atlas.

    The atlas [bs, 3, th*ts, tw*ts] assigns face f the ts x ts patch at
    grid cell (f // tw, f % tw) (utils/helpers.py create_textures,
    reference utils.py:30-52).  Returns [bs, nf, ts*ts*3] with texel
    t = y_local*ts + x_local, channel-minor -- the attribute layout
    consumed by :func:`sample_textures_texel_planes`.  Pure reshape /
    transpose / slice, so texture gradients flow straight through.
    """
    bs = textures.shape[0]
    ts = texture_size
    th = textures.shape[2] // ts
    tw = textures.shape[3] // ts
    t = textures.reshape(bs, 3, th, ts, tw, ts)
    t = t.transpose(0, 2, 4, 3, 5, 1)            # [bs, th, tw, ts_y, ts_x, 3]
    t = t.reshape(bs, th * tw, ts * ts * 3)
    return t[:, :num_faces]


def sample_textures(faces, faces_textures, textures, face_index_map, weight_map, eps):
    """Gather-based variant: gathers the per-pixel z / UV maps with
    ``to_map`` first (the reference's structure, rasterize.py:100-153)."""
    faces_z_map = to_map(faces[:, :, :, 2], face_index_map)         # [bs,H,W,3]
    vertices_textures_map = to_map(faces_textures, face_index_map)  # [bs,H,W,3,2]
    return sample_textures_from(
        faces_z_map, vertices_textures_map, textures, face_index_map, weight_map, eps
    )


def blend_backgrounds(face_index_map, rgb_map, backgrounds):
    """Composite background behind the mesh.  ``backgrounds`` is
    [bs, H, W, 3]; it is pre-flipped in H/W because the merged image is
    flipped at the end of the pipeline (chainer rasterize.py:574-577)."""
    foreground_map = (face_index_map >= 0).astype(jnp.float32)[..., None]
    return foreground_map * rgb_map + (1.0 - foreground_map) * backgrounds[:, ::-1, ::-1]


def face_vertex_normals(vertices, face_indices, faces):
    """Per-face per-vertex smoothed normals [bs, nf, 3, 3].

    Face normals via cross products; vertex normals via a segment-sum over
    the face-vertex incidence (equivalent to the reference's {0,1}
    incidence matmul, rasterize.py:173-179: any face with a duplicated
    vertex has a zero cross product, so set-vs-add makes no difference);
    normalize, gather per face.
    """
    num_vertices = vertices.shape[1]
    v01 = faces[:, :, 1, :] - faces[:, :, 0, :]
    v12 = faces[:, :, 2, :] - faces[:, :, 1, :]
    n = jnp.cross(v01, v12)  # [bs, nf, 3]

    flat_ids = face_indices.reshape(-1)  # [nf*3]

    def accumulate(nb):  # nb: [nf, 3]
        contrib = jnp.repeat(nb, 3, axis=0)  # [nf*3, 3]
        return jax.ops.segment_sum(contrib, flat_ids, num_segments=num_vertices)

    vn = jax.vmap(accumulate)(n)  # [bs, nv, 3]
    norm = jnp.linalg.norm(vn, axis=2, keepdims=True)
    vn = vn / jnp.maximum(norm, 1e-12)
    return jnp.take(vn, face_indices, axis=1)  # [bs, nf, 3, 3]


def normal_map_from_gathered(normal_vertex_map, weight_map, smooth=True):
    """Smooth the pre-gathered per-pixel vertex normals [bs,H,W,3,3]."""
    if smooth:
        return jnp.sum(weight_map[..., None] * normal_vertex_map, axis=-2)
    return jnp.mean(normal_vertex_map, axis=-2)


def compute_normal_map(vertices, face_indices, faces, face_index_map, weight_map, smooth=True):
    """Gather-based variant (reference rasterize.py:162-190 shape)."""
    fn = face_vertex_normals(vertices, face_indices, faces)
    normal_vertex_map = to_map(fn, face_index_map)  # [bs, H, W, 3, 3]
    return normal_map_from_gathered(normal_vertex_map, weight_map, smooth)


def apply_lights(rgb_map, normal_map, lights):
    """Accumulate the per-pixel color-weight map over all lights and
    modulate the sampled RGB (reference rasterize.py:252-283)."""
    color_weight_map = jnp.zeros_like(normal_map)
    for light in lights:
        if isinstance(light, light_lib.AmbientLight):
            color_weight_map += jnp.broadcast_to(
                light.color[:, None, None, :], color_weight_map.shape
            )
        elif isinstance(light, light_lib.DirectionalLight):
            intensity = jnp.sum(
                -light.direction[:, None, None, :] * normal_map, axis=-1
            )
            if light.backside:
                intensity = jnp.abs(intensity)
            else:
                intensity = jax.nn.relu(intensity)
            color_weight_map += intensity[..., None] * light.color[:, None, None, :]
        elif isinstance(light, light_lib.SpecularLight):
            direction_eye = jnp.array([0.0, 0.0, 1.0], dtype=jnp.float32)
            intensity = jnp.sum(-direction_eye[None, None, None, :] * normal_map, axis=-1)
            if light.backside:
                intensity = jnp.abs(intensity)
            else:
                intensity = jax.nn.relu(intensity)
            alpha = light.alpha
            if alpha is None:
                alpha = jnp.ones(light.color.shape[0], dtype=jnp.float32)
            intensity = intensity ** alpha[:, None, None]
            color_weight_map += intensity[..., None] * light.color[:, None, None, :]
        else:
            raise TypeError("unknown light type: %r" % (light,))
    return rgb_map * color_weight_map


# ---------------------------------------------------------------------------
# Channel-planar (NCHW) variants: the pipeline's native layout.  Every map
# is [bs, C, H, W] so elementwise work runs with the image width on the
# vector lanes; the NHWC variants above keep the reference-shaped public
# API (and serve the to_map/row-window paths).


def coordinate_planes(fvm_planar, weight_planes):
    """Barycentric screen-XY map [bs, 2, H, W] from planar gathered winner
    coordinates [bs, 9, H, W] and weights [bs, 3, H, W].  THE gradient
    port: the NMR backward flows into vertices only through this map
    (weights are a stopped constant)."""
    w0, w1, w2 = weight_planes[:, 0], weight_planes[:, 1], weight_planes[:, 2]
    cx = fvm_planar[:, 0] * w0 + fvm_planar[:, 3] * w1 + fvm_planar[:, 6] * w2
    cy = fvm_planar[:, 1] * w0 + fvm_planar[:, 4] * w1 + fvm_planar[:, 7] * w2
    return jnp.stack((cx, cy), axis=1)


def depth_plane(fvm_planar, face_index_map, weight_planes):
    """Perspective-correct depth [bs, 1, H, W] (reference rasterize.py:80-88)."""
    z0, z1, z2 = fvm_planar[:, 2], fvm_planar[:, 5], fvm_planar[:, 8]
    w0, w1, w2 = weight_planes[:, 0], weight_planes[:, 1], weight_planes[:, 2]
    d = 1.0 / (w0 / z0 + w1 / z1 + w2 / z2)
    return jnp.where((face_index_map >= 0)[:, None], d[:, None], 0.0)


def normal_planes(normal_vertex_planes, weight_planes, smooth=True):
    """Smoothed per-pixel normals [bs, 3, H, W] from the planar gathered
    per-vertex normals [bs, 9, H, W]."""
    n = normal_vertex_planes.reshape(
        normal_vertex_planes.shape[0], 3, 3, *normal_vertex_planes.shape[2:]
    )  # [bs, vertex, xyz, H, W]
    if smooth:
        return jnp.sum(weight_planes[:, :, None] * n, axis=1)
    return jnp.mean(n, axis=1)


def apply_lights_planar(rgb_planes, normal_map_planes, lights):
    """Planar twin of :func:`apply_lights` (reference rasterize.py:252-283);
    rgb/normals are [bs, 3, H, W]."""
    color_weight = jnp.zeros_like(normal_map_planes)
    for light in lights:
        if isinstance(light, light_lib.AmbientLight):
            color_weight += jnp.broadcast_to(
                light.color[:, :, None, None], color_weight.shape
            )
        elif isinstance(light, light_lib.DirectionalLight):
            intensity = jnp.sum(
                -light.direction[:, :, None, None] * normal_map_planes, axis=1
            )
            intensity = jnp.abs(intensity) if light.backside else jax.nn.relu(intensity)
            color_weight += intensity[:, None] * light.color[:, :, None, None]
        elif isinstance(light, light_lib.SpecularLight):
            intensity = -normal_map_planes[:, 2]  # (0,0,1) . -normal
            intensity = jnp.abs(intensity) if light.backside else jax.nn.relu(intensity)
            alpha = light.alpha
            if alpha is None:
                alpha = jnp.ones(light.color.shape[0], dtype=jnp.float32)
            intensity = intensity ** alpha[:, None, None]
            color_weight += intensity[:, None] * light.color[:, :, None, None]
        else:
            raise TypeError("unknown light type: %r" % (light,))
    return rgb_planes * color_weight


def sample_textures_texel_planes(
    fvm_planar, uv_planes, texel_planes, face_index_map, weight_planes,
    eps, texture_size, tile_width,
):
    """Gather-free bilinear sampling from per-face gathered texel
    patches, channel-planar.

    Args:
      fvm_planar: [bs, 9, H, W] gathered winner coords (z at planes 2,5,8).
      uv_planes: [bs, 6, H, W] gathered UV triangle (u0,v0,u1,v1,u2,v2).
      texel_planes: [bs, ts*ts*3, H, W] gathered patch texels.
      weight_planes: [bs, 3, H, W].

    Returns [bs, 3, H, W] RGB.
    """
    ts = texture_size
    fg = face_index_map >= 0
    x_f, y_f = _uv_coords(
        (fvm_planar[:, 2], fvm_planar[:, 5], fvm_planar[:, 8]),
        (uv_planes[:, 0], uv_planes[:, 2], uv_planes[:, 4]),
        (uv_planes[:, 1], uv_planes[:, 3], uv_planes[:, 5]),
        (weight_planes[:, 0], weight_planes[:, 1], weight_planes[:, 2]),
        fg, eps,
    )
    # patch-local texel coordinates of the winning face
    fid = jnp.maximum(face_index_map, 0)
    x_f = x_f - ((fid % tile_width) * ts).astype(jnp.float32)
    y_f = y_f - ((fid // tile_width) * ts).astype(jnp.float32)
    x0, y0, tap_w = _bilinear_taps(x_f, y_f)

    bs = texel_planes.shape[0]
    texels = texel_planes.reshape(bs, ts * ts, 3, *texel_planes.shape[2:])
    if ts == 2:
        # the clamp pins local coords to [0, 1 - eps]: floor = 0, ceil = 1,
        # so the taps ARE the four patch texels -- no selection needed
        taps = tuple(texels[:, t] for t in range(4))
    else:
        # taps are in [0, ts-1]; ceil may weight 0 at the bbox edge --
        # clip keeps it in the patch (its weight is exactly 0 there)
        xi_f = jnp.clip(x0, 0, ts - 1)
        yi_f = jnp.clip(y0, 0, ts - 1)
        xi_c = jnp.clip(xi_f + 1, 0, ts - 1)
        yi_c = jnp.clip(yi_f + 1, 0, ts - 1)

        def tap(xi, yi):
            t = (yi * ts + xi)[:, None]                  # [bs, 1, H, W]
            sel = t == jnp.arange(ts * ts)[None, :, None, None]
            return jnp.sum(sel[:, :, None] * texels, axis=1)

        taps = (tap(xi_f, yi_f), tap(xi_c, yi_f), tap(xi_f, yi_c), tap(xi_c, yi_c))

    images = sum(w[:, None] * t for w, t in zip(tap_w, taps))
    return jnp.where(fg[:, None], images, 0.0)
