"""Scene helpers: texture-atlas creation, spherical camera placement,
image I/O, GIF assembly, and host->device transfer.

Reference semantics: neural_renderer_torch/utils.py:10-72 (make_gif,
to_gpu, imread, create_textures, get_points_from_angles).
"""

from __future__ import annotations

import glob
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np


def _imageio():
    """imageio is optional: only image and GIF I/O need it."""
    import imageio.v2 as imageio

    return imageio


def make_gif(working_directory, filename):
    """Assemble _tmp_*.png frames into a GIF.

    Prefers imageio (always available here); falls back to ImageMagick
    ``convert`` like the reference (utils.py:10-15).
    """
    frames = sorted(glob.glob("%s/_tmp_*.png" % working_directory))
    if not frames:
        return
    imageio = _imageio()
    try:
        images = [imageio.imread(f) for f in frames]
        imageio.mimsave(filename, images, duration=0.08, loop=0)
    except Exception:  # pragma: no cover - ImageMagick fallback
        subprocess.call(
            "convert -delay 8 -loop 0 %s/_tmp_*.png %s" % (working_directory, filename),
            shell=True,
        )
    for f in frames:
        os.remove(f)


def to_device(data, device=None):
    """Move array(s) onto a jax device (the reference's ``to_gpu``,
    utils.py:18-22).  Accepts tuples/lists and numpy arrays."""
    if device is None:
        device = jax.devices()[0]
    if isinstance(data, (tuple, list)):
        return [jax.device_put(jnp.asarray(d), device) for d in data]
    return jax.device_put(jnp.asarray(data), device)


# API-parity alias: the reference exports ``to_gpu``.
to_gpu = to_device


def imread(filename):
    """Read an image as float32 in [0, 1] (utils.py:25-27)."""
    return np.asarray(_imageio().imread(filename), dtype=np.float32) / 255.0


def imsave(filename, image):
    """Write a float image in [0,1] (or already-uint8) to disk."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = np.clip(image * 255.0, 0, 255).astype(np.uint8)
    _imageio().imwrite(filename, image)


def create_textures(num_faces, texture_size=16, flatten=False):
    """Build a white tiled UV atlas plus per-face UV triangles.

    Returns (vertices_t [nf*3, 2] texel coords, faces_t [nf, 3] int32,
    textures [3, H, W]).  Reference: utils.py:30-52.
    """
    if not flatten:
        tile_width = int((num_faces - 1.0) ** 0.5) + 1
        tile_height = int((num_faces - 1.0) / tile_width) + 1
    else:
        tile_width = 1
        tile_height = num_faces
    textures = np.ones((3, tile_height * texture_size, tile_width * texture_size), np.float32)

    vertices = np.zeros((num_faces, 3, 2), np.float32)  # [:, :, XY]
    face_nums = np.arange(num_faces)
    column = face_nums % tile_width
    row = face_nums // tile_width
    vertices[:, 0, 0] = column * texture_size
    vertices[:, 0, 1] = row * texture_size
    vertices[:, 1, 0] = column * texture_size
    vertices[:, 1, 1] = (row + 1) * texture_size - 1
    vertices[:, 2, 0] = (column + 1) * texture_size - 1
    vertices[:, 2, 1] = (row + 1) * texture_size - 1
    vertices = vertices.reshape((num_faces * 3, 2))
    faces = np.arange(num_faces * 3).reshape((num_faces, 3)).astype(np.int32)

    return vertices, faces, textures


def get_points_from_angles(distance, elevation, azimuth, degrees=True):
    """Spherical -> cartesian camera position.

    Python-scalar inputs return a plain float tuple; array inputs return a
    differentiable [bs, 3] jnp array (example4 optimises through this).
    Reference: utils.py:55-72 -- including its low-precision degree/radian
    constant on the tensor path (3.14159265359/180).
    """
    if isinstance(distance, (float, int)) and isinstance(elevation, (float, int)) \
            and isinstance(azimuth, (float, int)):
        if degrees:
            elevation = np.radians(elevation)
            azimuth = np.radians(azimuth)
        return (
            distance * np.cos(elevation) * np.sin(azimuth),
            distance * np.sin(elevation),
            -distance * np.cos(elevation) * np.cos(azimuth),
        )
    distance = jnp.asarray(distance, dtype=jnp.float32)
    elevation = jnp.asarray(elevation, dtype=jnp.float32)
    azimuth = jnp.asarray(azimuth, dtype=jnp.float32)
    if degrees:
        elevation = elevation / 180.0 * 3.14159265359
        azimuth = azimuth / 180.0 * 3.14159265359
    return jnp.stack(
        [
            distance * jnp.cos(elevation) * jnp.sin(azimuth),
            distance * jnp.sin(elevation),
            -distance * jnp.cos(elevation) * jnp.cos(azimuth),
        ],
        axis=-1,
    )
