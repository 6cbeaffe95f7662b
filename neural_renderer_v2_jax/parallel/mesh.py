"""Device-mesh construction for distributed rendering.

Two mesh axes (both absent in the reference, which had no distributed
runtime at all -- SURVEY.md section 2.2):

  * ``data`` -- data parallelism over the batch/camera axis.
  * ``tile`` -- image-tile ("sequence"-style) parallelism over pixel rows:
    each device rasterizes a horizontal band of the image.  The z-buffer
    resolve is row-local, so no communication happens in the forward pass;
    vertex/texture gradients are combined by the psum that shard_map's
    transpose inserts for replicated inputs.

Use :func:`make_mesh` on any device set (the GPUs of a host, or the CPU
``--xla_force_host_platform_device_count`` mesh used in tests/dry runs).
The GPUs of a host are joined all to all, so the mesh follows the
algorithm alone; device order does not matter.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(data=1, tile=None, face=1, devices=None):
    """Build a (data, tile[, face]) mesh.

    Args:
      data: size of the data-parallel axis.
      tile: size of the image-tile axis; default = remaining devices.
      face: size of the face-sharding axis (parallel/faces.py); when > 1
        the mesh has a third "face" axis and the resolve's face loop is
        distributed with an ordered z-combine.
      devices: explicit device list; default all local devices.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if tile is None:
        assert n % (data * face) == 0, (n, data, face)
        tile = n // (data * face)
    assert data * tile * face <= n, (data, tile, face, n)
    if face == 1:
        devs = np.asarray(devices[: data * tile]).reshape(data, tile)
        return Mesh(devs, axis_names=("data", "tile"))
    devs = np.asarray(devices[: data * tile * face]).reshape(data, tile, face)
    return Mesh(devs, axis_names=("data", "tile", "face"))


# Faces per device below which the face axis stops paying: under it the
# tile axis (which also divides the pixel-bound stages and the NMR
# backward) wins.  Carried over from an earlier platform; not measured
# on the GPU.
FACE_AXIS_CROSSOVER = 10_000


def auto_mesh(n_devices=None, num_faces=None):
    """Heuristic mesh: prefer tile-parallelism (helps even at batch 1);
    add a modest data axis only once there are >= 8 devices; and when the
    face count is known, give the ``face`` axis (parallel/faces.py) every
    doubling that still leaves each shard above FACE_AXIS_CROSSOVER
    faces -- at large face counts the resolve's face loop is the
    dominant cost and is divided across devices.

    Args:
      num_faces: faces in the scene, if known.  Without it the mesh has
        no face axis (the conservative choice for small meshes).
    """
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    data = 2 if n >= 8 and n % 2 == 0 else 1
    rem = n // data
    face = 1
    if num_faces is not None:
        while (
            face * 2 <= rem
            and rem % (face * 2) == 0
            and num_faces // (face * 2) >= FACE_AXIS_CROSSOVER
        ):
            face *= 2
    return make_mesh(data=data, tile=rem // face, face=face, devices=devices)
