"""Wavefront OBJ / MTL I/O and texture-atlas packing (host-side numpy).

Semantics match the reference loader so that meshes + UV atlases produced
by either library are interchangeable:
  - ``load_obj``           (reference: neural_renderer_torch/load_obj.py:113-166)
  - ``load_mtl``           (reference: neural_renderer_torch/load_obj.py:7-22)
  - ``load_textures``      (reference: neural_renderer_torch/load_obj.py:25-110)
  - ``save_obj``           (reference: neural_renderer_torch/save_obj.py:5-47)

Key behaviors preserved:
  * polygon faces are fan-triangulated;
  * vertices are normalized into a centred ~unit-2 cube
    (min-shift, /max|.|, *2, -max/2);
  * multi-material texture images are stacked vertically into a single
    atlas, padding widths with zeros; flat-Kd materials become 2x2 colour
    patches with three synthetic UV vertices;
  * UVs are rescaled to *texel* coordinates (multiplied by width-1 /
    height-1 and offset by the vertical position in the atlas);
  * texture rows are flipped vertically at load (image origin top-left ->
    UV origin bottom-left);
  * ``save_obj`` writes v/vt/f + .mtl + .png, normalizing UVs back to [0,1].

This is deliberately a from-scratch reimplementation with a line tokenizer
(single pass per file) rather than a translation; an optional C++ fast
path for very large meshes lives in ``native/`` and is used when built.
"""

from __future__ import annotations

import os

import numpy as np

from .helpers import _imageio


def load_mtl(filename_mtl):
    """Parse newmtl/Kd/map_Kd entries.  Returns {name: {color|texture_filename}}.

    Reference: neural_renderer_torch/load_obj.py:7-22.
    """
    materials = {}
    material_name = ""
    with open(filename_mtl) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "newmtl":
                material_name = parts[1]
                materials[material_name] = {}
            elif parts[0] == "map_Kd":
                materials[material_name]["texture_filename"] = parts[1]
            elif parts[0] == "Kd":
                materials[material_name]["color"] = np.array(
                    [float(v) for v in parts[1:4]]
                )
    return materials


def load_textures(filename_obj, filename_mtl):
    """Load UV vertices/faces and pack all material textures into one atlas.

    Returns (vertices_t [nvt, 2] float32 texel coords,
             faces_t [nf, 3] int32,
             textures [3, H, W] float32 in [0, 1]).

    Reference: neural_renderer_torch/load_obj.py:25-110.
    """
    # UV vertices
    vertices = []
    with open(filename_obj) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "vt":
                vertices.append([float(v) for v in parts[1:3]])
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 2)

    # UV faces, tracking the active material per face (fan triangulation)
    faces = []
    material_names = []
    material_name = ""
    with open(filename_obj) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "f":
                vs = parts[1:]
                uv_ids = []
                for v in vs:
                    if "/" in v:
                        uv_ids.append(int(v.split("/")[1]))
                    else:
                        uv_ids.append(0)
                for i in range(len(vs) - 2):
                    faces.append((uv_ids[0], uv_ids[i + 1], uv_ids[i + 2]))
                    material_names.append(material_name)
            elif parts[0] == "usemtl":
                material_name = parts[1]
    faces = np.asarray(faces, dtype=np.int32) - 1
    material_names = np.asarray(material_names)

    materials = load_mtl(filename_mtl)

    # Pack textures vertically into one atlas, rescaling UVs to texel coords.
    pos = 0
    atlas = np.zeros((3, 0, 0), dtype=np.float32)
    for material_name, material in materials.items():
        if "texture_filename" in material:
            texture = _imageio().imread(
                os.path.join(os.path.dirname(filename_mtl), material["texture_filename"])
            )
            texture = texture.astype(np.float32) / 255.0
            if texture.ndim == 2:
                texture = np.stack([texture] * 3, axis=-1)
            texture = texture[:, :, :3].transpose(2, 0, 1)
            texture = texture[:, ::-1, :]  # image rows -> UV rows

            indices = np.unique(faces[material_names == material_name].flatten())
            vertices[indices, 0] *= texture.shape[2] - 1  # x -> texels
            vertices[indices, 1] *= texture.shape[1] - 1  # y -> texels
            vertices[indices, 1] += pos
        else:
            color = material["color"]
            texture = np.ones((3, 2, 2), dtype=np.float32) * color[:, None, None]
            # three synthetic UV vertices pointing into the 2x2 patch
            extra = np.zeros((3, 2), dtype=np.float32)
            extra[0] = (0, pos)
            extra[1] = (0, pos + 1)
            extra[2] = (1, pos + 1)
            vertices = np.concatenate((vertices, extra), axis=0)
            n = vertices.shape[0]
            faces[material_names == material_name] = np.array([n - 3, n - 2, n - 1])

        pos += texture.shape[1]
        # pad widths with zeros so all strips share the atlas width
        if atlas.shape[2] < texture.shape[2]:
            atlas = np.concatenate(
                (atlas, np.zeros((3, atlas.shape[1], texture.shape[2] - atlas.shape[2]), np.float32)),
                axis=2,
            )
        elif texture.shape[2] < atlas.shape[2]:
            texture = np.concatenate(
                (texture, np.zeros((3, texture.shape[1], atlas.shape[2] - texture.shape[2]), np.float32)),
                axis=2,
            )
        atlas = np.concatenate((atlas, texture), axis=1).astype(np.float32)

    return vertices.astype(np.float32), faces, atlas


# alias kept for API parity with the reference (load_obj.py:25) and so the
# module-level function survives the keyword shadow inside ``load_obj``.
load_textures_func = load_textures


def load_obj(filename_obj, normalization=True, load_textures_flag=None, *, load_textures=False):
    """Load a Wavefront .obj file.

    Supports v / f lines (with fan triangulation) and, when
    ``load_textures=True``, vt / usemtl / mtllib texture loading into a
    single packed atlas.

    Returns (vertices [nv,3] f32, faces [nf,3] i32) or, with textures,
    (vertices, faces, vertices_t, faces_t, textures).

    Reference: neural_renderer_torch/load_obj.py:113-166.
    """
    if load_textures_flag is not None:  # positional-compat shim
        load_textures = load_textures_flag

    # geometry pass: native C++ parser when available (identical output),
    # pure-Python fallback otherwise
    native = None
    try:
        from .native_loader import parse_obj_native

        native = parse_obj_native(filename_obj)
    except FileNotFoundError:
        raise
    except Exception:
        native = None

    mtl_name = None
    with open(filename_obj) as f:
        for line in f:
            if line.startswith("mtllib"):
                mtl_name = line.split()[1]
                break

    if native is not None:
        vertices, faces = native[0], native[1]
    else:
        vertices = []
        faces = []
        with open(filename_obj) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "v":
                    vertices.append([float(v) for v in parts[1:4]])
                elif parts[0] == "f":
                    vs = parts[1:]
                    ids = [int(v.split("/")[0]) for v in vs]
                    for i in range(len(vs) - 2):
                        faces.append((ids[0], ids[i + 1], ids[i + 2]))
        vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
        faces = np.asarray(faces, dtype=np.int32) - 1

    textures = None
    if load_textures:
        if mtl_name is None:
            raise RuntimeError("Failed to load textures (no mtllib in %s)." % filename_obj)
        filename_mtl = os.path.join(os.path.dirname(filename_obj), mtl_name)
        vertices_t, faces_t, textures = load_textures_func(filename_obj, filename_mtl)

    # normalize into a centred ~unit-2 cube (load_obj.py:157-161)
    if normalization:
        vertices = vertices - vertices.min(0)[None, :]
        vertices = vertices / np.abs(vertices).max()
        vertices = vertices * 2
        vertices = vertices - vertices.max(0)[None, :] / 2

    if load_textures:
        return vertices, faces, vertices_t, faces_t, textures
    return vertices, faces


def save_obj(filename, vertices, faces, vertices_t=None, faces_t=None, textures=None):
    """Write mesh (and optional texture atlas) as obj/mtl/png.

    UVs are normalized back from texel coordinates to [0, 1]; the texture
    image rows are flipped back to image order.

    Reference: neural_renderer_torch/save_obj.py:5-47.
    """
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    assert vertices.ndim == 2
    assert faces.ndim == 2

    filename_mtl = filename[:-4] + ".mtl"
    filename_texture = filename[:-4] + ".png"
    material_name = "material_1"

    if textures is not None:
        textures = np.asarray(textures)
        tex_img = textures[:, ::-1, :]
        tex_u8 = np.clip(tex_img.transpose(1, 2, 0) * 255.0, 0, 255).astype(np.uint8)
        _imageio().imwrite(filename_texture, tex_u8)

    with open(filename, "w") as f:
        f.write("# %s\n" % os.path.basename(filename))
        f.write("#\n")
        f.write("\n")

        if textures is not None:
            f.write("mtllib %s\n\n" % os.path.basename(filename_mtl))

        for vertex in vertices:
            f.write("v %.8f %.8f %.8f\n" % (vertex[0], vertex[1], vertex[2]))
        f.write("\n")

        if textures is not None:
            vertices_t = np.array(vertices_t, dtype=np.float32, copy=True)
            vertices_t[:, 0] /= textures.shape[2] - 1
            vertices_t[:, 1] /= textures.shape[1] - 1
            for vertex in vertices_t.reshape(-1, 2):
                f.write("vt %.8f %.8f\n" % (vertex[0], vertex[1]))
            f.write("\n")
            f.write("usemtl %s\n" % material_name)
            for face, face_t in zip(faces, faces_t):
                f.write(
                    "f %d/%d %d/%d %d/%d\n"
                    % (
                        face[0] + 1, face_t[0] + 1,
                        face[1] + 1, face_t[1] + 1,
                        face[2] + 1, face_t[2] + 1,
                    )
                )
            f.write("\n")
        else:
            for face in faces:
                f.write("f %d %d %d\n" % (face[0] + 1, face[1] + 1, face[2] + 1))

    if textures is not None:
        with open(filename_mtl, "w") as f:
            f.write("newmtl %s\n" % material_name)
            f.write("map_Kd %s\n" % os.path.basename(filename_texture))
