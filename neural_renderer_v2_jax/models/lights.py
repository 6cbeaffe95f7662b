"""Light sources.

Pytree-registered frozen dataclasses, so a list of lights can flow
straight through ``jax.jit`` / ``jax.grad`` -- colors, directions and
specular exponents are all leaves and therefore differentiable.

Reference: neural_renderer_torch/lights.py:4-39.  Shading math lives in
ops/shading.py (reference rasterize.py:252-283).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp


def _pytree(cls):
    """Frozen dataclass registered as a pytree whose ``backside`` field
    (when present) is static; every other field is a leaf."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    names = [f.name for f in dataclasses.fields(cls)]
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(
        cls,
        data_fields=[n for n in names if n != "backside"],
        meta_fields=[n for n in names if n == "backside"],
    )


class Light:
    """Base class for light sources (reference lights.py:4-8) -- a real
    class, so reference-style ``isinstance(x, Light)`` checks AND
    user-defined subclasses of the concrete lights behave exactly as
    they do with the reference."""


@_pytree
class AmbientLight(Light):
    """Flat per-batch color added to the color-weight map."""

    color: jnp.ndarray  # [bs, 3]


@_pytree
class DirectionalLight(Light):
    """Lambertian light: intensity = relu(-direction . normal)
    (or abs(.) when ``backside``)."""

    color: jnp.ndarray      # [bs, 3]
    direction: jnp.ndarray  # [bs, 3]
    backside: bool = False


@_pytree
class SpecularLight(Light):
    """View-aligned specular: intensity = ((0,0,1) . -normal)^alpha."""

    color: jnp.ndarray                 # [bs, 3]
    alpha: Optional[jnp.ndarray] = None  # [bs]; None -> ones
    backside: bool = False
