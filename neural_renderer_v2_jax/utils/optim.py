"""Optimizers: parameter-wise learning-rate Adam.

JAX equivalent of the reference's custom Adam rule
(neural_renderer_chainer/optimizers.py:6-37): Adam with a *per-parameter*
learning rate, updates skipped entirely when a parameter's lr is 0, and
the second-moment estimate clamped >= 0 (the reference does this in its
elementwise CUDA string kernel, optimizers.py:19-32).  Built as an optax
gradient transformation so it composes with the rest of the ecosystem.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax


class AdamState(NamedTuple):
    count: jnp.ndarray
    mu: Any
    nu: Any


def adam(
    lr: float = 0.001,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    param_lrs: Optional[Mapping[str, Optional[float]]] = None,
):
    """Adam with optional per-parameter learning rates.

    Args:
      lr: default learning rate.
      param_lrs: optional pytree (matching the params' top-level keys)
        of per-parameter lrs; ``None`` entries fall back to ``lr`` and a
        0 entry freezes that parameter (reference AdamRule: "skip update
        when lr == 0").

    Returns an ``optax.GradientTransformation``.
    """

    def effective_lr(path_key):
        if param_lrs is None:
            return lr
        v = param_lrs.get(path_key) if hasattr(param_lrs, "get") else None
        return lr if v is None else v

    def init_fn(params):
        mu = jax.tree_util.tree_map(jnp.zeros_like, params)
        nu = jax.tree_util.tree_map(jnp.zeros_like, params)
        return AdamState(count=jnp.zeros([], jnp.int32), mu=mu, nu=nu)

    def update_fn(updates, state, params=None):
        del params
        count = state.count + 1
        t = count.astype(jnp.float32)

        mu = jax.tree_util.tree_map(
            lambda g, m: beta1 * m + (1 - beta1) * g, updates, state.mu
        )
        # reference clamps v >= 0 in its update kernel
        nu = jax.tree_util.tree_map(
            lambda g, v: jnp.maximum(beta2 * v + (1 - beta2) * g * g, 0.0),
            updates,
            state.nu,
        )

        bc1 = 1 - beta1 ** t
        bc2 = 1 - beta2 ** t

        if param_lrs is not None and hasattr(mu, "keys"):
            step = {
                k: _adam_step(mu[k], nu[k], effective_lr(k), bc1, bc2, eps)
                for k in mu
            }
        else:
            step = jax.tree_util.tree_map(
                lambda m, v: _adam_step(m, v, lr, bc1, bc2, eps), mu, nu
            )
        return step, AdamState(count=count, mu=mu, nu=nu)

    return optax.GradientTransformation(init_fn, update_fn)


def _adam_step(m, v, lr_k, bc1, bc2, eps):
    if lr_k == 0:
        return jax.tree_util.tree_map(jnp.zeros_like, m)
    mhat = jax.tree_util.tree_map(lambda x: x / bc1, m)
    vhat = jax.tree_util.tree_map(lambda x: x / bc2, v)
    return jax.tree_util.tree_map(
        lambda mh, vh: -lr_k * mh / (jnp.sqrt(vh) + eps), mhat, vhat
    )


# Convenience alias matching the reference export name.
Adam = adam
