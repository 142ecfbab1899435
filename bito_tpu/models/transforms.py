"""Simplex (stick-breaking) transform, Stan convention.

JAX rebuild of the reference StickBreakingTransform
(reference: src/stick_breaking_transform.cpp:20-57, following
mc-stan.org/docs simplex-transform).  Pure JAX and differentiable, so the
substitution-model gradients that the reference obtains by central finite
differences (src/fat_beagle.cpp:422-508) come from autodiff here.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def stick_breaking_forward(y: jnp.ndarray) -> jnp.ndarray:
    """Unconstrained y (K-1) -> simplex x (K)."""
    K = y.shape[-1] + 1
    offsets = jnp.log(jnp.arange(K - 1, 0, -1, dtype=y.dtype))
    z = 1.0 / (1.0 + jnp.exp(-(y - offsets)))
    # x_k = z_k * prod_{j<k} (1 - z_j)
    one_minus = jnp.concatenate([jnp.ones_like(z[..., :1]), 1.0 - z], axis=-1)
    stick = jnp.cumprod(one_minus, axis=-1)
    x_head = stick[..., :-1] * z
    x_tail = stick[..., -1:]
    return jnp.concatenate([x_head, x_tail], axis=-1)


def stick_breaking_inverse(x: np.ndarray) -> np.ndarray:
    """Simplex x (K) -> unconstrained y (K-1)."""
    x = np.asarray(x, dtype=np.float64)
    K = x.shape[-1]
    y = np.zeros(K - 1)
    total = 0.0
    for k in range(K - 1):
        z = x[k] / (1.0 - total)
        y[k] = np.log(z / (1.0 - z)) + np.log(K - k - 1)
        total += x[k]
    return y
