"""Clock models: none, strict.

JAX rebuild of the reference ClockModel (reference:
src/clock_model.hpp:23-46).  "none" fixes the rate at 1 (unrooted/classical
likelihoods); "strict" applies one global rate to all branches of a rooted
time tree.
"""
from __future__ import annotations

import jax.numpy as jnp


class ClockModelSpec:
    def __init__(self, spec: str):
        if spec not in ("none", "strict"):
            raise ValueError(f"Clock model not known: {spec}")
        self.spec = spec

    @property
    def param_counts(self):
        if self.spec == "none":
            return {}
        return {"clock_model_rates": 1}

    def default_params(self):
        if self.spec == "none":
            return {}
        return {"clock_model_rates": jnp.array([1.0])}

    def rate(self, params) -> jnp.ndarray:
        if self.spec == "none":
            return jnp.ones(())
        return jnp.asarray(params["clock_model_rates"])[0]
