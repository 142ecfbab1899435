"""Across-site rate-variation models: constant, Weibull+K, Gamma+K.

JAX rebuild of the reference SiteModel (reference:
src/site_model.cpp:10-78, src/site_model.hpp:27-79).  The Weibull model uses
the reference's median discretization (inverse CDF at (2i+1)/2K quantiles,
scale fixed so rates are mean-normalized); its rate gradient falls out of JAX
autodiff rather than the hand-derived formula
(reference WeibullSiteModel::UpdateRates, src/site_model.cpp:37-63).

Gamma+K (median discretization, mean-normalized, Yang 1994) is added beyond
the reference because the driver's headline benchmark is "GTR+Gamma"; Weibull
plays that role in bito itself.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def weibull_category_rates(shape: jnp.ndarray, category_count: int) -> jnp.ndarray:
    """Median-discretized Weibull rates, normalized to mean 1
    (reference src/site_model.cpp:37-63)."""
    shape = jnp.asarray(shape).reshape(())
    k = jnp.arange(category_count, dtype=shape.dtype)
    quantiles = (2.0 * k + 1.0) / (2.0 * category_count)
    rates = (-jnp.log1p(-quantiles)) ** (1.0 / shape)
    return rates / jnp.mean(rates)


def gamma_median_category_rates(shape: jnp.ndarray, category_count: int) -> jnp.ndarray:
    """Median-discretized Gamma(shape, rate=shape) rates, mean-normalized
    (Yang 1994 median method).  Uses a Newton solve of the regularized
    incomplete gamma for the quantile, which is jit/vmap friendly."""
    a = jnp.asarray(shape).reshape(())
    k = jnp.arange(category_count, dtype=a.dtype)
    quantiles = (2.0 * k + 1.0) / (2.0 * category_count)
    x = _gamma_quantile(quantiles, a)
    rates = x / a  # Gamma(shape=a, rate=a) has mean 1 before discretization
    return rates / jnp.mean(rates)


def _gamma_quantile(p: jnp.ndarray, a: jnp.ndarray, iters: int = 30) -> jnp.ndarray:
    """Inverse regularized lower incomplete gamma via Newton iterations on
    gammainc; Wilson-Hilferty initialization."""
    # Wilson-Hilferty approximation for the starting point.
    from jax.scipy.special import gammainc, gammaln
    from jax.scipy.stats import norm

    z = norm.ppf(p)
    wh = a * (1.0 - 1.0 / (9.0 * a) + z / (3.0 * jnp.sqrt(a))) ** 3
    x0 = jnp.maximum(wh, 1e-8)

    def body(_, x):
        f = gammainc(a, x) - p
        # pdf of Gamma(a, 1)
        logpdf = (a - 1.0) * jnp.log(x) - x - gammaln(a)
        step = f / jnp.exp(logpdf)
        x_new = x - step
        return jnp.where(x_new > 0, x_new, x / 2.0)

    return jax.lax.fori_loop(0, iters, body, x0)


class SiteModelSpec:
    """Factory matching reference SiteModel::OfSpecification
    (src/site_model.cpp:10-25); accepts "constant", "weibull[+K]", "gamma[+K]"."""

    def __init__(self, spec: str):
        self.spec = spec
        if spec == "constant":
            self.kind = "constant"
            self.category_count = 1
        elif spec.startswith("weibull") or spec.startswith("gamma"):
            self.kind = "weibull" if spec.startswith("weibull") else "gamma"
            self.category_count = int(spec.split("+")[1]) if "+" in spec else 4
        else:
            raise ValueError(f"Site model not known: {spec}")

    @property
    def param_counts(self):
        if self.kind == "constant":
            return {}
        return {"site_model_parameters": 1}

    def default_params(self):
        if self.kind == "constant":
            return {}
        return {"site_model_parameters": jnp.array([1.0])}

    def category_rates(self, params) -> jnp.ndarray:
        if self.kind == "constant":
            return jnp.ones((1,))
        shape = jnp.asarray(params["site_model_parameters"])[0]
        if self.kind == "weibull":
            return weibull_category_rates(shape, self.category_count)
        return gamma_median_category_rates(shape, self.category_count)

    def category_proportions(self, params) -> jnp.ndarray:
        return jnp.full((self.category_count,), 1.0 / self.category_count)
