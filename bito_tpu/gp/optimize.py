"""Vectorized 1-D optimizers for batched branch-length optimization.

JAX rebuild of the reference Optimization namespace
(reference: src/optimization.hpp:13-402): BrentMinimize (the Boost-adapted
variant with a caller-supplied initial guess), BrentMinimizeWithGradients
(gradient-step fallback when the trial point fails to improve),
GradientAscent, LogSpaceGradientAscent, NewtonRaphson.  The reference runs
one serial line search per edge inside the op tape; here a whole level's
edges are optimized simultaneously: every lane carries its own optimizer
state and the objective is one batched XLA evaluation per iteration
(SURVEY §7 "batched fixed-iteration bracketed optimization with per-edge
convergence masks").

Trajectory fidelity: each lane replicates the serial algorithm exactly —
same guess initialization, the Boost tolerance ldexp(1, 1-digits), the same
bracket-shrinking updates, and a per-lane `done` mask that freezes a lane
once the serial loop would have broken, so a batched sweep produces the
same optima as the reference's one-edge-at-a-time Brent (needed for the
DS1 NNI golden-run regression).

All optimizers work in log-branch-length space with the reference's bounds
(src/dag_branch_handler.hpp:272-294: [-13.9, 1.1], 10 significant digits,
step sizes 5e-4 / 1.0005, max 1000 iterations).
"""
from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

# float32 of the reference's "golden ratio, don't need too much precision
# here!" constant (src/optimization.hpp:208): 2 - phi rounded to f32.
# float32 of the reference's 0.3819660f; computed via numpy so
# importing the package never touches a device.
GOLDEN = float(np.float32(0.3819660))

SIGNIFICANT_DIGITS = 10       # src/dag_branch_handler.hpp:288
STEP_SIZE = 5e-4              # src/dag_branch_handler.hpp:291
LOG_SPACE_STEP_SIZE = 1.0005  # src/dag_branch_handler.hpp:292
MAX_ITER = 1000               # src/dag_branch_handler.hpp:294
NEWTON_DENOM_TOL = 1e-10      # src/dag_branch_handler.hpp:290


def _batched_grad(f):
    """Per-lane derivative of a batched R^K -> R^K objective (each output
    lane depends only on its own input lane), via one jvp with a ones
    tangent."""

    def fprime(y):
        _, dy = jax.jvp(f, (y,), (jnp.ones_like(y),))
        return dy

    return fprime


def brent_minimize_batched(
    f: Callable[[jnp.ndarray], jnp.ndarray],
    guess: jnp.ndarray,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    significant_digits: int = SIGNIFICANT_DIGITS,
    iterations: int = 40,
    use_gradients: bool = False,
    step_size: float = STEP_SIZE,
) -> jnp.ndarray:
    """Brent minimization (reference Optimization::BrentMinimize,
    src/optimization.hpp:70-188, and ::BrentMinimizeWithGradients,
    190-329 when use_gradients), vectorized: each lane of guess/lo/hi is an
    independent minimization of the batched objective f.

    Returns the argmin y.  Callers replicate the reference's reset-if-worse
    guard (dag_branch_handler.cpp:143-150) by comparing f(y) to f(guess).
    """
    tolerance = math.ldexp(1.0, 1 - significant_digits)
    fprime = _batched_grad(f) if use_gradients else None

    x = guess
    fx = f(x)
    state = dict(
        lo=lo, hi=hi, x=x, w=x, v=x, fx=fx, fw=fx, fv=fx,
        delta=jnp.zeros_like(x), delta2=jnp.zeros_like(x),
        done=jnp.zeros(x.shape, dtype=bool),
    )

    def body(_, s):
        lo, hi, x, w, v = s["lo"], s["hi"], s["x"], s["w"], s["v"]
        fx, fw, fv = s["fx"], s["fw"], s["fv"]
        delta, delta2, done = s["delta"], s["delta2"], s["done"]

        mid = 0.5 * (lo + hi)
        fract1 = tolerance * jnp.abs(x) + tolerance / 4.0
        fract2 = 2.0 * fract1
        done = done | (jnp.abs(x - mid) <= (fract2 - 0.5 * (hi - lo)))

        # Parabolic fit through (x, w, v); only attempted when the
        # step-before-last moved more than fract1.
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * r
        q = 2.0 * (q - r)
        p = jnp.where(q > 0, -p, p)
        q = jnp.abs(q)
        td = delta2
        accept = (
            (jnp.abs(delta2) > fract1)
            & ~(jnp.abs(p) >= jnp.abs(q * td / 2.0))
            & ~(p <= q * (lo - x))
            & ~(p >= q * (hi - x))
        )
        delta_para = p / jnp.where(q == 0, 1.0, q)
        u_para = x + delta_para
        # Near-bound parabolic steps degrade to a minimal move toward mid.
        delta_para = jnp.where(
            ((u_para - lo) < fract2) | ((hi - u_para) < fract2),
            jnp.where((mid - x) < 0, -jnp.abs(fract1), jnp.abs(fract1)),
            delta_para,
        )
        # Golden bisection (always recomputes delta2; the parabolic branch
        # preserves the previous delta as delta2 only when accepted).
        delta2_gold = jnp.where(x >= mid, lo - x, hi - x)
        delta_new = jnp.where(accept, delta_para, GOLDEN * delta2_gold)
        delta2_new = jnp.where(accept, delta, delta2_gold)

        u = jnp.where(
            jnp.abs(delta_new) >= fract1, x + delta_new,
            jnp.where(delta_new > 0, x + jnp.abs(fract1),
                      x - jnp.abs(fract1)),
        )
        fu = f(u)
        improved = fu <= fx

        if use_gradients:
            # Reference BrentMinimizeWithGradients: when the trial point is
            # worse, try one gradient-descent step from x before giving up.
            u_g = x - step_size * fprime(x)
            fu_g = f(u_g)
            grad_improved = ~improved & (fu_g <= fx)
            u = jnp.where(grad_improved, u_g, u)
            fu = jnp.where(grad_improved, fu_g, fu)
            improved = improved | grad_improved

        # Bracket updates: improvement moves the far bracket to x; failure
        # moves the near bracket to u.
        lo_new = jnp.where(improved, jnp.where(u >= x, x, lo),
                           jnp.where(u < x, u, lo))
        hi_new = jnp.where(improved, jnp.where(u >= x, hi, x),
                           jnp.where(u < x, hi, u))
        # Control-point updates.
        second = (fu <= fw) | (w == x)
        third = (fu <= fv) | (v == x) | (v == w)
        v_new = jnp.where(improved, w, jnp.where(second, w,
                          jnp.where(third, u, v)))
        fv_new = jnp.where(improved, fw, jnp.where(second, fw,
                           jnp.where(third, fu, fv)))
        w_new = jnp.where(improved, x, jnp.where(second, u, w))
        fw_new = jnp.where(improved, fx, jnp.where(second, fu, fw))
        x_new = jnp.where(improved, u, x)
        fx_new = jnp.where(improved, fu, fx)

        def frz(new, old):
            return jnp.where(done, old, new)

        return dict(
            lo=frz(lo_new, lo), hi=frz(hi_new, hi),
            x=frz(x_new, x), w=frz(w_new, w), v=frz(v_new, v),
            fx=frz(fx_new, fx), fw=frz(fw_new, fw), fv=frz(fv_new, fv),
            delta=frz(delta_new, delta), delta2=frz(delta2_new, delta2),
            done=done,
        )

    state = jax.lax.fori_loop(0, iterations, body, state)
    return state["x"]


def gradient_ascent_batched(
    f_and_fprime: Callable[[jnp.ndarray], tuple],
    x: jnp.ndarray,
    min_x: jnp.ndarray,
    significant_digits: int = SIGNIFICANT_DIGITS,
    step_size: float = STEP_SIZE,
    max_iter: int = MAX_ITER,
) -> jnp.ndarray:
    """Reference Optimization::GradientAscent (src/optimization.hpp:331-345):
    fixed-step ascent on f(x) with floor min_x; stops per lane when
    |f'(x)| < |f(x)| * 10^-digits."""
    tolerance = 10.0 ** (-significant_digits)

    def cond(carry):
        _, done, it = carry
        return (it <= max_iter) & ~jnp.all(done)

    def body(carry):
        x, done, it = carry
        fx, gx = f_and_fprime(x)
        new_x = jnp.maximum(x + gx * step_size, min_x)
        x = jnp.where(done, x, new_x)
        done = done | (jnp.abs(gx) < jnp.abs(fx) * tolerance)
        return x, done, it + 1

    x, _, _ = jax.lax.while_loop(
        cond, body, (x, jnp.zeros(x.shape, dtype=bool), 0))
    return x


def log_space_gradient_ascent_batched(
    f_and_fprime: Callable[[jnp.ndarray], tuple],
    x: jnp.ndarray,
    min_x: jnp.ndarray,
    significant_digits: int = SIGNIFICANT_DIGITS,
    log_space_step_size: float = LOG_SPACE_STEP_SIZE,
    max_iter: int = MAX_ITER,
) -> jnp.ndarray:
    """Reference Optimization::LogSpaceGradientAscent
    (src/optimization.hpp:347-365): ascent on y = log x with the chain-rule
    gradient x * f'(x)."""
    tolerance = 10.0 ** (-significant_digits)

    def cond(carry):
        _, done, it = carry
        return (it <= max_iter) & ~jnp.all(done)

    def body(carry):
        x, done, it = carry
        fx, gx = f_and_fprime(x)
        new_x = jnp.maximum(jnp.exp(jnp.log(x) + x * gx
                                    * log_space_step_size), min_x)
        x = jnp.where(done, x, new_x)
        done = done | (jnp.abs(gx) < jnp.abs(fx) * tolerance)
        return x, done, it + 1

    x, _, _ = jax.lax.while_loop(
        cond, body, (x, jnp.zeros(x.shape, dtype=bool), 0))
    return x


def newton_raphson_batched(
    f_and_two_derivatives: Callable[[jnp.ndarray], tuple],
    y: jnp.ndarray,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    significant_digits: int = SIGNIFICANT_DIGITS,
    epsilon: float = NEWTON_DENOM_TOL,
    max_iter: int = MAX_ITER,
) -> jnp.ndarray:
    """Reference Optimization::NewtonRaphsonOptimization
    (src/optimization.hpp:367-402) in log-branch-length space: the callable
    returns (f, f', f'') wrt y = log(branch length) — the caller applies the
    chain rule (gp_engine.cpp:643-653: f'_y = x f'_x, f''_y = f'_y +
    x^2 f''_x).  Per-lane stopping mirrors the serial loop: tiny second
    derivative, tiny step, or relative first-derivative convergence."""
    tolerance = 10.0 ** (-significant_digits)

    def cond(carry):
        _, done, it = carry
        return (it <= max_iter) & ~jnp.all(done)

    def body(carry):
        y, done, it = carry
        fy, gy, hy = f_and_two_derivatives(y)
        done = done | (jnp.abs(hy) < epsilon)
        new_y = y - gy / jnp.where(hy == 0, 1.0, hy)
        new_y = jnp.where(new_y < lo, y - 0.5 * (y - lo), new_y)
        new_y = jnp.where(new_y > hi, y - 0.5 * (y - hi), new_y)
        delta = jnp.abs(y - new_y)
        # The serial loop returns the PRE-step x when a stop criterion
        # fires (src/optimization.hpp:394-396), so stopping lanes freeze
        # before applying this step.
        stop = (delta < tolerance) | (jnp.abs(gy) < jnp.abs(fy) * tolerance)
        y = jnp.where(done | stop, y, new_y)
        done = done | stop
        return y, done, it + 1

    y, _, _ = jax.lax.while_loop(
        cond, body, (y, jnp.zeros(y.shape, dtype=bool), 0))
    return y


# Backwards-compatible alias: the original round-1 safeguarded Newton
# maximizer signature, retained for external callers.
def newton_maximize_batched(
    fdf: Callable[[jnp.ndarray], tuple],
    init: jnp.ndarray,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    iterations: int = 25,
    epsilon: float = 1e-5,
) -> jnp.ndarray:
    """Maximize via newton_raphson_batched given fdf(y) -> (f'(y), f''(y));
    the reference's relative-f stop is disabled (f unknown), leaving the
    step-size and curvature stops."""

    def f3(y):
        g, h = fdf(y)
        return jnp.full_like(y, jnp.inf), g, h

    return newton_raphson_batched(f3, jnp.clip(init, lo, hi), lo, hi,
                                  epsilon=epsilon, max_iter=iterations)
