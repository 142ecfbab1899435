"""Substitution models: JC69, HKY, GTR.

JAX rebuild of the reference SubstitutionModel hierarchy
(reference: src/substitution_model.cpp:20-210, src/substitution_model.hpp).
Each model produces an eigendecomposition (U, lambda, U^-1, pi) of the
rate matrix Q, normalized to unit expected substitution rate; transition
matrices are P(t) = U diag(exp(lambda t)) U^-1, computed batched on device.

All functions are pure JAX and differentiable: JC69/HKY use closed-form
eigensystems (reference src/substitution_model.cpp:20-26, 80-120); GTR uses a
pi-symmetrized `eigh` so reverse-mode AD replaces the reference's
finite-difference substitution gradients (src/fat_beagle.cpp:422-508).

Conventions (matching the reference):
  - GTR rates: 6 exchangeabilities in upper-triangle row-major order
    (AC, AG, AT, CG, CT, GT), constrained to sum to 1.
  - HKY rates: a single kappa.
  - frequencies sum to 1; states ordered A, C, G, T.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class EigenDecomp(NamedTuple):
    """Eigendecomposition of Q: Q = U @ diag(values) @ U_inv, plus the
    stationary distribution pi."""

    U: jnp.ndarray        # [4, 4]
    values: jnp.ndarray   # [4]
    U_inv: jnp.ndarray    # [4, 4]
    pi: jnp.ndarray       # [4]


def jc69_eigen(dtype=None) -> EigenDecomp:
    """Analytic JC69 eigensystem (reference src/substitution_model.cpp:20-26)."""
    dtype = dtype or jnp.result_type(float)
    U = jnp.array(
        [
            [1.0, 2.0, 0.0, 0.5],
            [1.0, -2.0, 0.5, 0.0],
            [1.0, 2.0, 0.0, -0.5],
            [1.0, -2.0, -0.5, 0.0],
        ],
        dtype=dtype,
    )
    U_inv = jnp.array(
        [
            [0.25, 0.25, 0.25, 0.25],
            [0.125, -0.125, 0.125, -0.125],
            [0.0, 1.0, 0.0, -1.0],
            [1.0, 0.0, -1.0, 0.0],
        ],
        dtype=dtype,
    )
    values = jnp.array([0.0, -4.0 / 3.0, -4.0 / 3.0, -4.0 / 3.0], dtype=dtype)
    pi = jnp.full((4,), 0.25, dtype=dtype)
    return EigenDecomp(U, values, U_inv, pi)


def build_gtr_q(rates: jnp.ndarray, frequencies: jnp.ndarray) -> jnp.ndarray:
    """Unnormalized-then-normalized GTR rate matrix
    (reference GTRModel/HKYModel::UpdateQMatrix, src/substitution_model.cpp:49-76):
    Q[i,j] = rate[ij] * pi[j] off-diagonal, rows sum to zero, scaled so the
    expected substitution rate  -sum_i pi_i Q_ii  equals 1."""
    r = rates
    pi = frequencies
    iu = jnp.array([0, 0, 0, 1, 1, 2])
    ju = jnp.array([1, 2, 3, 2, 3, 3])
    Q = jnp.zeros((4, 4), dtype=pi.dtype)
    Q = Q.at[iu, ju].set(r * pi[ju])
    Q = Q.at[ju, iu].set(r * pi[iu])
    row_sums = Q.sum(axis=1)
    Q = Q - jnp.diag(row_sums)
    total_rate = jnp.sum(row_sums * pi)
    return Q / total_rate


def gtr_eigen(rates: jnp.ndarray, frequencies: jnp.ndarray) -> EigenDecomp:
    """Differentiable GTR eigendecomposition via pi-symmetrization:
    S = diag(sqrt(pi)) Q diag(1/sqrt(pi)) is symmetric for reversible Q, so a
    (differentiable) `eigh` applies; U = diag(1/sqrt(pi)) V, U^-1 = V^T
    diag(sqrt(pi)).  Replaces the reference's dense Eigen solver
    (src/substitution_model.cpp GTRModel::UpdateEigendecomposition)."""
    pi = frequencies
    Q = build_gtr_q(rates, pi)
    sqrt_pi = jnp.sqrt(pi)
    S = (sqrt_pi[:, None] * Q) / sqrt_pi[None, :]
    S = 0.5 * (S + S.T)  # enforce exact symmetry for eigh
    values, V = jnp.linalg.eigh(S)
    U = V / sqrt_pi[:, None]
    U_inv = V.T * sqrt_pi[None, :]
    return EigenDecomp(U, values, U_inv, pi)


def hky_eigen(kappa: jnp.ndarray, frequencies: jnp.ndarray) -> EigenDecomp:
    """Closed-form HKY85 eigensystem (reference
    src/substitution_model.cpp:80-120; Hasegawa, Kishino & Yano 1985)."""
    pi = frequencies
    dtype = pi.dtype
    kappa = jnp.asarray(kappa, dtype=dtype).reshape(())
    pi_a, pi_c, pi_g, pi_t = pi[0], pi[1], pi[2], pi[3]
    pi_r = pi_a + pi_g
    pi_y = pi_c + pi_t
    beta = -1.0 / (2.0 * (pi_r * pi_y + kappa * (pi_a * pi_g + pi_c * pi_t)))
    values = jnp.stack(
        [
            jnp.zeros((), dtype),
            beta,
            beta * (1.0 + pi_y * (kappa - 1.0)),
            beta * (1.0 + pi_r * (kappa - 1.0)),
        ]
    )
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)
    U_inv = jnp.stack(
        [
            jnp.stack([pi_a, pi_c, pi_g, pi_t]),
            jnp.stack([pi_a * pi_y, -pi_c * pi_r, pi_g * pi_y, -pi_t * pi_r]),
            jnp.stack([zero, one, zero, -one]),
            jnp.stack([one, zero, -one, zero]),
        ]
    )
    U = jnp.stack(
        [
            jnp.stack([one, 1.0 / pi_r, zero, pi_g / pi_r]),
            jnp.stack([one, -1.0 / pi_y, pi_t / pi_y, zero]),
            jnp.stack([one, 1.0 / pi_r, zero, -pi_a / pi_r]),
            jnp.stack([one, -1.0 / pi_y, -pi_c / pi_y, zero]),
        ]
    )
    return EigenDecomp(U, values, U_inv, pi)


def uniformized_stack(Q: jnp.ndarray, K: int = 40):
    """Powers M^k of the uniformized matrix M = I + Q/q (q = max |Q_ii|)
    plus q, for positivity-preserving transition matrices.

    Why: P(t) = U e^{Lambda t} U^-1 reconstructs small entries by signed
    cancellation — in f32 an entry ~1e-10 carries absolute error ~1e-7,
    i.e. it is noise.  A conflicting alignment site's likelihood IS such
    an entry chain: measured on DS1 codon data the f32 eigen route put a
    54x relative error on a per-site likelihood of 1.8e-10 and an 18x
    error on the summed branch gradient (round-5 finding).  The
    uniformization series P(t) = e^{-qt} sum_k (qt)^k/k! M^k has ONLY
    nonnegative terms, so every entry — however small — is computed to
    f32 RELATIVE accuracy.  K=40 covers qt <~ 15 (branch length x rate
    x clock ~ 7 expected substitutions at codon q~2) at <1e-7 relative
    truncation; phylogenetic branch lengths sit far below that.

    Returns (stack [K+1, A, A] with stack[k] = M^k, q scalar)."""
    q = jnp.max(-jnp.diagonal(Q, axis1=-2, axis2=-1), axis=-1)
    A = Q.shape[-1]
    M = jnp.eye(A, dtype=Q.dtype) + Q / jnp.maximum(q, 1e-30)

    def step(carry, _):
        nxt = jnp.matmul(carry, M, precision=jax.lax.Precision.HIGHEST)
        return nxt, carry

    _, stack = jax.lax.scan(step, jnp.eye(A, dtype=Q.dtype), None,
                            length=K + 1)
    return stack, q


def uniformized_transition_matrices(stack: jnp.ndarray, q: jnp.ndarray,
                                    t: jnp.ndarray) -> jnp.ndarray:
    """P(t) = sum_k poisson_k(qt) M^k from a precomputed power stack.

    t: [...] scaled times; returns [..., A, A].  The Poisson weights are
    evaluated in log space (stable for qt in [0, ~80]); qt == 0 reduces
    exactly to the identity via the k == 0 term."""
    K1 = stack.shape[0]
    qt = (q * t)[..., None]                                   # [..., 1]
    k = jnp.arange(K1, dtype=stack.dtype)
    safe = jnp.maximum(qt, 1e-30)
    logc = -qt + k * jnp.log(safe) - jax.lax.lgamma(k + 1.0)
    c = jnp.where(qt > 0, jnp.exp(logc), (k == 0).astype(stack.dtype))
    return jnp.einsum("kab,...k->...ab", stack, c,
                      precision=jax.lax.Precision.HIGHEST)


def transition_matrices(eig: EigenDecomp, t: jnp.ndarray) -> jnp.ndarray:
    """P(t) = U exp(Lambda t) U^-1 for a batch of scaled times.

    t: [...]; returns [..., 4, 4].  This is the JAX equivalent of
    beagleUpdateTransitionMatrices / GPEngine::SetTransitionMatrixToHaveBranchLength
    (reference src/gp_engine.cpp:341-364).

    Evaluated as I + U (exp(Lambda t) - 1) U^-1: on a short branch the
    off-diagonal entries are ~qt, and summing O(1) eigen terms down to
    them cancels away their f32 digits (a 1e-3 relative gradient error at
    t ~ 6e-4); expm1 keeps them to f32 relative accuracy."""
    expvals = jnp.expm1(eig.values * t[..., None])       # [..., 4]
    P = jnp.eye(eig.U.shape[-1], dtype=expvals.dtype) + jnp.einsum(
        "ab,...b,bc->...ac", eig.U, expvals, eig.U_inv,
        precision=jax.lax.Precision.HIGHEST,
    )
    # Transition probabilities are nonnegative by definition; in f32 the
    # eigenreconstruction of large state spaces (codon models, A=64) can
    # round small entries slightly negative, which turns downstream
    # partial products negative and the root log into NaN.  Exact no-op
    # in f64 and for 4-state models, where entries stay strictly
    # positive.
    return jnp.maximum(P, 0.0)


def transition_derivatives(eig: EigenDecomp, t: jnp.ndarray) -> jnp.ndarray:
    """dP/dt = U Lambda exp(Lambda t) U^-1 (reference
    GPEngine::SetTransitionAndDerivativeMatricesToHaveBranchLength)."""
    expvals = jnp.exp(eig.values * t[..., None]) * eig.values
    return jnp.einsum(
        "ab,...b,bc->...ac", eig.U, expvals, eig.U_inv,
        precision=jax.lax.Precision.HIGHEST,
    )


# ---------------------------------------------------------------------------
# Model parameter containers (host-facing facade)
# ---------------------------------------------------------------------------
class SubstitutionModelSpec:
    """Factory matching reference SubstitutionModel::OfSpecification
    (src/substitution_model.cpp:6-18)."""

    def __init__(self, name: str):
        if name not in ("JC69", "HKY", "GTR", "MG94"):
            raise ValueError(f"Substitution model not known: {name}")
        self.name = name

    @property
    def num_states(self) -> int:
        """Per-state dimension A of this model's partials.  MG94 runs on
        the 61 sense codons padded to 64 so every state axis is a power of
        two (models/codon.py padding contract); nucleotide
        models are A=4."""
        return 64 if self.name == "MG94" else 4

    @property
    def param_counts(self):
        """Block sizes matching reference BlockSpecification keys.  MG94
        (net-new vs the reference, which is BEAGLE-4-state-only,
        src/fat_beagle.cpp): rates = [kappa, omega], frequencies = the 4
        nucleotide frequencies feeding F1x4 codon frequencies."""
        if self.name == "JC69":
            return {}
        if self.name == "HKY":
            return {"substitution_model_rates": 1,
                    "substitution_model_frequencies": 4}
        if self.name == "MG94":
            return {"substitution_model_rates": 2,
                    "substitution_model_frequencies": 4}
        return {"substitution_model_rates": 6,
                "substitution_model_frequencies": 4}

    def default_params(self):
        if self.name == "JC69":
            return {}
        if self.name == "HKY":
            return {
                "substitution_model_rates": jnp.array([1.0]),
                "substitution_model_frequencies": jnp.full((4,), 0.25),
            }
        if self.name == "MG94":
            return {
                "substitution_model_rates": jnp.array([2.0, 0.2]),
                "substitution_model_frequencies": jnp.full((4,), 0.25),
            }
        return {
            "substitution_model_rates": jnp.full((6,), 1.0 / 6.0),
            "substitution_model_frequencies": jnp.full((4,), 0.25),
        }

    def eigen(self, params) -> EigenDecomp:
        if self.name == "JC69":
            return jc69_eigen()
        rates = jnp.asarray(params["substitution_model_rates"])
        freqs = jnp.asarray(params["substitution_model_frequencies"])
        if self.name == "HKY":
            return hky_eigen(rates[0], freqs)
        if self.name == "MG94":
            from .codon import mg94_eigen

            return mg94_eigen(rates[0], rates[1], freqs)
        return gtr_eigen(rates, freqs)

    def rate_matrix(self, params):
        """Padded rate matrix Q for models whose f32 transition matrices
        must go through the positivity-preserving uniformization route
        (large state spaces, where eigen reconstruction's signed
        cancellation destroys small entries — see uniformized_stack).
        Returns None for the 4-state models, whose eigen route is exact
        enough and measured faster."""
        if self.name != "MG94":
            return None
        from .codon import mg94_q_padded

        rates = jnp.asarray(params["substitution_model_rates"])
        freqs = jnp.asarray(params["substitution_model_frequencies"])
        return mg94_q_padded(rates[0], rates[1], freqs)
