"""Sankoff (weighted) parsimony, batched over trees and site patterns.

JAX rebuild of the reference SankoffHandler / SankoffMatrix
(reference: src/sankoff_handler.hpp:25-130, src/sankoff_matrix.hpp:4-6).
The per-node P-left/P-right/Q partial vectors become one min-plus DP over
the same padded op tape used for likelihood pruning (treelike/encode.py), so
a whole batch of topologies is scored in one XLA program:

    q_u[s] = min_s'(C[s,s'] + q_c1[s']) + min_s'(C[s,s'] + q_c2[s'])

with the identity (zero-cost diagonal) min-plus for accumulator ops.
Default cost matrix: unit off-diagonal (reference SankoffMatrix default).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..core.site_pattern import SitePattern
from ..core.tree import Tree
from ..treelike.encode import TreeBatchEncoding, encode_trees

BIG = float(2 ** 31 - 1)  # reference big_double_ == INT_MAX


def default_cost_matrix() -> np.ndarray:
    c = np.ones((4, 4))
    np.fill_diagonal(c, 0.0)
    return c


def leaf_partials(site_pattern: SitePattern, dtype=np.float64) -> np.ndarray:
    """[T, 4, S]: 0 for observed state(s), BIG otherwise; gaps all-zero
    (reference GenerateLeafPartials)."""
    states = site_pattern.tip_states()  # [T, S]
    T, S = states.shape
    out = np.full((T, 4, S), BIG, dtype=dtype)
    for a in range(4):
        out[:, a, :] = np.where(states == a, 0.0, out[:, a, :])
    out = np.where((states == 4)[:, None, :], 0.0, out)
    return out


def _minplus(C: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """min-plus 'matvec': out[s, ...] = min_t (C[s,t] + q[t, ...])."""
    return jnp.min(C[:, :, None] + q[None, :, :], axis=1)


@functools.partial(jax.jit, static_argnames=("num_slots",))
def sankoff_scores_impl(post_ops, root, tips, weights, cost, *,
                        num_slots: int):
    """Per-tree parsimony scores [B] plus per-(tree, pattern) scores."""
    B = post_ops.shape[0]
    T, A, S = tips.shape
    buf = jnp.zeros((B, num_slots + 1, A, S), tips.dtype)
    buf = buf.at[:, :T].set(tips[None])
    identity = jnp.full((A, A), BIG, dtype=tips.dtype)
    identity = identity.at[jnp.arange(A), jnp.arange(A)].set(0.0)

    def step(buf, ops):
        def one(buf_b, op):
            dest, s1, e1, s2, e2 = op[0], op[1], op[2], op[3], op[4]
            c1 = jnp.where(e1 == num_slots, identity, cost)
            c2 = jnp.where(e2 == num_slots, identity, cost)
            val = _minplus(c1, buf_b[s1]) + _minplus(c2, buf_b[s2])
            # Clamp so BIG doesn't overflow into inf-like territory.
            val = jnp.minimum(val, BIG)
            return buf_b.at[dest].set(val)

        return jax.vmap(one)(buf, ops), None

    buf, _ = jax.lax.scan(step, buf, jnp.moveaxis(post_ops, 1, 0))

    def score(buf_b, root_b):
        return jnp.min(buf_b[root_b], axis=0)  # [S]

    per_pattern = jax.vmap(score)(buf, root)  # [B, S]
    return per_pattern @ weights, per_pattern


class SankoffHandler:
    """Facade mirroring the reference SankoffHandler API."""

    def __init__(self, site_pattern: SitePattern,
                 cost_matrix: Optional[np.ndarray] = None):
        self.site_pattern = site_pattern
        self.cost = jnp.asarray(
            cost_matrix if cost_matrix is not None else default_cost_matrix(),
            dtype=jnp.zeros(0).dtype,
        )
        self.tips = jnp.asarray(leaf_partials(site_pattern),
                                dtype=self.cost.dtype)
        self.weights = jnp.asarray(site_pattern.weights, dtype=self.cost.dtype)
        self._per_pattern = None

    def run_sankoff(self, trees: Sequence[Tree]) -> np.ndarray:
        """Scores for a batch of trees; returns total weighted scores [B]."""
        enc = encode_trees([t.topology for t in trees])
        totals, per_pattern = sankoff_scores_impl(
            jnp.asarray(enc.post_ops), jnp.asarray(enc.root), self.tips,
            self.weights, self.cost, num_slots=enc.num_slots,
        )
        self._per_pattern = np.asarray(per_pattern)
        return np.asarray(totals)

    def parsimony_score(self, pattern_idx: Optional[int] = None):
        """Per-pattern score of the last run's first tree (reference
        ParsimonyScore(site)) or the full per-pattern matrix."""
        assert self._per_pattern is not None, "Call run_sankoff first"
        if pattern_idx is None:
            return self._per_pattern
        return float(self._per_pattern[0, pattern_idx])
