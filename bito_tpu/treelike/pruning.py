"""Batched Felsenstein pruning and linear-time branch gradients (JAX).

The JAX replacement of the reference Engine/FatBeagle/BEAGLE stack
(reference: src/engine.cpp:27-119, src/fat_beagle.cpp:49-169).  One jitted
XLA program computes likelihoods (and gradients) for a whole batch of trees:
the batch dimension replaces the reference's TaskProcessor thread pool
(src/fat_beagle.hpp:151-184), and the site-pattern dimension is the
contiguous axis (padded to a multiple of 128) and the cross-device sharding
axis.

Data layout (S last, so per-pattern work is contiguous and shardable):
  partials  [B, N+1, C, A, S]
  logscale  [B, N+1, S]        per-node accumulated log rescaling factors
  P         [B, N+1, C, A, A]  transition matrices (+ identity at index N)

Rescaling is always-on per postorder op (max over states/categories per
pattern), replacing the reference's threshold-triggered scaler machinery
(src/gp_engine.cpp:564-601) with a branch-free variant.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..models.substitution import (
    EigenDecomp,
    transition_derivatives,
    transition_matrices,
)

# Every dot states its precision: on a GPU an f32 dot at DEFAULT or HIGH
# may run as TF32, which on the H100 put the A=64 codon gradients 1e-4 off
# f64 where HIGHEST keeps them within 2e-7.
Precision = jax.lax.Precision.HIGHEST


def _evolve(P_row, p_row):
    """[C,A,A] @ [C,A,S] -> [C,A,S]."""
    return jnp.einsum("cab,cbs->cas", P_row, p_row, precision=Precision)


def _evolve_t(P_row, o_row):
    """transpose evolve: [C,A,A]^T @ [C,A,S] -> [C,A,S]."""
    return jnp.einsum("cab,cas->cbs", P_row, o_row, precision=Precision)


def transition_matrices_ext(
    eig: EigenDecomp, branch_lengths: jnp.ndarray, category_rates: jnp.ndarray,
    clock_rate: jnp.ndarray, derivative: bool = False, Q=None,
) -> jnp.ndarray:
    """[B, N] branch lengths -> [B, N+1, C, A, A] transition matrices with an
    identity (or zero, for derivatives) appended at index N.

    All model ingredients are per-tree batched (the analog of the reference's
    per-tree phylo_model_params_ rows, src/fat_beagle.hpp:151-184):
    eig fields lead with B, category_rates is [B, C], clock_rate is [B].

    Q (optional, [A, A], shared across the batch): switch to the
    positivity-preserving uniformization route — required for f32 codon
    models, whose eigen-reconstructed P(t) small entries are cancellation
    noise (measured 18x gradient error on DS1 codon data; see
    models/substitution.py uniformized_stack).  Derivatives then come
    from the exact identity dP/dbl = rate*clock * Q @ P(t)."""
    if Q is not None:
        from ..models.substitution import (
            uniformized_stack,
            uniformized_transition_matrices,
        )

        stack, qmax = uniformized_stack(Q.astype(branch_lengths.dtype))

        def one_u(bl_b, rates_b, clock_b):
            t = bl_b[:, None] * rates_b * clock_b  # [N, C]
            return uniformized_transition_matrices(stack, qmax, t)

        P = jax.vmap(one_u)(branch_lengths, category_rates, clock_rate)
        if derivative:
            P = jnp.einsum(
                "ab,nmcbs->nmcas", Q.astype(P.dtype), P,
                precision=Precision,
            ) * (category_rates[:, None, :, None, None]
                 * clock_rate[:, None, None, None, None])
        B, _, C, A, _ = P.shape
        pad = jnp.zeros((B, 1, C, A, A), P.dtype)
        if not derivative:
            pad = pad + jnp.eye(A, dtype=P.dtype)
        return jnp.concatenate([P, pad], axis=1)

    def one(eig_b, bl_b, rates_b, clock_b):
        t = bl_b[:, None] * rates_b * clock_b  # [N, C]
        fn = transition_derivatives if derivative else transition_matrices
        P = fn(eig_b, t)  # [N, C, A, A]
        if derivative:
            # Chain rule: transition_derivatives gives dP/d(tau) with
            # tau = bl*rate_c*clock; fold in d(tau)/d(bl).
            P = P * (rates_b * clock_b)[None, :, None, None]
        return P

    P = jax.vmap(one)(eig, branch_lengths, category_rates, clock_rate)
    B, _, C, A, _ = P.shape
    pad = jnp.zeros((B, 1, C, A, A), P.dtype)
    if not derivative:
        pad = pad + jnp.eye(A, dtype=P.dtype)
    return jnp.concatenate([P, pad], axis=1)


def init_partials(
    tip_partials: jnp.ndarray, batch_size: int, num_slots: int,
    category_count: int, pattern_pad: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Build the initial [B, N+1, C, A, S] buffer: tip rows one-hot (gaps all
    ones), internal and dummy rows ones; padded patterns are ones (weight 0).

    tip_partials: [T, S0, A] host layout from SitePattern.tip_partials."""
    T, S0, A = tip_partials.shape
    S = pattern_pad
    tips = jnp.ones((T, A, S), dtype=tip_partials.dtype)
    tips = tips.at[:, :, :S0].set(jnp.swapaxes(tip_partials, 1, 2))
    tips = jnp.broadcast_to(tips[:, None], (T, category_count, A, S))
    buf = jnp.ones(
        (batch_size, num_slots + 1, category_count, A, S), dtype=tip_partials.dtype
    )
    buf = buf.at[:, :T].set(tips[None])
    logscale = jnp.zeros((batch_size, num_slots + 1, S), dtype=tip_partials.dtype)
    return buf, logscale


def postorder_pass(
    post_ops: jnp.ndarray,  # [B, M, 5] int32
    P: jnp.ndarray,         # [B, N+1, C, A, A]
    partials: jnp.ndarray,  # [B, N+1, C, A, S]
    logscale: jnp.ndarray,  # [B, N+1, S]
    rescale: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run the postorder tape: the batched equivalent of beagleUpdatePartials
    over the whole tree batch (reference src/fat_beagle.cpp:49-69)."""

    def step(carry, ops):
        buf, logs = carry  # [B,N+1,C,A,S], [B,N+1,S]

        def one(buf_b, logs_b, P_b, op):
            dest, s1, e1, s2, e2 = op[0], op[1], op[2], op[3], op[4]
            ev1 = _evolve(P_b[e1], buf_b[s1])
            ev2 = _evolve(P_b[e2], buf_b[s2])
            prod = ev1 * ev2  # [C,A,S]
            ls = logs_b[s1] + logs_b[s2]
            if rescale:
                mx = jnp.max(prod, axis=(0, 1))  # [S]
                mx = jnp.where(mx > 0, mx, 1.0)
                prod = prod / mx
                ls = ls + jnp.log(mx)
            return buf_b.at[dest].set(prod), logs_b.at[dest].set(ls)

        buf, logs = jax.vmap(one)(buf, logs, P, ops)
        return (buf, logs), None

    (partials, logscale), _ = jax.lax.scan(
        step, (partials, logscale), jnp.moveaxis(post_ops, 1, 0)
    )
    return partials, logscale


def root_log_likelihood(
    partials: jnp.ndarray, logscale: jnp.ndarray, root: jnp.ndarray,
    pi: jnp.ndarray, category_proportions: jnp.ndarray,
) -> jnp.ndarray:
    """Per-(tree, pattern) log likelihood at the root (the batched
    beagleCalculateRootLogLikelihoods, reference src/fat_beagle.cpp:60-69).
    pi: [B, A]; category_proportions: [B, C]."""

    def one(buf_b, logs_b, root_b, pi_b, props_b):
        pr = buf_b[root_b]            # [C, A, S]
        site = jnp.einsum(
            "c,a,cas->s", props_b, pi_b, pr, precision=Precision
        )
        return jnp.log(site) + logs_b[root_b]

    return jax.vmap(one)(partials, logscale, root, pi, category_proportions)


def preorder_pass(
    pre_ops: jnp.ndarray,   # [B, Mp, 6]
    P: jnp.ndarray,         # [B, N+1, C, A, A]
    partials: jnp.ndarray,  # [B, N+1, C, A, S] (postorder results)
    root: jnp.ndarray,      # [B]
    pi: jnp.ndarray,
    rescale: bool = True,
) -> jnp.ndarray:
    """Compute per-node outside vectors o_u (reference
    beagleUpdatePrePartials, src/fat_beagle.cpp:113-169).

    Returns outside [B, N+1, C, A, S] such that for every edge (above node) u:
        site_lik ∝ sum_c prop_c * (o_u^c . (P_c(t_u) @ p_u^c))
    with the same per-site scale factor for every u, so derivative ratios are
    scale-free."""
    B, N1, C, A, S = partials.shape
    outside = jnp.zeros_like(partials)
    upper = jnp.zeros_like(partials)

    def seed(up_b, root_b, pi_b):
        pi_block = jnp.broadcast_to(
            pi_b[None, :, None], (C, A, S)
        ).astype(up_b.dtype)
        return up_b.at[root_b].set(pi_block)

    upper = jax.vmap(seed)(upper, root, pi)

    def step(carry, ops):
        out, up = carry

        def one(out_b, up_b, buf_b, P_b, op):
            dest, parent, s1, e1, s2, e2 = (
                op[0], op[1], op[2], op[3], op[4], op[5],
            )
            o = up_b[parent] * _evolve(P_b[e1], buf_b[s1]) * _evolve(
                P_b[e2], buf_b[s2]
            )
            if rescale:
                mx = jnp.max(o, axis=(0, 1))
                mx = jnp.where(mx > 0, mx, 1.0)
                o = o / mx
            q = _evolve_t(P_b[dest], o)
            return out_b.at[dest].set(o), up_b.at[dest].set(q)

        out, up = jax.vmap(one)(out, up, partials, P, ops)
        return (out, up), None

    (outside, upper), _ = jax.lax.scan(
        step, (outside, upper), jnp.moveaxis(pre_ops, 1, 0)
    )
    return outside


def preorder_gradients_fused(
    pre_ops: jnp.ndarray,   # [B, Mp, 6]
    P: jnp.ndarray,         # [B, N+1, C, A, A]
    dP: jnp.ndarray,        # [B, N+1, C, A, A]
    partials: jnp.ndarray,  # [B, N+1, C, A, S] (postorder results)
    root: jnp.ndarray,      # [B]
    pi: jnp.ndarray,
    category_proportions: jnp.ndarray,  # [B, C]
    weights: jnp.ndarray,               # [S]
    rescale: bool = True,
) -> jnp.ndarray:
    """Preorder pass with the per-edge gradient reduction FUSED into each
    step: the [B, N+1, C, A, S] outside buffer is never written to device
    memory and the evolved/devolved [B, N, C, A, S] intermediates of
    branch_length_gradients are never materialized — each op reduces its
    own num/den to [B, S] on the spot, which removes about a third of the
    bytes the unfused path moves.  Returns grads [B, N+1] (caller masks
    and trims)."""

    B, N1, C, A, S = partials.shape
    upper = jnp.zeros_like(partials)
    upper = jax.vmap(
        lambda up_b, root_b, pi_b: up_b.at[root_b].set(
            jnp.broadcast_to(pi_b[None, :, None],
                             (C, A, S)).astype(up_b.dtype))
    )(upper, root, pi)
    grads = jnp.zeros((B, N1), partials.dtype)

    def step(carry, ops):
        up, g = carry

        def one(up_b, g_b, buf_b, P_b, dP_b, props_b, op):
            dest, parent, s1, e1, s2, e2 = (
                op[0], op[1], op[2], op[3], op[4], op[5],
            )
            o = up_b[parent] * _evolve(P_b[e1], buf_b[s1]) * _evolve(
                P_b[e2], buf_b[s2]
            )
            if rescale:
                mx = jnp.max(o, axis=(0, 1))
                mx = jnp.where(mx > 0, mx, 1.0)
                o = o / mx
            p_dest = buf_b[dest]
            den = jnp.einsum("c,cas->s", props_b,
                             o * _evolve(P_b[dest], p_dest),
                             precision=Precision)
            num = jnp.einsum("c,cas->s", props_b,
                             o * _evolve(dP_b[dest], p_dest),
                             precision=Precision)
            ratio = num / jnp.where(den > 0, den, 1.0)
            gval = jnp.dot(weights, ratio, precision=Precision)
            q = _evolve_t(P_b[dest], o)
            return up_b.at[dest].set(q), g_b.at[dest].set(gval)

        up, g = jax.vmap(one)(up, g, partials, P, dP,
                              category_proportions, ops)
        return (up, g), None

    (_, grads), _ = jax.lax.scan(
        step, (upper, grads), jnp.moveaxis(pre_ops, 1, 0)
    )
    return grads


def branch_length_gradients(
    outside: jnp.ndarray,      # [B, N+1, C, A, S]
    partials: jnp.ndarray,     # [B, N+1, C, A, S]
    P: jnp.ndarray,            # [B, N+1, C, A, A]
    dP: jnp.ndarray,           # [B, N+1, C, A, A]
    category_proportions: jnp.ndarray,
    weights: jnp.ndarray,      # [S] pattern weights (0 on padding)
    edge_mask: jnp.ndarray,    # [B, N]
) -> jnp.ndarray:
    """d log L / d branch_length per (tree, node): the batched equivalent of
    beagleCalculateEdgeDerivatives (reference src/fat_beagle.cpp:141-169).

    Computed for all edges at once:  num/den where
      num[b,u,s] = sum_c prop_c o[b,u,c,:,s] . (dP[b,u,c] @ p[b,u,c,:,s])
      den[b,u,s] = same with P  ( = site likelihood up to the shared scale).
    """
    N = edge_mask.shape[1]
    o = outside[:, :N]
    p = partials[:, :N]
    evolved = jnp.einsum("tncab,tncbs->tncas", P[:, :N], p, precision=Precision)
    devolved = jnp.einsum("tncab,tncbs->tncas", dP[:, :N], p, precision=Precision)
    den = jnp.einsum("tc,tncas->tns", category_proportions, o * evolved,
                     precision=Precision)
    num = jnp.einsum("tc,tncas->tns", category_proportions, o * devolved,
                     precision=Precision)
    ratio = num / jnp.where(den > 0, den, 1.0)
    grad = jnp.einsum("s,tns->tn", weights, ratio, precision=Precision)
    return grad * edge_mask


class PruningContext(NamedTuple):
    """Device-resident static data for a tree batch."""

    post_ops: jnp.ndarray
    pre_ops: jnp.ndarray
    root: jnp.ndarray
    edge_mask: jnp.ndarray
    tip_partials: jnp.ndarray   # [T, S0, A]
    weights: jnp.ndarray        # [S] padded
    num_slots: int
    pattern_pad: int


def pad_patterns(n: int, multiple: int = 128) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@functools.partial(jax.jit, static_argnames=("num_slots", "pattern_pad",
                                             "category_count", "rescale"))
def log_likelihoods_impl(
    post_ops, root, tip_partials, weights, branch_lengths,
    eig: EigenDecomp, category_rates, category_proportions, clock_rate,
    Q=None,
    *, num_slots: int, pattern_pad: int, category_count: int, rescale: bool = True,
):
    """Per-tree log likelihoods for a batch.  Returns [B]."""
    B = branch_lengths.shape[0]
    P = transition_matrices_ext(eig, branch_lengths, category_rates,
                                clock_rate, Q=Q)
    buf, logs = init_partials(tip_partials, B, num_slots, category_count,
                              pattern_pad)
    buf, logs = postorder_pass(post_ops, P, buf, logs, rescale=rescale)
    per_pattern = root_log_likelihood(buf, logs, root, eig.pi,
                                      category_proportions)
    return jnp.dot(per_pattern, weights, precision=Precision)


@functools.partial(jax.jit, static_argnames=("num_slots", "pattern_pad",
                                             "category_count", "rescale",
                                             "fused"))
def ll_and_branch_gradients_impl(
    post_ops, pre_ops, root, edge_mask, tip_partials, weights, branch_lengths,
    eig: EigenDecomp, category_rates, category_proportions, clock_rate,
    Q=None,
    *, num_slots: int, pattern_pad: int, category_count: int,
    rescale: bool = True, fused: bool = True,
):
    """Log likelihood + d logL / d branch lengths.  Returns ([B], [B, N]).

    fused=True (default) computes the per-edge gradient reductions inside
    the preorder scan (preorder_gradients_fused) — mathematically
    identical to the materialized outside-buffer path, with about a third
    fewer bytes moved."""
    B = branch_lengths.shape[0]
    P = transition_matrices_ext(eig, branch_lengths, category_rates,
                                clock_rate, Q=Q)
    dP = transition_matrices_ext(eig, branch_lengths, category_rates,
                                 clock_rate, derivative=True, Q=Q)
    buf, logs = init_partials(tip_partials, B, num_slots, category_count,
                              pattern_pad)
    buf, logs = postorder_pass(post_ops, P, buf, logs, rescale=rescale)
    per_pattern = root_log_likelihood(buf, logs, root, eig.pi,
                                      category_proportions)
    ll = jnp.dot(per_pattern, weights, precision=Precision)
    if fused:
        gfull = preorder_gradients_fused(
            pre_ops, P, dP, buf, root, eig.pi, category_proportions,
            weights, rescale=rescale)
        N = edge_mask.shape[1]
        return ll, gfull[:, :N] * edge_mask
    outside = preorder_pass(pre_ops, P, buf, root, eig.pi, rescale=rescale)
    grads = branch_length_gradients(
        outside, buf, P, dP, category_proportions, weights, edge_mask,
    )
    return ll, grads


MIN_LOG_BL = -13.9   # reference src/dag_branch_handler.hpp:272
MAX_LOG_BL = 1.1     # reference src/dag_branch_handler.hpp:275


@functools.partial(jax.jit, static_argnames=("num_slots", "pattern_pad",
                                             "category_count", "iterations"))
def optimize_selected_branches_impl(
    post_ops, pre_ops, root, tip_partials, weights, branch_lengths,
    eig: EigenDecomp, category_rates, category_proportions, clock_rate,
    sel_nodes,     # [B, K] int32 node ids to optimize (pad with num_slots)
    sel_mask,      # [B, K] bool
    *, num_slots: int, pattern_pad: int, category_count: int,
    iterations: int = 2,
):
    """Batched exact conditional branch-length optimization of selected
    edges (the classical-engine counterpart of the reference's
    proposed-NNI new-edge optimization: TPEngine with optimize_new_edges,
    src/tp_engine.cpp:1423-1427 + Optimization::BrentMinimize).

    Given fixed other branches, LL as a function of one edge's length t
    factorizes through that node's outside vector o and partial p:
        LL(t) = sum_s w_s log( sum_c prop_c  o . (P_c(t) @ p) ) + const,
    so a vectorized Brent per (tree, selected node) lane is exact.  The
    selected edges update Jacobi-style; `iterations` rounds of
    (postorder+preorder, joint Brent) form the coordinate ascent."""
    from ..gp import optimize as gp_optimize

    B, K = sel_nodes.shape
    bl = branch_lengths

    for _ in range(iterations):
        P = transition_matrices_ext(eig, bl, category_rates, clock_rate)
        buf, _logs = init_partials(tip_partials, B, num_slots,
                                   category_count, pattern_pad)
        buf, _logs = postorder_pass(post_ops, P, buf, _logs)
        outside = preorder_pass(pre_ops, P, buf, root, eig.pi)
        take = jax.vmap(lambda x, idx: x[idx])
        o = take(outside, sel_nodes)          # [B, K, C, A, S]
        p = take(buf, sel_nodes)

        def neg_ll(y):                        # y: [B, K] log branch length
            t = jnp.exp(y)
            tau = (t * clock_rate[:, None])[:, :, None] \
                * category_rates[:, None, :]              # [B, K, C]
            e = jnp.exp(eig.values[:, None, None, :]
                        * tau[..., None])                 # [B, K, C, A]
            Pk = jnp.einsum("bia,bkca,baj->bkcij", eig.U, e, eig.U_inv,
                            precision=Precision)
            ev = jnp.einsum("bkcij,bkcjs->bkcis", Pk, p,
                            precision=Precision)
            val = jnp.einsum("bc,bkcas->bks", category_proportions,
                             o * ev, precision=Precision)
            return -(jnp.log(jnp.where(val > 0, val, 1e-300)) @ weights)

        lo = jnp.full((B, K), MIN_LOG_BL, bl.dtype)
        hi = jnp.full((B, K), MAX_LOG_BL, bl.dtype)
        # Clamp: padding lanes may carry bl 0 (log -> -inf) and are masked
        # out of the result anyway.
        guess = jnp.clip(jnp.log(jnp.maximum(take(bl, sel_nodes), 1e-300)),
                         MIN_LOG_BL, MAX_LOG_BL)
        y_opt = gp_optimize.brent_minimize_batched(neg_ll, guess, lo, hi)
        # Reset-if-worse guard (reference dag_branch_handler.cpp:143-150).
        y_opt = jnp.where(neg_ll(y_opt) > neg_ll(guess), guess, y_opt)
        new_t = jnp.where(sel_mask, jnp.exp(y_opt), take(bl, sel_nodes))
        bl = jax.vmap(lambda b, idx, v: b.at[idx].set(v))(
            bl, sel_nodes, new_t
        )
    return bl


# ---------------------------------------------------------------------------
# Levelized wavefront variants: ~tree-depth wide steps instead of
# ~node-count narrow ones.  Same math as the scan tapes above; the step
# count (and with it the buffer-update traffic) drops by the mean level
# width, which measures ~2-4x end-to-end on DS1-shaped batches.
# ---------------------------------------------------------------------------
def postorder_pass_leveled(post_levels, P, partials, logscale,
                           rescale: bool = True):
    """post_levels: [L, B, W, 5] int32."""
    L = post_levels.shape[0]

    def level(buf, logs, ops):
        def one(buf_b, logs_b, P_b, ops_b):
            dest, s1, e1 = ops_b[:, 0], ops_b[:, 1], ops_b[:, 2]
            s2, e2 = ops_b[:, 3], ops_b[:, 4]
            ev1 = jnp.einsum("wcab,wcbs->wcas", P_b[e1], buf_b[s1],
                             precision=Precision)
            ev2 = jnp.einsum("wcab,wcbs->wcas", P_b[e2], buf_b[s2],
                             precision=Precision)
            prod = ev1 * ev2                      # [W, C, A, S]
            ls = logs_b[s1] + logs_b[s2]          # [W, S]
            if rescale:
                mx = prod.max(axis=(1, 2))
                mx = jnp.where(mx > 0, mx, 1.0)
                prod = prod / mx[:, None, None, :]
                ls = ls + jnp.log(mx)
            return buf_b.at[dest].set(prod), logs_b.at[dest].set(ls)

        return jax.vmap(one)(buf, logs, P, ops)

    for l in range(L):
        partials, logscale = level(partials, logscale, post_levels[l])
    return partials, logscale


def preorder_pass_leveled(pre_levels, P, partials, root, pi,
                          rescale: bool = True):
    """pre_levels: [Lp, B, Wp, 6]; returns outside [B, N+1, C, A, S]."""
    B, N1, C, A, S = partials.shape
    outside = jnp.zeros_like(partials)
    upper = jnp.zeros_like(partials)

    def seed(up_b, root_b, pi_b):
        block = jnp.broadcast_to(pi_b[None, :, None], (C, A, S)).astype(
            up_b.dtype
        )
        return up_b.at[root_b].set(block)

    upper = jax.vmap(seed)(upper, root, pi)
    Lp = pre_levels.shape[0]

    def level(out, up, ops):
        def one(out_b, up_b, buf_b, P_b, ops_b):
            dest, parent = ops_b[:, 0], ops_b[:, 1]
            s1, e1, s2, e2 = (ops_b[:, 2], ops_b[:, 3], ops_b[:, 4],
                              ops_b[:, 5])
            o = (up_b[parent]
                 * jnp.einsum("wcab,wcbs->wcas", P_b[e1], buf_b[s1],
                              precision=Precision)
                 * jnp.einsum("wcab,wcbs->wcas", P_b[e2], buf_b[s2],
                              precision=Precision))
            if rescale:
                mx = o.max(axis=(1, 2))
                mx = jnp.where(mx > 0, mx, 1.0)
                o = o / mx[:, None, None, :]
            q = jnp.einsum("wcab,wcas->wcbs", P_b[dest], o,
                           precision=Precision)
            return out_b.at[dest].set(o), up_b.at[dest].set(q)

        return jax.vmap(one)(out, up, partials, P, ops)

    for l in range(Lp):
        outside, upper = level(outside, upper, pre_levels[l])
    return outside


@functools.partial(jax.jit, static_argnames=("num_slots", "pattern_pad",
                                             "category_count", "rescale"))
def log_likelihoods_leveled_impl(
    post_levels, root, tip_partials, weights, branch_lengths,
    eig: EigenDecomp, category_rates, category_proportions, clock_rate,
    *, num_slots: int, pattern_pad: int, category_count: int,
    rescale: bool = True,
):
    B = branch_lengths.shape[0]
    P = transition_matrices_ext(eig, branch_lengths, category_rates, clock_rate)
    buf, logs = init_partials(tip_partials, B, num_slots, category_count,
                              pattern_pad)
    buf, logs = postorder_pass_leveled(post_levels, P, buf, logs,
                                       rescale=rescale)
    per_pattern = root_log_likelihood(buf, logs, root, eig.pi,
                                      category_proportions)
    return jnp.dot(per_pattern, weights, precision=Precision)


@functools.partial(jax.jit, static_argnames=("num_slots", "pattern_pad",
                                             "category_count", "rescale"))
def ll_and_branch_gradients_leveled_impl(
    post_levels, pre_levels, root, edge_mask, tip_partials, weights,
    branch_lengths, eig: EigenDecomp, category_rates, category_proportions,
    clock_rate, *, num_slots: int, pattern_pad: int, category_count: int,
    rescale: bool = True,
):
    B = branch_lengths.shape[0]
    P = transition_matrices_ext(eig, branch_lengths, category_rates, clock_rate)
    dP = transition_matrices_ext(eig, branch_lengths, category_rates,
                                 clock_rate, derivative=True)
    buf, logs = init_partials(tip_partials, B, num_slots, category_count,
                              pattern_pad)
    buf, logs = postorder_pass_leveled(post_levels, P, buf, logs,
                                       rescale=rescale)
    per_pattern = root_log_likelihood(buf, logs, root, eig.pi,
                                      category_proportions)
    ll = jnp.dot(per_pattern, weights, precision=Precision)
    outside = preorder_pass_leveled(pre_levels, P, buf, root, eig.pi,
                                    rescale=rescale)
    grads = branch_length_gradients(
        outside, buf, P, dP, category_proportions, weights, edge_mask,
    )
    return ll, grads
