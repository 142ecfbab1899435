"""GP engine: generalized pruning on the subsplit DAG as levelized XLA
wavefront programs.

JAX rebuild of the reference GPEngine
(reference: src/gp_engine.cpp:213-816, src/gp_engine.hpp:287-377).  The
mmapped per-node PLV store becomes one device-resident tensor
  plv[6, N, 4, S]   (P, PHatRight, PHatLeft, RHat, RRight, RLeft)
with per-(PLV, site) log rescaling offsets
  ls[6, N, S]
replacing the reference's threshold-triggered per-PLV scaler counts
(src/gp_engine.cpp:564-601) with exact per-site scale bookkeeping.

The serial GPOperation tape (src/gp_dag.cpp:260-304) becomes one batched
gather -> q-weighted 4x4 matvec -> scatter-add per DAG level; branch-length
optimization runs whole levels of independent Brent line searches at once
(replacing the per-edge serial Brent of src/gp_engine.cpp:603-654).

Like the reference engine, the substitution model is JC69 with four states
(src/gp_engine.hpp:362-377).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.site_pattern import SitePattern
from ..dag.schedule import (
    GPSchedule,
    LevelEntries,
    P,
    PHAT_RIGHT,
    PHAT_LEFT,
    RHAT,
    RRIGHT,
    RLEFT,
    build_schedule,
)
from ..dag.subsplit_dag import LEFT, RIGHT, SubsplitDAG
from . import optimize

Precision = jax.lax.Precision.HIGHEST

MIN_LOG_BL = -13.9       # reference src/dag_branch_handler.hpp:272
MAX_LOG_BL = 1.1         # reference src/dag_branch_handler.hpp:275
DEFAULT_BL = 0.1         # reference src/dag_branch_handler.hpp:266


def jc69_transition(t: jnp.ndarray) -> jnp.ndarray:
    """JC69 P(t): 0.25(1-e) off-diagonal + e on the diagonal with
    e = exp(-4t/3) (reference src/gp_engine.cpp:341-350 via eigendecomp).
    Symmetric, so it serves both rootward and leafward evolution."""
    e = jnp.exp(-4.0 * t / 3.0)
    eye = jnp.eye(4, dtype=t.dtype)
    return 0.25 * (1.0 - e)[..., None, None] + e[..., None, None] * eye


def jc69_transition_derivative(t: jnp.ndarray) -> jnp.ndarray:
    e = jnp.exp(-4.0 * t / 3.0) * (-4.0 / 3.0)
    eye = jnp.eye(4, dtype=t.dtype)
    return -0.25 * e[..., None, None] + e[..., None, None] * eye


def _pad_stack(arrays: List[np.ndarray], pad_value: int,
               dtype=np.int32, width: int | None = None,
               rows: int | None = None) -> np.ndarray:
    """Stack variable-length 1-D index arrays into [L, W] with padding.

    Padding rows index dummy slots (node cap / edge cap) so a single traced
    scan body serves every level — the XLA program size becomes independent
    of the DAG's level count.  `width`/`rows` allow padding to capacity
    buckets so program shapes stay stable across DAG growth."""
    W = width if width is not None else max([len(a) for a in arrays] + [1])
    L = rows if rows is not None else len(arrays)
    out = np.full((L, W), pad_value, dtype=dtype)
    for i, a in enumerate(arrays):
        out[i, : len(a)] = a
    return out


def _rup(x: int, m: int) -> int:
    return -(-max(x, 1) // m) * m


# ---------------------------------------------------------------------------
# Wavefront programs (module-level, shared jit cache across engine
# instances: every index tensor rides as a traced argument, so rebuilding
# an engine — or growing its DAG — inside the same capacity bucket reuses
# the compiled programs instead of recompiling per DAG epoch).
# ---------------------------------------------------------------------------

def _accumulate(plv, ls, edge, dest, src, src_plv, trans_all, q_ext,
                dest_plv):
    """Scatter-accumulate q-weighted evolved PLVs into fresh dest slots,
    aligning per-site scales to the per-dest max.  Padding entries carry
    q_ext[ecap] == 0 and dest == ncap, so they contribute zero and land in
    the dummy slot."""
    np1 = plv.shape[1]
    S = plv.shape[-1]
    dtype = plv.dtype
    NEG = jnp.asarray(-jnp.inf, dtype)
    src_vals = plv[src_plv, src]          # [K, 4, S]
    src_ls = ls[src_plv, src]             # [K, S]
    key = dest_plv * np1 + dest           # [K] flat (plv_type, node)
    ls_max = jnp.full((6 * np1, S), NEG).at[key].max(src_ls)
    factor = jnp.exp(src_ls - ls_max[key])
    contrib = (
        q_ext[edge][:, None, None]
        * jnp.einsum("kab,kbs->kas", trans_all[edge], src_vals,
                     precision=Precision)
        * factor[:, None, :]
    )
    acc = jnp.zeros((6 * np1, 4, S), dtype).at[key].add(contrib)
    return acc.reshape(6, np1, 4, S), jnp.where(
        jnp.isfinite(ls_max), ls_max, 0.0
    ).reshape(6, np1, S)


def _write_levels(plv, ls, acc, acc_ls, plv_types, nodes):
    for ptype in plv_types:
        plv = plv.at[ptype, nodes].set(acc[ptype, nodes])
        ls = ls.at[ptype, nodes].set(acc_ls[ptype, nodes])
    return plv, ls


def _multiply_rescale(plv, ls, dest, src1, src2, nodes):
    prod = plv[src1, nodes] * plv[src2, nodes]
    lsn = ls[src1, nodes] + ls[src2, nodes]
    m = prod.max(axis=1)                  # [M, S]
    m_safe = jnp.where(m > 0, m, 1.0)
    plv = plv.at[dest, nodes].set(prod / m_safe[:, None, :])
    ls = ls.at[dest, nodes].set(lsn + jnp.log(m_safe))
    return plv, ls


def _ext(blc, qc):
    bl_ext = jnp.concatenate([blc, jnp.full((1,), DEFAULT_BL, blc.dtype)])
    q_ext = jnp.concatenate([qc, jnp.zeros((1,), qc.dtype)])
    return bl_ext, q_ext


def _seed_rhat(plv, ls, q_ext, rootsplit_nodes, rootsplit_edges):
    # Seed rootsplits' RHat with q * stationary (reference
    # SetToStationaryDistribution, src/gp_engine.cpp:218).  Padded
    # rootsplit entries carry edge ecap (q 0) and node ncap (dummy slot).
    S = plv.shape[-1]
    rhat_root = jnp.broadcast_to(
        (q_ext[rootsplit_edges] * 0.25)[:, None, None],
        (rootsplit_nodes.shape[0], 4, S),
    )
    plv = plv.at[RHAT, rootsplit_nodes].set(rhat_root)
    ls = ls.at[RHAT, rootsplit_nodes].set(0.0)
    return plv, ls


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("np1", "n_taxa"))
def _populate_impl(idx, blc, qc, tips, *, np1, n_taxa):
    bl_ext, q_ext = _ext(blc, qc)
    trans = jc69_transition(bl_ext)       # [ecap+1, 4, 4]
    S = tips.shape[-1]
    dtype = blc.dtype
    plv = jnp.zeros((6, np1, 4, S), dtype)
    ls = jnp.zeros((6, np1, S), dtype)
    plv = plv.at[P, :n_taxa].set(tips)
    rw, lw = idx["rw"], idx["lw"]

    def root_body(carry, lvl):
        plv, ls = carry
        dest_plv = jnp.where(lvl["side"], PHAT_LEFT, PHAT_RIGHT)
        acc, acc_ls = _accumulate(plv, ls, lvl["edge"], lvl["dest"],
                                  lvl["src"], lvl["src_plv"], trans,
                                  q_ext, dest_plv)
        plv, ls = _write_levels(plv, ls, acc, acc_ls,
                                (PHAT_RIGHT, PHAT_LEFT), lvl["nodes"])
        plv, ls = _multiply_rescale(plv, ls, P, PHAT_LEFT, PHAT_RIGHT,
                                    lvl["nodes"])
        return (plv, ls), None

    if rw is not None:
        (plv, ls), _ = jax.lax.scan(root_body, (plv, ls), rw)
    plv, ls = _seed_rhat(plv, ls, q_ext, idx["rootsplit_nodes"],
                         idx["rootsplit_edges"])

    def leaf_body(carry, lvl):
        plv, ls = carry
        dest_plv = jnp.full_like(lvl["edge"], RHAT)
        acc, acc_ls = _accumulate(plv, ls, lvl["edge"], lvl["dest"],
                                  lvl["src"], lvl["src_plv"], trans,
                                  q_ext, dest_plv)
        plv, ls = _write_levels(plv, ls, acc, acc_ls, (RHAT,),
                                lvl["acc_nodes"])
        plv, ls = _multiply_rescale(plv, ls, RRIGHT, RHAT, PHAT_LEFT,
                                    lvl["nodes"])
        plv, ls = _multiply_rescale(plv, ls, RLEFT, RHAT, PHAT_RIGHT,
                                    lvl["nodes"])
        return (plv, ls), None

    (plv, ls), _ = jax.lax.scan(leaf_body, (plv, ls), lw)
    return plv, ls


@jax.jit
def _likelihoods_impl(idx, plv, ls, blc, qc, weights):
    """Per-edge log likelihoods + per-site log marginal + total marginal
    (reference GPDAG::ComputeLikelihoods + IncrementMarginalLikelihood).
    Outputs are capacity-sized; padded edge rows are masked to zero and
    padded rootsplit scatters are dropped."""
    _, q_ext = _ext(blc, qc)
    trans = jc69_transition(blc)
    r = plv[idx["like_r_plv"], idx["like_parent"]]      # [ecap, 4, S]
    lsr = ls[idx["like_r_plv"], idx["like_parent"]]
    p = plv[P, idx["like_child"]]
    lsp = ls[P, idx["like_child"]]
    val = jnp.einsum("eas,eab,ebs->es", r, trans, p, precision=Precision)
    rows = jnp.log(jnp.where(val > 0, val, 1e-300)) + lsr + lsp
    per_edge = jnp.dot(rows, weights, precision=Precision)
    rootsplit_nodes = idx["rootsplit_nodes"]
    rootsplit_edges = idx["rootsplit_edges"]
    r0 = plv[RHAT, rootsplit_nodes]
    p0 = plv[P, rootsplit_nodes]
    lsp0 = ls[P, rootsplit_nodes]
    val0 = jnp.einsum("eas,eas->es", r0, p0, precision=Precision)
    rows0 = jnp.log(jnp.where(val0 > 0, val0, 1e-300)) + lsp0
    # Padded rootsplit rows gather the all-zero dummy slot -> rows0 ~ -690;
    # their exp underflows to 0 in the logsumexp, leaving the marginal
    # exact.
    log_marginal_site = jax.scipy.special.logsumexp(rows0, axis=0)
    per_edge_root = (
        jnp.dot(rows0, weights, precision=Precision)
        - jnp.log(q_ext[rootsplit_edges]) * jnp.sum(weights)
    )
    per_edge = jnp.where(idx["like_mask"], per_edge, 0.0)
    per_edge = per_edge.at[rootsplit_edges].set(per_edge_root, mode="drop")
    return per_edge, log_marginal_site, jnp.dot(
        log_marginal_site, weights, precision=Precision)


@_partial(jax.jit, static_argnames=("np1", "n_taxa", "method", "max_iter"))
def _estimate_impl(idx, blc, qc, tips, weights, tol, edge_mask,
                   *, np1, n_taxa, method, max_iter):
    """The whole EstimateBranchLengths coordinate-ascent loop as ONE
    device program: populate, then while (it < max_iter and mean |dbl|
    over real edges >= tol) { sweep; populate }, so the convergence
    check needs no host sync per sweep.
    Returns (plv, ls, blc, |dbl| per edge (capacity-sized), iters)."""
    plv, ls = _populate_impl(idx, blc, qc, tips, np1=np1, n_taxa=n_taxa)
    denom = jnp.maximum(edge_mask.sum(), 1.0)
    big = jnp.asarray(jnp.inf, blc.dtype)

    def cond(st):
        it, diff_mean, *_ = st
        return (it < max_iter) & (diff_mean >= tol)

    def body(st):
        it, _, diffs, plv, ls, blc = st
        old = blc
        plv, ls, blc = _sweep_impl(idx, plv, ls, blc, qc, weights,
                                   method=method)
        plv, ls = _populate_impl(idx, blc, qc, tips, np1=np1,
                                 n_taxa=n_taxa)
        diffs = jnp.abs(blc - old) * edge_mask
        return (it + 1, diffs.sum() / denom, diffs, plv, ls, blc)

    it, _, diffs, plv, ls, blc = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(0), big, jnp.zeros_like(blc), plv, ls, blc))
    return plv, ls, blc, diffs, it


@_partial(jax.jit, static_argnames=("method",))
def _sweep_impl(idx, plv, ls, blc, qc, weights, *, method):
    """One leafward optimization sweep (tidy traversal levelized, scanned);
    see GPEngine.optimize_branch_lengths_once."""
    dtype = blc.dtype
    bl_ext, q_ext = _ext(blc, qc)
    plv, ls = _seed_rhat(plv, ls, q_ext, idx["rootsplit_nodes"],
                         idx["rootsplit_edges"])
    sweep = idx["sweep"]

    def optimize_side(plv, bl_ext, edges, parents, children, r_plv, w):
        """Batched per-edge 1-D optimization over one side's edges
        (reference DAGBranchHandler::OptimizeBranchLength,
        src/dag_branch_handler.cpp:123-285); padding rows optimize a flat
        objective and scatter into the dummy bl slot."""
        r = plv[r_plv, parents]               # [K, 4, S]
        p = plv[P, children]

        def ll_of_t(t):
            trans = jc69_transition(t)        # [K, 4, 4]
            val = jnp.einsum("kas,kab,kbs->ks", r, trans, p,
                             precision=Precision)
            return jnp.dot(jnp.log(jnp.where(val > 0, val, 1e-300)), w,
                           precision=Precision)

        def ll_y(y):
            return ll_of_t(jnp.exp(y))

        def per_lane_grad(f, x):
            return jax.jvp(f, (x,), (jnp.ones_like(x),))[1]

        guess_x = bl_ext[edges]
        lo = jnp.full(edges.shape, MIN_LOG_BL, dtype)
        hi = jnp.full(edges.shape, MAX_LOG_BL, dtype)

        if method in ("brent", "brent_with_gradients"):
            y0 = jnp.log(guess_x)

            def neg_ll(y):
                return -ll_y(y)

            y_opt = optimize.brent_minimize_batched(
                neg_ll, y0, lo, hi, iterations=60,
                use_gradients=(method == "brent_with_gradients"))
            # Reset-if-worse guard (dag_branch_handler.cpp:143-150).
            worse = neg_ll(y_opt) > neg_ll(y0)
            x_new = jnp.where(worse, guess_x, jnp.exp(y_opt))
        elif method == "gradient_ascent":
            # The reference floors x at min_log_branch_length_ itself
            # (dag_branch_handler.cpp:225-228) — replicated as-is.
            def ffp(x):
                return ll_of_t(x), per_lane_grad(ll_of_t, x)

            x_new = optimize.gradient_ascent_batched(
                ffp, guess_x, jnp.full_like(guess_x, MIN_LOG_BL))
        elif method == "log_space_gradient_ascent":
            def ffp(x):
                return ll_of_t(x), per_lane_grad(ll_of_t, x)

            x_new = optimize.log_space_gradient_ascent_batched(
                ffp, guess_x,
                jnp.full_like(guess_x, float(np.exp(MIN_LOG_BL))))
        elif method == "newton":
            def f3(y):
                f = ll_y(y)
                g = per_lane_grad(ll_y, y)
                h = per_lane_grad(lambda z: per_lane_grad(ll_y, z), y)
                return f, g, h

            y_opt = optimize.newton_raphson_batched(
                f3, jnp.log(guess_x), lo, hi)
            x_new = jnp.exp(y_opt)
        else:
            raise ValueError(f"Unknown optimization method: {method!r}")
        return bl_ext.at[edges].set(x_new)

    def rebuild_phat(plv, ls, bl_ext, q_ext, edge, dest, src, ptype, nodes):
        trans = jc69_transition(bl_ext)
        acc, acc_ls = _accumulate(plv, ls, edge, dest, src,
                                  jnp.full_like(edge, P), trans, q_ext,
                                  jnp.full_like(edge, ptype))
        return _write_levels(plv, ls, acc, acc_ls, (ptype,), nodes)

    def body(carry, lvl):
        plv, ls, bl_ext = carry
        trans = jc69_transition(bl_ext)
        dest_plv = jnp.full_like(lvl["edge"], RHAT)
        acc, acc_ls = _accumulate(plv, ls, lvl["edge"], lvl["dest"],
                                  lvl["src"], lvl["src_plv"], trans,
                                  q_ext, dest_plv)
        plv, ls = _write_levels(plv, ls, acc, acc_ls, (RHAT,),
                                lvl["acc_nodes"])
        # Right side: RRight = RHat o PHatLeft, optimize, rebuild.
        plv, ls = _multiply_rescale(plv, ls, RRIGHT, RHAT, PHAT_LEFT,
                                    lvl["nodes"])
        bl_ext = optimize_side(plv, bl_ext, lvl["r_edge"],
                               lvl["r_parent"], lvl["r_child"],
                               RRIGHT, weights)
        plv, ls = rebuild_phat(plv, ls, bl_ext, q_ext,
                               lvl["reb_r_edge"], lvl["reb_r_dest"],
                               lvl["reb_r_src"], PHAT_RIGHT,
                               lvl["internal"])
        # Left side.
        plv, ls = _multiply_rescale(plv, ls, RLEFT, RHAT, PHAT_RIGHT,
                                    lvl["nodes"])
        bl_ext = optimize_side(plv, bl_ext, lvl["l_edge"],
                               lvl["l_parent"], lvl["l_child"],
                               RLEFT, weights)
        plv, ls = rebuild_phat(plv, ls, bl_ext, q_ext,
                               lvl["reb_l_edge"], lvl["reb_l_dest"],
                               lvl["reb_l_src"], PHAT_LEFT,
                               lvl["internal"])
        plv, ls = _multiply_rescale(plv, ls, P, PHAT_LEFT, PHAT_RIGHT,
                                    lvl["internal"])
        return (plv, ls, bl_ext), None

    (plv, ls, bl_ext), _ = jax.lax.scan(body, (plv, ls, bl_ext), sweep)
    return plv, ls, bl_ext[:-1]


class GPEngine:
    def __init__(self, site_pattern: SitePattern, dag: SubsplitDAG,
                 dtype=None, optimization_method: str = "brent",
                 caps: Optional[Dict[str, int]] = None,
                 headroom: int = 1):
        """`caps` optionally shares a capacity-bucket dict with other
        engines (e.g. an NNI loop's per-iteration grafted scorers): buckets
        only grow, so engines sharing the dict converge onto one set of
        program shapes and hence one compiled program set.  `headroom` > 1
        makes every cap ratchet jump that factor past the current need —
        set it on engines whose DAG will keep growing (NNI loops), so a
        ratchet event buys headroom x growth instead of recompiling again
        next acceptance."""
        self.site_pattern = site_pattern
        self.dag = dag
        self._headroom = headroom
        self.optimization_method = optimization_method
        self.dtype = dtype or jnp.zeros(0).dtype
        self.schedule = build_schedule(dag)
        S0 = site_pattern.pattern_count
        self.S = S0  # patterns kept unpadded here; pad when sharding
        tips = site_pattern.tip_partials().astype(np.float64)  # [n, S, 4]
        self.tips = jnp.asarray(np.swapaxes(tips, 1, 2), dtype=self.dtype)
        self.weights = jnp.asarray(site_pattern.weights, dtype=self.dtype)
        # Priors (reference GPInstance::MakeGPEngine, src/gp_instance.cpp:146)
        self.sbn_prior = dag.build_uniform_on_topological_support_prior()
        node_probs = dag.unconditional_node_probabilities(self.sbn_prior)
        self.unconditional_node_probabilities = node_probs[
            : dag.node_count_without_dag_root()
        ]
        self.inverted_sbn_prior = dag.inverted_gpcsp_probabilities(
            self.sbn_prior, node_probs
        )
        # Mutable engine state.  Branch lengths and q live at CAPACITY
        # size (padded to the bucket) so every jitted program sees stable
        # shapes across DAG growth; the public `branch_lengths` / `q`
        # properties expose true-size views.
        self._caps: Dict[str, int] = caps if caps is not None else {}
        self._prepare_index_arrays(headroom=self._headroom)
        E = self.schedule.edge_count
        ecap = self._caps["e"]
        # Host-side padding: .at[:E].set with a per-DAG E compiled a tiny
        # XLA program per distinct edge count — one per NNI iteration in
        # the grafted-scorer path.
        qc0 = np.zeros(ecap)
        qc0[:E] = np.asarray(self.sbn_prior)
        self._qc = jnp.asarray(qc0, dtype=self.dtype)
        self._blc = jnp.full((ecap,), DEFAULT_BL, dtype=self.dtype)
        self.branch_length_differences = np.zeros(E)
        self.plv: Optional[jnp.ndarray] = None
        self.ls: Optional[jnp.ndarray] = None
        self.per_edge_ll: Optional[jnp.ndarray] = None
        self.log_marginal_site: Optional[jnp.ndarray] = None
        self._log_marginal = None
        self.hybrid_marginal_log_likelihoods = np.full(E, -np.inf)

    # ------------------------------------------------------------------
    # capacity-sized state views
    # ------------------------------------------------------------------
    @property
    def branch_lengths(self):
        return self._blc[: self.schedule.edge_count]

    @branch_lengths.setter
    def branch_lengths(self, value):
        value = jnp.asarray(value, dtype=self.dtype)
        if value.shape[0] == self._blc.shape[0]:
            self._blc = value
        else:
            self._blc = self._blc.at[: value.shape[0]].set(value)

    @property
    def q(self):
        return self._qc[: self.schedule.edge_count]

    @q.setter
    def q(self, value):
        value = jnp.asarray(value, dtype=self.dtype)
        if value.shape[0] == self._qc.shape[0]:
            self._qc = value
        else:
            self._qc = self._qc.at[: value.shape[0]].set(value)

    # ------------------------------------------------------------------
    # index-tensor preparation (host work; compiled programs are the
    # module-level _populate_impl/_likelihoods_impl/_sweep_impl and are
    # reused whenever the capacity bucket — hence every shape — matches)
    # ------------------------------------------------------------------
    def _prepare_index_arrays(self, headroom: int = 1):
        sch = self.schedule
        caps = self._caps
        N, E, R = sch.node_count, sch.edge_count, len(sch.rootsplit_nodes)

        def bucket(value, m):
            """Geometric capacity buckets (m, 2m, 4m, ...): growth ratchets
            a shape at most O(log) times, so engines sharing a caps dict
            settle onto one compiled program set after a few doublings."""
            b = m
            while b < value:
                b *= 2
            return b

        def need(key, value, m):
            cur = caps.get(key, 0)
            if bucket(value, m) <= cur:
                return
            # A key that actually ratchets during GROWTH jumps to
            # headroom x the need (the reference's 2x spare-allocation on
            # GrowPLVs, src/gp_engine.cpp:64-209): with ~20 shape keys
            # starting at small buckets, ratcheting them one per
            # iteration recompiled three programs nearly EVERY NNI
            # acceptance.  Static engines
            # (headroom=1) keep exact buckets: padding is masked device
            # compute, so one-shot workloads shouldn't pay 2x.
            caps[key] = bucket(value * headroom, m)

        need("n", N, 32)
        need("e", E, 64)
        need("r", R, 8)
        need("Lr", len(sch.rootward), 2)
        need("Ll", len(sch.leafward), 2)
        need("Kr", max((len(l.edge) for l in sch.rootward), default=1), 16)
        need("Kl", max((len(l.edge) for l in sch.leafward), default=1), 16)
        need("Mr", max((len(l.nodes) for l in sch.rootward), default=1), 16)
        need("Ml", max((len(l.nodes) for l in sch.leafward), default=1), 16)
        ncap, ecap = caps["n"], caps["e"]

        def stack_entries(levels, L, K, M):
            # Plain numpy here: the whole index pytree ships in ONE
            # jax.device_put at the end instead of ~40 per-array
            # transfers.
            return dict(
                edge=_pad_stack([l.edge for l in levels], ecap,
                                width=K, rows=L),
                dest=_pad_stack([l.dest for l in levels], ncap,
                                width=K, rows=L),
                side=_pad_stack(
                    [l.dest_side.astype(np.int32) for l in levels], 0,
                    width=K, rows=L),
                src=_pad_stack([l.src for l in levels], ncap,
                               width=K, rows=L),
                src_plv=_pad_stack(
                    [l.src_plv for l in levels], 0, width=K, rows=L),
                nodes=_pad_stack([l.nodes for l in levels],
                                 ncap, width=M, rows=L),
            )

        rw = (stack_entries(sch.rootward, caps["Lr"], caps["Kr"], caps["Mr"])
              if sch.rootward else None)
        lw = stack_entries(sch.leafward, caps["Ll"], caps["Kl"], caps["Ml"])
        # Leafward level 0 (the rootsplits) receives no accumulation: its
        # RHat is seeded from the stationary distribution, so its acc write
        # targets only the dummy node.
        lw["acc_nodes"] = _pad_stack(
            [np.zeros(0, dtype=np.int32)]
            + [l.nodes for l in sch.leafward[1:]], ncap,
            width=caps["Ml"], rows=caps["Ll"],
        )

        # -- optimization sweep columns (tidy traversal, levelized) -------
        opt_cols: Dict[str, List[np.ndarray]] = {
            k: [] for k in ("r_edge", "r_parent", "r_child",
                            "l_edge", "l_parent", "l_child",
                            "internal",
                            "reb_r_edge", "reb_r_dest", "reb_r_src",
                            "reb_l_edge", "reb_l_dest", "reb_l_src")
        }
        for lvl in sch.leafward:
            internal = np.asarray(
                [u for u in lvl.nodes.tolist() if u >= sch.taxon_count],
                dtype=np.int32,
            )
            opt_cols["internal"].append(internal)
            for side, tag in ((RIGHT, "r"), (LEFT, "l")):
                edges, parents, children = [], [], []
                for u in lvl.nodes.tolist():
                    for c, e in self.dag.leafward[u][side]:
                        edges.append(e)
                        parents.append(u)
                        children.append(c)
                opt_cols[f"{tag}_edge"].append(
                    np.asarray(edges, dtype=np.int32))
                opt_cols[f"{tag}_parent"].append(
                    np.asarray(parents, dtype=np.int32))
                opt_cols[f"{tag}_child"].append(
                    np.asarray(children, dtype=np.int32))
                re_e, re_d, re_s = [], [], []
                for u in internal.tolist():
                    for c, e in self.dag.leafward[u][side]:
                        re_e.append(e)
                        re_d.append(u)
                        re_s.append(c)
                opt_cols[f"reb_{tag}_edge"].append(
                    np.asarray(re_e, dtype=np.int32))
                opt_cols[f"reb_{tag}_dest"].append(
                    np.asarray(re_d, dtype=np.int32))
                opt_cols[f"reb_{tag}_src"].append(
                    np.asarray(re_s, dtype=np.int32))
        pad_of = {"edge": ecap, "parent": ncap, "child": ncap,
                  "dest": ncap, "src": ncap, "internal": ncap}
        sweep = dict(lw)
        for k, cols in opt_cols.items():
            kind = k.split("_")[-1]
            ck = f"Ko_{k}"
            need(ck, max((len(c) for c in cols), default=1), 16)
            sweep[k] = _pad_stack(
                cols, pad_of[kind], width=caps[ck], rows=caps["Ll"])

        rs_nodes = _pad_stack([sch.rootsplit_nodes], ncap,
                              width=caps["r"])[0]
        rs_edges = _pad_stack([sch.rootsplit_edges], ecap,
                              width=caps["r"])[0]
        like_parent = np.full(ecap, ncap, dtype=np.int32)
        like_parent[:E] = sch.like_parent
        like_r_plv = np.zeros(ecap, dtype=np.int32)
        like_r_plv[:E] = sch.like_r_plv
        like_child = np.full(ecap, ncap, dtype=np.int32)
        like_child[:E] = sch.like_child
        like_mask = np.zeros(ecap, dtype=bool)
        like_mask[:E] = sch.like_mask

        # One transfer for the whole index pytree instead of ~40
        # per-array transfers.
        self._idx = jax.device_put(dict(
            rw=rw, lw=lw, sweep=sweep,
            rootsplit_nodes=rs_nodes,
            rootsplit_edges=rs_edges,
            like_parent=like_parent,
            like_r_plv=like_r_plv,
            like_child=like_child,
            like_mask=like_mask,
        ))
        self._np1 = ncap + 1

    # ------------------------------------------------------------------
    # incremental growth (reference GPEngine::GrowPLVs / GrowGPCSPs with
    # reindexing, src/gp_engine.cpp:64-209): the engine keeps its compiled
    # programs (capacity buckets -> stable shapes, module-level jit cache),
    # carries branch lengths by PCSP and PLVs by subsplit, and only the
    # host-side index tensors are rebuilt.
    # ------------------------------------------------------------------
    def grow(self, new_dag: SubsplitDAG, mods=None):
        """Grow the engine onto `new_dag`.  Pass the ModificationResult as
        `mods` when `new_dag` is the SAME object mutated in place
        (dag.add_node_pair); otherwise carry maps come from the old DAG's
        subsplit/PCSP indexers."""
        old_dag = self.dag
        if mods is None:
            assert new_dag is not old_dag, (
                "in-place DAG mutation: pass the ModificationResult so the "
                "engine can reindex (the old id maps are gone)")
            old_node_of = old_dag.subsplit_to_id
            old_edge_of = old_dag.build_edge_indexer()
        old_blc = self._blc
        old_plv, old_ls = self.plv, self.ls
        old_np1 = self._np1

        self.dag = new_dag
        self.schedule = build_schedule(new_dag)
        E = self.schedule.edge_count
        self.sbn_prior = new_dag.build_uniform_on_topological_support_prior()
        node_probs = new_dag.unconditional_node_probabilities(self.sbn_prior)
        self.unconditional_node_probabilities = node_probs[
            : new_dag.node_count_without_dag_root()
        ]
        self.inverted_sbn_prior = new_dag.inverted_gpcsp_probabilities(
            self.sbn_prior, node_probs
        )
        self._prepare_index_arrays(headroom=max(self._headroom, 2))
        ecap = self._caps["e"]
        # Branch lengths carry over by PCSP; q restarts from the new prior
        # (the reference re-derives the prior on growth too).
        bl = np.full(ecap, DEFAULT_BL)
        old_bl_host = np.asarray(old_blc)
        if mods is not None:
            bl[mods.edge_reindexer] = old_bl_host[
                : len(mods.edge_reindexer)]
        else:
            new_edge_of = new_dag.build_edge_indexer()
            for pcsp, e_new in new_edge_of.items():
                e_old = old_edge_of.get(pcsp)
                if e_old is not None:
                    bl[e_new] = old_bl_host[e_old]
        self._blc = jnp.asarray(bl, dtype=self.dtype)
        qc0 = np.zeros(ecap)
        qc0[:E] = np.asarray(self.sbn_prior)
        self._qc = jnp.asarray(qc0, dtype=self.dtype)
        self.branch_length_differences = np.zeros(E)
        self.hybrid_marginal_log_likelihoods = np.full(E, -np.inf)
        # PLV carry-over by subsplit identity: surviving nodes keep their
        # values bit-for-bit (new/changed nodes start zeroed and are filled
        # by the next populate).
        if old_plv is not None:
            if mods is not None:
                old_ids_np = np.arange(len(mods.node_reindexer),
                                       dtype=np.int32)
                new_ids_np = np.asarray(mods.node_reindexer, dtype=np.int32)
                keep = old_ids_np < old_np1 - 1
                old_ids_np, new_ids_np = old_ids_np[keep], new_ids_np[keep]
            else:
                new_ids_np, old_ids_np = [], []
                for new_id, ss in enumerate(new_dag.nodes):
                    old_id = old_node_of.get(ss.to_string())
                    if old_id is not None and old_id < old_np1 - 1:
                        new_ids_np.append(new_id)
                        old_ids_np.append(old_id)
            # Pad the carry index arrays to the node capacity bucket:
            # this eager scatter/gather otherwise compiles a fresh XLA
            # program per distinct id-count.  Padding rows shuttle the old dummy slot into the
            # new dummy slot (both scratch), so values are unchanged and
            # one compiled program serves every grow within the bucket.
            ncap = self._np1 - 1
            o = np.full(ncap, old_np1 - 1, dtype=np.int32)
            nn = np.full(ncap, self._np1 - 1, dtype=np.int32)
            k = len(new_ids_np)
            o[:k] = np.asarray(old_ids_np, dtype=np.int32)
            nn[:k] = np.asarray(new_ids_np, dtype=np.int32)
            new_ids = jnp.asarray(nn)
            old_ids = jnp.asarray(o)
            S = old_plv.shape[-1]
            plv = jnp.zeros((6, self._np1, 4, S), self.dtype)
            ls = jnp.zeros((6, self._np1, S), self.dtype)
            self.plv = plv.at[:, new_ids].set(old_plv[:, old_ids])
            self.ls = ls.at[:, new_ids].set(old_ls[:, old_ids])
        self.per_edge_ll = None
        self.log_marginal_site = None
        self._log_marginal = None

    # ------------------------------------------------------------------
    # public API (mirroring reference GPEngine / GPInstance verbs)
    # ------------------------------------------------------------------
    def shard_patterns(self, mesh, axis: str = "sites"):
        """Shard the site-pattern axis of the engine across a device mesh
        (SURVEY P5/P6: site patterns are the single distributed axis; DAG
        structure, q, and branch lengths stay replicated).  Patterns are
        padded to the mesh size with weight-zero all-ones columns, the
        tip/weight tensors are re-placed with NamedShardings, and the
        wavefront programs are rebuilt so XLA propagates the sharding
        through every PLV and inserts psums for the per-edge reductions."""
        from jax.sharding import PartitionSpec

        from ..dist import multihost

        n_dev = mesh.shape[axis]
        pad = (-self.S) % n_dev
        tips = np.asarray(self.tips)
        weights = np.asarray(self.weights)
        if pad:
            tips = np.concatenate(
                [tips, np.ones(tips.shape[:2] + (pad,), tips.dtype)],
                axis=-1,
            )
            weights = np.concatenate(
                [weights, np.zeros(pad, weights.dtype)])
            self.S = tips.shape[-1]
        # multihost.place works for single- and multi-process meshes alike.
        self.tips = multihost.place(
            jnp.asarray(tips, dtype=self.dtype), mesh,
            PartitionSpec(None, None, axis))
        self.weights = multihost.place(
            jnp.asarray(weights, dtype=self.dtype), mesh,
            PartitionSpec(axis))
        # Stale per-pattern state; the module-level programs retrace on
        # the new tip/weight shardings automatically.
        self.plv = None
        self.ls = None
        self.per_edge_ll = None
        self.log_marginal_site = None
        self._log_marginal = None

    def populate_plvs(self):
        self.plv, self.ls = _populate_impl(
            self._idx, self._blc, self._qc, self.tips,
            np1=self._np1, n_taxa=self.schedule.taxon_count)

    def compute_likelihoods(self):
        assert self.plv is not None, "Call populate_plvs first"
        per_edge, self.log_marginal_site, self._log_marginal = (
            _likelihoods_impl(self._idx, self.plv, self.ls, self._blc,
                              self._qc, self.weights))
        self.per_edge_ll = per_edge[: self.schedule.edge_count]

    def log_marginal_likelihood(self) -> float:
        """Reference GPEngine::GetLogMarginalLikelihood: per-site log
        marginal dotted with site weights."""
        assert self._log_marginal is not None, (
            "Call compute_likelihoods first (grow()/populate invalidate "
            "the cached marginal)")
        return float(self._log_marginal)

    def per_gpcsp_log_likelihoods(self) -> np.ndarray:
        return np.asarray(self.per_edge_ll)

    def per_gpcsp_components_of_full_log_marginal(self) -> np.ndarray:
        """Reference GetPerGPCSPComponentsOfFullLogMarginal."""
        return (
            np.asarray(self.per_edge_ll)
            + float(self.site_pattern.weights.sum()) * np.log(np.asarray(self.q))
        )

    def set_optimization_method(self, method: str):
        """Reference GPEngine::SetOptimizationMethod
        (src/gp_engine.cpp:656-658)."""
        valid = ("brent", "brent_with_gradients", "gradient_ascent",
                 "log_space_gradient_ascent", "newton")
        if method not in valid:
            raise ValueError(f"Unknown optimization method {method!r}; "
                             f"expected one of {valid}")
        # The method rides as a static jit argument of the sweep program,
        # so switching costs at most one compile per (method, bucket).
        self.optimization_method = method

    def use_gradient_optimization(self, use_gradients: bool = True):
        """Reference GPEngine::UseGradientOptimization
        (src/gp_engine.cpp:660-664): selects Brent-with-gradient-fallback
        vs plain Brent."""
        self.set_optimization_method(
            "brent_with_gradients" if use_gradients else "brent")

    def optimize_branch_lengths_once(self):
        E = self.schedule.edge_count
        old = self._blc
        self.plv, self.ls, self._blc = _sweep_impl(
            self._idx, self.plv, self.ls, self._blc, self._qc,
            self.weights, method=self.optimization_method)
        self.branch_length_differences = jnp.abs(self._blc - old)[:E]

    def estimate_branch_lengths(self, tol: float, max_iter: int,
                                quiet: bool = True) -> float:
        """Reference GPInstance::EstimateBranchLengths
        (src/gp_instance.cpp:241-310): coordinate-ascent sweeps until the
        mean |Delta bl| drops below tol."""
        # Convergence is decided by mean |delta bl| alone (exactly the
        # reference's criterion), so the likelihood pass per sweep is only
        # needed for the verbose trace: computing it once after the loop
        # halves the dominant cost of post-acceptance re-estimation in the
        # GP-scored NNI loop (measured 13.2 s of a 16 s DS1-credible
        # iteration on CPU) while every sweep, every convergence decision,
        # and the returned marginal are unchanged.
        if quiet:
            # The whole loop (populate + sweeps + convergence) as ONE
            # device program, with no per-sweep host convergence sync.
            E = self.schedule.edge_count
            ecap = self._blc.shape[0]
            mask = np.zeros(ecap)
            mask[:E] = 1.0
            plv, ls, blc, diff, _it = _estimate_impl(
                self._idx, self._blc, self._qc, self.tips, self.weights,
                jnp.asarray(tol, self.dtype),
                jnp.asarray(mask, self.dtype),
                np1=self._np1, n_taxa=self.schedule.taxon_count,
                method=self.optimization_method, max_iter=max_iter)
            self.plv, self.ls, self._blc = plv, ls, blc
            self.branch_length_differences = np.asarray(diff)[:E]
            self.compute_likelihoods()
            return self.log_marginal_likelihood()
        self.populate_plvs()
        for it in range(max_iter):
            self.optimize_branch_lengths_once()
            self.populate_plvs()
            diff = float(jnp.mean(self.branch_length_differences))
            if not quiet:
                self.compute_likelihoods()
                print(f"Iteration {it + 1}: marginal "
                      f"{self.log_marginal_likelihood():.9f} "
                      f"mean|dbl| {diff:.3e}")
            if diff < tol:
                break
        self.compute_likelihoods()
        return self.log_marginal_likelihood()

    def _sbn_segment_arrays(self):
        """Flat segment-id arrays for the device-side SBN update, cached per
        schedule: seg_ids[e] in [0, nseg) for covered edges (-> bucket nseg
        for uncovered), plus singleton and covered masks."""
        segs = self.schedule.sbn_segments
        key = id(self.schedule)
        cached = getattr(self, "_sbn_seg_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1:]
        E = int(np.asarray(self.q).shape[0])
        seg_ids = np.full(E, len(segs), dtype=np.int32)
        singleton = np.zeros(E, dtype=bool)
        for i, (start, end) in enumerate(segs):
            seg_ids[start:end] = i
            if end - start == 1:
                singleton[start] = True
        covered = seg_ids < len(segs)
        out = (jnp.asarray(seg_ids), len(segs), jnp.asarray(singleton),
               jnp.asarray(covered))
        self._sbn_seg_cache = (key,) + out
        return out

    def update_sbn_probabilities(self):
        """Reference UpdateSBNProbabilities (src/gp_engine.cpp:304-321):
        per-parent-segment posterior normalization of q, computed as one
        XLA segment-softmax (segment_max / segment_sum) instead of a host
        loop over segments.  Segments whose hybrid marginals are all finite
        use those; otherwise the per-edge likelihoods."""
        seg_ids, nseg, singleton, covered = self._sbn_segment_arrays()
        q = jnp.asarray(self.q, dtype=self.dtype)
        ll = jnp.asarray(self.per_edge_ll, dtype=self.dtype)
        hybrid = jnp.asarray(self.hybrid_marginal_log_likelihoods,
                             dtype=self.dtype)
        self.q = _sbn_segment_softmax(q, ll, hybrid, seg_ids, nseg,
                                      singleton, covered)

    def estimate_sbn_parameters(self):
        """Reference GPInstance::EstimateSBNParameters: populate, compute
        likelihoods, then normalize q per segment."""
        self.populate_plvs()
        self.compute_likelihoods()
        self.update_sbn_probabilities()
        self.compute_likelihoods()

    # -- branch length initialization from trees -----------------------
    def _edge_lengths_from_trees(self, tree_collection) -> Dict[int, List[float]]:
        indexer = self.dag.build_edge_indexer()
        observed: Dict[int, List[float]] = {}
        from ..core.bitset import Subsplit
        from ..sbn.maps import rooted_rootsplit

        for tree in tree_collection.trees:
            topo = tree.topology
            n = topo.num_taxa
            cl = topo.clades()
            ch = topo.children()
            ss = {}
            for v in range(n):
                ss[v] = Subsplit.leaf(v, n)
            for v in range(n, topo.num_nodes):
                kids = ch[v]
                ss[v] = Subsplit.of_pair(cl[kids[0]], cl[kids[1]], n)
            for v in range(topo.num_nodes - 1):
                parent = int(topo.parents[v])
                from ..core.bitset import PCSP

                pcsp = PCSP.of_parent_child(ss[parent], ss[v]).to_string()
                if pcsp in indexer:
                    observed.setdefault(indexer[pcsp], []).append(
                        float(tree.branch_lengths[v])
                    )
        return observed

    def hot_start_branch_lengths(self, tree_collection):
        """Reference GPEngine::HotStartBranchLengths
        (src/gp_engine.cpp:676-746): per-edge mean of observed lengths."""
        bl = np.asarray(self.branch_lengths).copy()
        for e, vals in self._edge_lengths_from_trees(tree_collection).items():
            bl[e] = float(np.mean(vals))
        self.branch_lengths = jnp.asarray(bl, dtype=self.dtype)

    def take_first_branch_length(self, tree_collection):
        bl = np.asarray(self.branch_lengths).copy()
        for e, vals in self._edge_lengths_from_trees(tree_collection).items():
            bl[e] = vals[0]
        self.branch_lengths = jnp.asarray(bl, dtype=self.dtype)


from functools import partial


@partial(jax.jit, static_argnames=("nseg",))
def _sbn_segment_softmax(q, ll, hybrid, seg_ids, nseg, singleton, covered):
    """One-shot segment softmax for UpdateSBNProbabilities: per segment,
    normalize exp(src + log q); singletons pin to 1; uncovered edges keep
    their q."""
    finite = jnp.isfinite(hybrid)
    # A segment uses hybrid values iff every member is finite.
    seg_all_finite = jax.ops.segment_min(
        finite.astype(jnp.int32), seg_ids, num_segments=nseg + 1)
    use_hybrid = seg_all_finite[seg_ids] > 0
    src = jnp.where(use_hybrid, hybrid, ll)
    x = src + jnp.log(q)
    m = jax.ops.segment_max(x, seg_ids, num_segments=nseg + 1)
    p = jnp.exp(x - m[seg_ids])
    s = jax.ops.segment_sum(p, seg_ids, num_segments=nseg + 1)
    out = p / s[seg_ids]
    out = jnp.where(singleton, 1.0, out)
    return jnp.where(covered, out, q)


# ---------------------------------------------------------------------------
# Quartet hybrid marginals (reference GPEngine::CalculateQuartetHybridLikelihoods,
# src/gp_engine.cpp:748-816; requests per GPDAG::QuartetHybridRequestOf,
# src/gp_dag.cpp:413-458).
# ---------------------------------------------------------------------------
def _np_jc69(t: float) -> np.ndarray:
    e = np.exp(-4.0 * t / 3.0)
    return 0.25 * (1.0 - e) + e * np.eye(4)


@jax.jit
def _quartet_hybrid_program(root_pv, root_ls, root_bl, log_prior_g,
                            inv_prior_i, sis_pv, sis_ls, sis_bl, q_j,
                            central_bl, rot_pv, rot_ls, rot_bl, q_k,
                            sor_pv, sor_ls, sor_bl, q_l, weights):
    """All (i, j, k, l) quartet log likelihoods of one hybrid request in a
    single XLA program (replaces the reference's nested per-tip loops,
    src/gp_engine.cpp:748-816).  PV inputs are [N,4,S]; scale inputs [N,S];
    returns [I,J,K,L] in the reference's loop order."""
    root = jnp.einsum("iab,ibs->ias", jc69_transition(root_bl), root_pv,
                      precision=Precision)
    sis = jnp.einsum("jab,jbs->jas", jc69_transition(sis_bl), sis_pv,
                     precision=Precision)
    rot = jnp.einsum("kab,kbs->kas", jc69_transition(rot_bl), rot_pv,
                     precision=Precision)
    sor = jnp.einsum("lab,lbs->las", jc69_transition(sor_bl), sor_pv,
                     precision=Precision)
    r_s = root[:, None] * sis[None]                       # [I,J,4,S]
    q_s = jnp.einsum("ab,ijbs->ijas", jc69_transition(central_bl), r_s,
                     precision=Precision)
    r_sorted = q_s[:, :, None] * rot[None, None]          # [I,J,K,4,S]
    val = jnp.einsum("ijkas,las->ijkls", r_sorted, sor,
                     precision=Precision)                 # [I,J,K,L,S]
    scales_ijk = (root_ls[:, None, None, :] + sis_ls[None, :, None, :]
                  + rot_ls[None, None, :, :])          # [I,J,K,S]
    per_site = (jnp.log(jnp.where(val > 0, val, 1e-300))
                + scales_ijk[:, :, :, None, :]
                + sor_ls[None, None, None, :, :]
                - log_prior_g[:, None, None, None, None])
    total = jnp.einsum("ijkls,s->ijkl", per_site, weights,
                       precision=Precision)
    non_seq = (jnp.log(inv_prior_i)[:, None, None, None]
               + jnp.log(q_j)[None, :, None, None]
               + jnp.log(q_k)[None, None, :, None]
               + jnp.log(q_l)[None, None, None, :])
    return total + non_seq


@jax.jit
def _hybrid_batch_program(*args):
    """One group of same-shape hybrid requests as a single program: vmap of
    the per-request quartet program (weights broadcast) plus an on-device
    logsumexp over each request's (i, j, k, l) combinations -> per-request
    log marginal [R]."""
    vals = jax.vmap(_quartet_hybrid_program,
                    in_axes=(0,) * 18 + (None,))(*args)  # [R, I, J, K, L]
    flat = vals.reshape(vals.shape[0], -1)
    return jax.scipy.special.logsumexp(flat, axis=1)


class _HybridMixin:
    def _hybrid_request(self, parent_id: int, is_left: bool, child_id: int):
        """(rootward, sister, rotated, sorted) tip lists: each entry is
        (node_id, plv_type, edge_id)."""
        from ..dag.schedule import P as P_PLV, RLEFT, RRIGHT
        from ..dag.subsplit_dag import LEFT, RIGHT

        dag = self.dag
        rootward = []
        for side in (RIGHT, LEFT):
            for g, e in dag.rootward[parent_id][side]:
                if g == dag.root_id:
                    continue
                rootward.append((g, RLEFT if side == LEFT else RRIGHT, e))
        sister_side = RIGHT if is_left else LEFT
        sister = [(s, P_PLV, e) for s, e in dag.leafward[parent_id][sister_side]]
        rotated = [(c, P_PLV, e) for c, e in dag.leafward[child_id][LEFT]]
        sorted_ = [(c, P_PLV, e) for c, e in dag.leafward[child_id][RIGHT]]
        return rootward, sister, rotated, sorted_

    def calculate_quartet_hybrid_likelihoods(
        self, parent_id: int, is_left: bool, child_id: int
    ) -> Optional[np.ndarray]:
        """Per-combination quartet log likelihoods for the central edge
        (parent, child); None if the request is not fully formed."""
        from ..dag.subsplit_dag import LEFT

        dag = self.dag
        rootward, sister, rotated, sorted_ = self._hybrid_request(
            parent_id, is_left, child_id
        )
        if not (rootward and sister and rotated and sorted_):
            return None
        central_edge = dag.edge_to_id[(parent_id, child_id)]
        plv, ls, bl, q = self.plv, self.ls, self.branch_lengths, self.q
        inv_prior = jnp.asarray(self.inverted_sbn_prior, dtype=self.dtype)
        node_probs = jnp.asarray(self.unconditional_node_probabilities,
                                 dtype=self.dtype)

        def gather(entries):
            nodes = jnp.asarray([n for n, _, _ in entries])
            types = jnp.asarray([t for _, t, _ in entries])
            edges = jnp.asarray([e for _, _, e in entries])
            return (plv[types, nodes], ls[types, nodes], bl[edges], edges)

        root_pv, root_ls, root_bl, root_e = gather(rootward)
        sis_pv, sis_ls, sis_bl, sis_e = gather(sister)
        rot_pv, rot_ls, rot_bl, rot_e = gather(rotated)
        sor_pv, sor_ls, sor_bl, sor_e = gather(sorted_)
        g_ids = jnp.asarray([g for g, _, _ in rootward])
        vals = _quartet_hybrid_program(
            root_pv, root_ls, root_bl, jnp.log(node_probs[g_ids]),
            inv_prior[root_e], sis_pv, sis_ls, sis_bl, q[sis_e],
            bl[central_edge], rot_pv, rot_ls, rot_bl, q[rot_e],
            sor_pv, sor_ls, sor_bl, q[sor_e],
            jnp.asarray(self.weights, dtype=self.dtype),
        )
        return np.asarray(vals).reshape(-1)

    def process_quartet_hybrid_request(self, parent_id: int, is_left: bool,
                                       child_id: int):
        vals = self.calculate_quartet_hybrid_likelihoods(
            parent_id, is_left, child_id
        )
        if vals is None:
            return
        from scipy.special import logsumexp

        central = self.dag.edge_to_id[(parent_id, child_id)]
        self.hybrid_marginal_log_likelihoods[central] = float(logsumexp(vals))

    def calculate_hybrid_marginals(self):
        """Reference GPInstance::CalculateHybridMarginals
        (src/gp_instance.cpp:408-417).

        Requests are grouped by their (rootward, sister, rotated, sorted)
        tip-count shape and each group runs as ONE vmapped XLA program with
        an on-device logsumexp — O(distinct shapes) dispatches instead of
        one dispatch plus a host logsumexp per central edge."""
        from ..dag.subsplit_dag import LEFT

        self.populate_plvs()
        dag = self.dag
        self.hybrid_marginal_log_likelihoods = np.full(
            dag.edge_count(), -np.inf
        )
        groups: Dict[Tuple[int, int, int, int], list] = {}
        for parent, side, child, edge in dag.topological_edge_traversal():
            if parent == dag.root_id or child < dag.taxon_count:
                continue
            req = self._hybrid_request(parent, side == LEFT, child)
            rootward, sister, rotated, sorted_ = req
            if not (rootward and sister and rotated and sorted_):
                continue
            shape = (len(rootward), len(sister), len(rotated), len(sorted_))
            central = dag.edge_to_id[(parent, child)]
            groups.setdefault(shape, []).append((central, req))

        plv, ls, q = self.plv, self.ls, self.q
        bl = self.branch_lengths
        inv_prior = jnp.asarray(self.inverted_sbn_prior, dtype=self.dtype)
        node_probs = jnp.asarray(self.unconditional_node_probabilities,
                                 dtype=self.dtype)
        weights = jnp.asarray(self.weights, dtype=self.dtype)

        def stacked(entries_list):
            nodes = jnp.asarray([[n for n, _, _ in ee]
                                 for ee in entries_list])
            types = jnp.asarray([[t for _, t, _ in ee]
                                 for ee in entries_list])
            edges = jnp.asarray([[e for _, _, e in ee]
                                 for ee in entries_list])
            return (plv[types, nodes], ls[types, nodes], bl[edges], edges)

        for shape, reqs in groups.items():
            centrals = np.asarray([c for c, _ in reqs])
            root_pv, root_ls, root_bl, root_e = stacked(
                [r[0] for _, r in reqs])
            sis_pv, sis_ls, sis_bl, sis_e = stacked(
                [r[1] for _, r in reqs])
            rot_pv, rot_ls, rot_bl, rot_e = stacked(
                [r[2] for _, r in reqs])
            sor_pv, sor_ls, sor_bl, sor_e = stacked(
                [r[3] for _, r in reqs])
            g_ids = jnp.asarray([[g for g, _, _ in r[0]] for _, r in reqs])
            vals = _hybrid_batch_program(
                root_pv, root_ls, root_bl, jnp.log(node_probs[g_ids]),
                inv_prior[root_e], sis_pv, sis_ls, sis_bl, q[sis_e],
                bl[jnp.asarray(centrals)], rot_pv, rot_ls, rot_bl,
                q[rot_e], sor_pv, sor_ls, sor_bl, q[sor_e], weights)
            self.hybrid_marginal_log_likelihoods[centrals] = np.asarray(
                vals)


for _name in ("_hybrid_request", "calculate_quartet_hybrid_likelihoods",
              "process_quartet_hybrid_request", "calculate_hybrid_marginals"):
    setattr(GPEngine, _name, getattr(_HybridMixin, _name))
