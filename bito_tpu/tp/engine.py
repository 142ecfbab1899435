"""TP engine: top-pruning scores over the subsplit DAG.

JAX rebuild of the reference TPEngine / TPEvalEngine
(reference: src/tp_engine.cpp:421-1460, src/tp_evaluation_engine.hpp:4-12).
Every DAG edge is scored by its best ("top") tree containing that edge.

Design shift from the reference: instead of maintaining incremental per-edge
PLVs with key-index scratch maps, the engine extracts each edge's top tree
from the choice map and scores ALL top trees in one batched XLA program
(likelihood via treelike/pruning, parsimony via parsimony/sankoff) -- the
batch dimension does the work of the reference's shared-PLV bookkeeping.
Branch-length optimization uses the (outside, below) vectors at each edge's
position in its own top tree, giving the same per-edge 1-D objectives as the
reference's DAG traversal (src/tp_engine.cpp:1423-1427).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.site_pattern import SitePattern
from ..core.tree import Tree
from ..dag.subsplit_dag import SubsplitDAG
from ..gp import optimize
from ..gp.engine import DEFAULT_BL, MAX_LOG_BL, MIN_LOG_BL
from ..models.phylo_model import PhyloModel, PhyloModelSpecification
from ..parsimony.sankoff import SankoffHandler
from ..treelike import pruning
from ..treelike.encode import encode_trees
from ..treelike.engine import TreeLikelihoodEngine
from .choice_map import NO_EDGE, TPChoiceMap


class TPEngine:
    def __init__(self, dag: SubsplitDAG, site_pattern: SitePattern):
        self.dag = dag
        self.site_pattern = site_pattern
        self.choice_map = TPChoiceMap.empty(dag)
        self.branch_lengths = np.full(dag.edge_count(), DEFAULT_BL)
        self.like_engine = TreeLikelihoodEngine(
            site_pattern, PhyloModel(PhyloModelSpecification())
        )
        self.sankoff = SankoffHandler(site_pattern)
        self._top_tree_cache: Optional[List[Tree]] = None

    # -- initialization ---------------------------------------------------
    def initialize_choice_map(self, trees: Sequence[Tree]):
        self.choice_map.initialize_from_trees(trees)
        self._top_tree_cache = None

    def set_branch_lengths_by_taking_first(self, trees: Sequence[Tree]):
        """Reference TPEngine branch init: first observed length per edge.
        Zero-length observations (newick files without branch lengths parse
        as 0) are skipped so edges keep the 0.1 default -- a zero branch
        makes P(t) the identity and conflicting tips give -inf likelihoods."""
        observed: Dict[int, float] = {}
        indexer = self.dag.build_edge_indexer()
        E = self.dag.edge_count()
        for tree in trees:
            if len(observed) == E:
                break  # take-first: later trees cannot add anything
            edge_of = self.choice_map._tree_edge_map(tree.topology,
                                                     indexer)
            for v, e in edge_of.items():
                if v != tree.topology.root and e not in observed:
                    length = float(tree.branch_lengths[v])
                    if length > 0.0:
                        observed[e] = length
        for e, val in observed.items():
            self.branch_lengths[e] = val
        self._top_tree_cache = None

    # -- top trees ---------------------------------------------------------
    def top_tree(self, edge_id: int) -> Tree:
        return self.choice_map.top_tree_topology(edge_id, self.branch_lengths)

    def top_trees(self) -> List[Tree]:
        if self._top_tree_cache is None:
            self._top_tree_cache = [
                self.top_tree(e) for e in range(self.dag.edge_count())
            ]
        return self._top_tree_cache

    # -- scoring ------------------------------------------------------------
    def top_tree_log_likelihoods(self) -> np.ndarray:
        """Per-edge top-tree log likelihoods (reference
        GetTopTreeLogLikelihoodsPerEdge), batched in one XLA program."""
        trees = self.top_trees()
        return np.asarray(self.like_engine.log_likelihoods(trees, {}))

    def top_tree_parsimony_scores(self) -> np.ndarray:
        """Per-edge top-tree parsimony (reference parsimony eval engine)."""
        return self.sankoff.run_sankoff(self.top_trees())

    def score_proposed_tree(self, tree: Tree, use_parsimony: bool = False
                            ) -> float:
        if use_parsimony:
            return float(self.sankoff.run_sankoff([tree])[0])
        return float(np.asarray(self.like_engine.log_likelihoods([tree], {}))[0])

    # -- branch-length optimization ----------------------------------------
    def optimize_branch_lengths(self, tol: float = 1e-3, max_iter: int = 5,
                                quiet: bool = True):
        """Coordinate-ascent sweeps: for each DAG edge, optimize its length
        within its own top tree holding other lengths fixed; all edges'
        1-D objectives run as one batched Brent."""
        for it in range(max_iter):
            old = self.branch_lengths.copy()
            self._optimize_sweep()
            diff = float(np.mean(np.abs(self.branch_lengths - old)))
            if not quiet:
                print(f"TP bl opt iter {it + 1}: mean|dbl| = {diff:.2e}")
            self._top_tree_cache = None
            if diff < tol:
                break

    def _optimize_sweep(self):
        """One sweep = two half-steps over edges grouped by the depth parity
        of their position in their own top tree.  Within a half-step the
        1-D problems are independent (no tree has two adjacent edges in the
        same group), and (outside, below) vectors are refreshed between
        half-steps -- a batched Gauss-Seidel that cannot exhibit the
        neighbor-swap oscillation of a pure Jacobi update."""
        trees = self.top_trees()
        # Target node + its depth within each edge's top tree.
        rows, nodes, depths = [], [], []
        for e, tree in enumerate(trees):
            edge_of = self.choice_map._tree_edge_map(tree.topology)
            node = next(
                (v for v, ee in edge_of.items()
                 if ee == e and v != tree.topology.root), None
            )
            if node is None:
                continue  # rootsplit edges have no optimizable length
            depth = 0
            u = node
            while int(tree.topology.parents[u]) != -1:
                u = int(tree.topology.parents[u])
                depth += 1
            rows.append(e)
            nodes.append(node)
            depths.append(depth)
        depths = np.asarray(depths)
        for parity in (0, 1):
            mask = depths % 2 == parity
            if not mask.any():
                continue
            self._optimize_edges(
                trees,
                [rows[i] for i in np.where(mask)[0]],
                [nodes[i] for i in np.where(mask)[0]],
            )
            # Refresh branch lengths inside the cached trees for the next
            # half-step's (o, p) computation.
            trees = [
                self.choice_map.top_tree_topology(e, self.branch_lengths)
                for e in range(self.dag.edge_count())
            ]
            self._top_tree_cache = trees

    def _optimize_edges(self, trees, rows, nodes):
        engine = self.like_engine
        enc = engine.encode(trees)
        bl = engine.branch_length_matrix(trees, enc)
        eig, rates, props, clock = engine._model_ingredients({}, len(trees))
        P = pruning.transition_matrices_ext(eig, bl, rates, clock)
        buf, logs = pruning.init_partials(
            engine.tip_partials, len(trees), enc.num_slots,
            1, engine.pattern_pad,
        )
        buf, logs = pruning.postorder_pass(
            jnp.asarray(enc.post_ops), P, buf, logs
        )
        outside = pruning.preorder_pass(
            jnp.asarray(enc.pre_ops), P, buf, jnp.asarray(enc.root), eig.pi
        )
        rows_a = jnp.asarray(rows)
        nodes_a = jnp.asarray(nodes)
        o = outside[rows_a, nodes_a, 0]      # [K, A, S]
        p = buf[rows_a, nodes_a, 0]          # [K, A, S]
        w = engine.weights
        # JC69 sufficient statistics:
        # o^T P(t) p = 0.25(1-e)(sum_a o)(sum_b p) + e (o.p), e = exp(-4t/3)
        so = o.sum(axis=1)                    # [K, S]
        sp_ = p.sum(axis=1)
        op = jnp.einsum("kas,kas->ks", o, p)

        def neg_ll(y):
            e_factor = jnp.exp(-4.0 * jnp.exp(y) / 3.0)
            val = (0.25 * (1 - e_factor)[:, None] * so * sp_
                   + e_factor[:, None] * op)
            return -(jnp.log(jnp.where(val > 0, val, 1e-300)) @ w)

        lo = jnp.full(len(rows), MIN_LOG_BL)
        hi = jnp.full(len(rows), MAX_LOG_BL)
        guess = jnp.log(jnp.asarray(
            [float(self.branch_lengths[e]) for e in rows]))
        y_opt = optimize.brent_minimize_batched(neg_ll, guess, lo, hi)
        # Reset-if-worse guard (reference dag_branch_handler.cpp:143-150).
        worse = np.asarray(neg_ll(y_opt) > neg_ll(guess))
        y_opt = jnp.where(worse, guess, y_opt)
        new_bl = np.exp(np.asarray(y_opt))
        for e, v in zip(rows, new_bl):
            self.branch_lengths[e] = v


# ---------------------------------------------------------------------------
# API-compat methods (reference src/pybito.cpp tp_engine bindings)
# ---------------------------------------------------------------------------
def _get_top_tree_with_edge(self: TPEngine, edge_id: int):
    return self.top_tree(edge_id)


def _get_top_tree_topology_with_edge(self: TPEngine, edge_id: int):
    return self.top_tree(edge_id).topology


def _get_top_tree_likelihood_with_edge(self: TPEngine, edge_id: int) -> float:
    return self.score_proposed_tree(self.top_tree(edge_id))


def _get_top_tree_parsimony_with_edge(self: TPEngine, edge_id: int) -> float:
    return self.score_proposed_tree(self.top_tree(edge_id),
                                    use_parsimony=True)


def _get_top_tree_score(self: TPEngine, edge_id: int,
                        use_parsimony: bool = False) -> float:
    if use_parsimony:
        return _get_top_tree_parsimony_with_edge(self, edge_id)
    return _get_top_tree_likelihood_with_edge(self, edge_id)


def _build_map_from_pcsp_to_branch_length(self: TPEngine):
    return dict(zip(self.dag.pretty_edges(), map(float, self.branch_lengths)))


def _build_map_from_pcsp_to_score(self: TPEngine,
                                  use_parsimony: bool = False):
    scores = (self.top_tree_parsimony_scores() if use_parsimony
              else self.top_tree_log_likelihoods())
    return dict(zip(self.dag.pretty_edges(), map(float, scores)))


def _build_map_from_pcsp_to_edge_choice_pcsps(self: TPEngine):
    """PCSP -> {parent, sister, left, right} choice PCSPs (reference
    TPChoiceMap accessors)."""
    pretty = self.dag.pretty_edges()
    cm = self.choice_map
    out = {}
    for e in range(self.dag.edge_count()):
        def name(idx):
            return pretty[idx] if idx >= 0 else None
        out[pretty[e]] = {
            "parent": name(int(cm.parent_choice[e])),
            "sister": name(int(cm.sister_choice[e])),
            "left": name(int(cm.left_choice[e])),
            "right": name(int(cm.right_choice[e])),
        }
    return out


def _build_map_of_tree_id_to_top_topologies(self: TPEngine):
    """tree_source id -> the set of edges whose top tree it supplies."""
    out = {}
    for e in range(self.dag.edge_count()):
        out.setdefault(int(self.choice_map.tree_source[e]), []).append(e)
    return out


def _to_newick_of_top_trees(self: TPEngine) -> str:
    names = self.dag.taxon_names
    return "\n".join(t.newick(names) for t in self.top_trees()) + "\n"


def _to_newick_of_top_topologies(self: TPEngine) -> str:
    names = self.dag.taxon_names
    seen = []
    out = []
    for t in self.top_trees():
        k = t.topology.key()
        if k not in seen:
            seen.append(k)
            out.append(t.topology.newick(names))
    return "\n".join(out) + "\n"


for _name, _fn in [
    ("get_top_tree_with_edge", _get_top_tree_with_edge),
    ("get_top_tree_topology_with_edge", _get_top_tree_topology_with_edge),
    ("get_top_tree_likelihood_with_edge", _get_top_tree_likelihood_with_edge),
    ("get_top_tree_parsimony_with_edge", _get_top_tree_parsimony_with_edge),
    ("get_top_tree_score", _get_top_tree_score),
    ("build_map_from_pcsp_to_branch_length",
     _build_map_from_pcsp_to_branch_length),
    ("build_map_from_pcsp_to_score", _build_map_from_pcsp_to_score),
    ("build_map_from_pcsp_to_edge_choice_pcsps",
     _build_map_from_pcsp_to_edge_choice_pcsps),
    ("build_map_of_tree_id_to_top_topologies",
     _build_map_of_tree_id_to_top_topologies),
    ("to_newick_of_top_trees", _to_newick_of_top_trees),
    ("to_newick_of_top_topologies", _to_newick_of_top_topologies),
]:
    setattr(TPEngine, _name, _fn)


def _get_central_edge_pcsp(self: TPEngine, edge_id: int) -> str:
    return self.dag.pretty_edge(edge_id)


def _set_use_best_edge_map(self: TPEngine, value: bool = True):
    """Reference UseBestEdgeMap toggle: our choice maps always track the
    best (first/highest-priority) tree per edge."""
    self._use_best_edge_map = value


def _get_use_best_edge_map(self: TPEngine) -> bool:
    return getattr(self, "_use_best_edge_map", True)


def _plv_count(self: TPEngine) -> int:
    """Equivalent PLV row count if this were the reference's per-edge PLV
    store (diagnostic)."""
    return 6 * self.dag.node_count_without_dag_root()


def _build_map_from_pcsp_to_pv_values(self: TPEngine):
    """PCSP -> per-edge top-tree likelihood values (the observable analog
    of the reference's PV dumps)."""
    return dict(zip(self.dag.pretty_edges(),
                    map(float, self.top_tree_log_likelihoods())))


def _build_map_from_pcsp_to_pv_hashes(self: TPEngine):
    import hashlib

    return {
        k: hashlib.sha1(repr(v).encode()).hexdigest()[:12]
        for k, v in _build_map_from_pcsp_to_pv_values(self).items()
    }


for _name, _fn in [
    ("get_central_edge_pcsp", _get_central_edge_pcsp),
    ("set_use_best_edge_map", _set_use_best_edge_map),
    ("get_use_best_edge_map", _get_use_best_edge_map),
    ("plv_count", _plv_count),
    ("build_map_from_pcsp_to_pv_values", _build_map_from_pcsp_to_pv_values),
    ("build_map_from_pcsp_to_pv_hashes", _build_map_from_pcsp_to_pv_hashes),
]:
    setattr(TPEngine, _name, _fn)
