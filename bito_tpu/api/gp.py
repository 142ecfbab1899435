"""GPInstance facade mirroring bito.gp_instance.

JAX rebuild of the reference GPInstance
(reference: src/gp_instance.cpp:119-908, bound in src/pybito.cpp:700-990).
The mmap-file constructor argument is accepted and ignored: PLVs live in
device memory, not on disk.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.newick import parse_newick_file, parse_nexus_file, read_fasta
from ..core.site_pattern import SitePattern
from ..core.tree import Topology, Tree, TreeCollection
from ..dag.subsplit_dag import SubsplitDAG, build_dag
from ..gp.engine import GPEngine


class GPInstance:
    def __init__(self, mmap_file_path: str = "", name: str = "gp_instance"):
        self.name = name
        self.tree_collection: Optional[TreeCollection] = None
        self.alignment: Dict[str, str] = {}
        self.dag: Optional[SubsplitDAG] = None
        self.engine: Optional[GPEngine] = None

    # -- io ---------------------------------------------------------------
    def read_newick_file(self, path: str, sort_taxa: bool = False):
        self.tree_collection = parse_newick_file(path, sort_taxa=sort_taxa)

    def read_nexus_file(self, path: str, sort_taxa: bool = False):
        self.tree_collection = parse_nexus_file(path, sort_taxa=sort_taxa)

    def read_fasta_file(self, path: str):
        self.alignment = read_fasta(path)

    def tree_count(self) -> int:
        return len(self.tree_collection) if self.tree_collection else 0

    # -- DAG and engines --------------------------------------------------
    def make_dag(self):
        assert self.tree_collection is not None, "Load trees first"
        self.dag = build_dag(self.tree_collection)

    def get_dag(self) -> SubsplitDAG:
        assert self.dag is not None, "DAG not available. Call make_dag."
        return self.dag

    def make_gp_engine(self, rescaling_threshold: float = 1e-40,
                       use_gradients: bool = False):
        assert self.alignment, "Read a fasta file first"
        if self.dag is None:
            self.make_dag()
        sp = SitePattern(self.alignment, self.tree_collection.taxon_names)
        self.engine = GPEngine(
            sp, self.dag,
            optimization_method=("brent_with_gradients" if use_gradients
                                 else "brent"))

    make_engine = make_gp_engine  # reference alias (older API)

    def get_gp_engine(self) -> GPEngine:
        assert self.engine is not None, "Call make_gp_engine first"
        return self.engine

    # -- workflows --------------------------------------------------------
    def populate_plvs(self):
        self.get_gp_engine().populate_plvs()

    def compute_likelihoods(self):
        self.get_gp_engine().compute_likelihoods()

    def compute_marginal_likelihood(self):
        self.get_gp_engine().compute_likelihoods()

    def estimate_branch_lengths(self, tol: float, max_iter: int,
                                quiet: bool = True):
        return self.get_gp_engine().estimate_branch_lengths(tol, max_iter,
                                                            quiet)

    def estimate_sbn_parameters(self):
        self.get_gp_engine().estimate_sbn_parameters()

    def calculate_hybrid_marginals(self):
        """Reference GPInstance::CalculateHybridMarginals
        (src/gp_instance.cpp:408-417)."""
        self.get_gp_engine().calculate_hybrid_marginals()

    def get_hybrid_marginals(self) -> np.ndarray:
        return self.get_gp_engine().hybrid_marginal_log_likelihoods

    def hot_start_branch_lengths(self):
        self.get_gp_engine().hot_start_branch_lengths(self.tree_collection)

    def take_first_branch_length(self):
        self.get_gp_engine().take_first_branch_length(self.tree_collection)

    # -- accessors --------------------------------------------------------
    def get_branch_lengths(self) -> np.ndarray:
        return np.asarray(self.get_gp_engine().branch_lengths)

    def set_branch_lengths(self, bl: np.ndarray):
        import jax.numpy as jnp

        eng = self.get_gp_engine()
        eng.branch_lengths = jnp.asarray(bl, dtype=eng.dtype)

    def get_sbn_parameters(self) -> np.ndarray:
        return np.asarray(self.get_gp_engine().q)

    def get_log_marginal_likelihood(self) -> float:
        return self.get_gp_engine().log_marginal_likelihood()

    def get_per_gpcsp_log_likelihoods(self) -> np.ndarray:
        return self.get_gp_engine().per_gpcsp_log_likelihoods()

    def pretty_indexed_per_gpcsp_log_likelihoods(self):
        return list(zip(self.dag.pretty_edges(),
                        self.get_per_gpcsp_log_likelihoods()))

    def pretty_indexed_per_gpcsp_components_of_full_log_marginal(self):
        return list(zip(
            self.dag.pretty_edges(),
            self.get_gp_engine().per_gpcsp_components_of_full_log_marginal(),
        ))

    def build_edge_idx_to_pcsp_map(self) -> Dict[int, str]:
        return {e: self.dag.pretty_edge(e)
                for e in range(self.dag.edge_count())}

    # -- CSV exports (reference src/gp_instance.hpp:133-140) -------------
    def branch_lengths_to_csv(self, path: str):
        import csv as _csv

        with open(path, "w", newline="") as f:
            w = _csv.writer(f)
            for key, val in zip(self.dag.pretty_edges(),
                                self.get_branch_lengths()):
                w.writerow([key, repr(float(val))])

    def per_gpcsp_log_likelihoods_to_csv(self, path: str):
        import csv as _csv

        with open(path, "w", newline="") as f:
            w = _csv.writer(f)
            for key, val in zip(self.dag.pretty_edges(),
                                self.get_per_gpcsp_log_likelihoods()):
                w.writerow([key, repr(float(val))])

    def sbn_parameters_to_csv(self, path: str):
        import csv as _csv

        with open(path, "w", newline="") as f:
            w = _csv.writer(f)
            for key, val in zip(self.dag.pretty_edges(),
                                self.get_sbn_parameters()):
                w.writerow([key, repr(float(val))])

    def export_trees_with_gp_branch_lengths(self, path: str):
        """Reference CurrentlyLoadedTreesWithGPBranchLengths -> newick."""
        coll = self.currently_loaded_trees_with_gp_branch_lengths()
        with open(path, "w") as f:
            f.write(coll.newick())

    def export_all_generated_trees(self, path: str):
        coll = self.generate_complete_rooted_tree_collection()
        with open(path, "w") as f:
            f.write(coll.newick())

    def subsplit_dag_to_dot(self, path: str, edge_labels: bool = False):
        with open(path, "w") as f:
            f.write(self.get_dag().to_dot(edge_labels))

    def dag_summary_statistics(self) -> Dict[str, int]:
        return {
            "node_count": self.get_dag().node_count_without_dag_root(),
            "edge_count": self.get_dag().edge_count(),
            "taxon_count": self.get_dag().taxon_count,
            "topology_count": int(self.get_dag().topology_count()),
        }

    def generate_complete_rooted_tree_collection(self) -> TreeCollection:
        """All topologies in the DAG, with the engine's GP branch lengths
        (reference GenerateCompleteRootedTreeCollection)."""
        topologies = self.get_dag().generate_all_topologies()
        return self._trees_with_gp_branch_lengths(topologies)

    def currently_loaded_trees_with_gp_branch_lengths(self) -> TreeCollection:
        topologies = [t.topology for t in self.tree_collection.trees]
        return self._trees_with_gp_branch_lengths(topologies)

    def _trees_with_gp_branch_lengths(self, topologies) -> TreeCollection:
        from ..core.bitset import PCSP, Subsplit

        indexer = self.dag.build_edge_indexer()
        bl_vec = self.get_branch_lengths()
        trees = []
        for topo in topologies:
            n = topo.num_taxa
            cl = topo.clades()
            ch = topo.children()
            ss = {v: Subsplit.leaf(v, n) for v in range(n)}
            for v in range(n, topo.num_nodes):
                kids = ch[v]
                ss[v] = Subsplit.of_pair(cl[kids[0]], cl[kids[1]], n)
            bl = np.zeros(topo.num_nodes)
            for v in range(topo.num_nodes - 1):
                parent = int(topo.parents[v])
                pcsp = PCSP.of_parent_child(ss[parent], ss[v]).to_string()
                if pcsp in indexer:
                    bl[v] = bl_vec[indexer[pcsp]]
            trees.append(Tree(topo, bl))
        return TreeCollection(trees, list(self.tree_collection.taxon_names))


def gp_instance(mmap_file_path: str = "") -> GPInstance:
    return GPInstance(mmap_file_path)


# ---------------------------------------------------------------------------
# API-compat additions (reference src/pybito.cpp gp_instance bindings)
# ---------------------------------------------------------------------------
def _make_tp_engine(self: GPInstance):
    from ..tp.engine import TPEngine

    if self.dag is None:
        self.make_dag()
    sp = SitePattern(self.alignment, self.tree_collection.taxon_names)
    self.tp_engine = TPEngine(self.get_dag(), sp)
    return self.tp_engine


def _get_tp_engine(self: GPInstance):
    assert getattr(self, "tp_engine", None) is not None, (
        "Call make_tp_engine first"
    )
    return self.tp_engine


def _tp_engine_set_choice_map_by_taking_first(self: GPInstance):
    self.get_tp_engine().initialize_choice_map(self.tree_collection.trees)


def _tp_engine_set_branch_lengths_by_taking_first(self: GPInstance):
    self.get_tp_engine().set_branch_lengths_by_taking_first(
        self.tree_collection.trees
    )


def _make_nni_engine(self: GPInstance, scoring: str = "tp_likelihood"):
    from ..nni.engine import GPScoredNNIEngine, NNIEngine
    from ..nni.golden import FaithfulNNIEngine

    if self.dag is None:
        self.make_dag()
    sp = SitePattern(self.alignment, self.tree_collection.taxon_names)
    if scoring == "gp_likelihood":
        self.nni_engine = GPScoredNNIEngine(
            self.get_dag(), sp, self.tree_collection.trees
        )
    elif scoring == "tp_likelihood":
        # The trajectory-faithful per-edge-PV engine: incremental DAG
        # growth with PV carry-over, no rebuild/recompile per acceptance
        # (reference NNIEvalEngineViaTP + GPEngine grow/reindex,
        # src/gp_engine.cpp:64-209).
        self.nni_engine = FaithfulNNIEngine(
            self.get_dag(), sp, self.tree_collection.trees
        )
    else:
        self.nni_engine = NNIEngine(
            self.get_dag(), sp, self.tree_collection.trees, scoring=scoring
        )
    return self.nni_engine


def _get_nni_engine(self: GPInstance):
    assert getattr(self, "nni_engine", None) is not None, (
        "Call make_nni_engine first"
    )
    return self.nni_engine


def _make_likelihood_tree_engine(self: GPInstance):
    """Per-tree classical likelihood engine (reference
    likelihood_tree_engine, src/pybito.cpp)."""
    from ..models.phylo_model import PhyloModel, PhyloModelSpecification
    from ..treelike.engine import TreeLikelihoodEngine

    sp = SitePattern(self.alignment, self.tree_collection.taxon_names)
    self.likelihood_tree_engine = TreeLikelihoodEngine(
        sp, PhyloModel(PhyloModelSpecification())
    )
    return self.likelihood_tree_engine


def _get_likelihood_tree_engine(self: GPInstance):
    if getattr(self, "likelihood_tree_engine", None) is None:
        _make_likelihood_tree_engine(self)
    return self.likelihood_tree_engine


def _make_parsimony_tree_engine(self: GPInstance):
    from ..parsimony.sankoff import SankoffHandler

    sp = SitePattern(self.alignment, self.tree_collection.taxon_names)
    self.parsimony_tree_engine = SankoffHandler(sp)
    return self.parsimony_tree_engine


def _get_parsimony_tree_engine(self: GPInstance):
    if getattr(self, "parsimony_tree_engine", None) is None:
        _make_parsimony_tree_engine(self)
    return self.parsimony_tree_engine


def _compute_tree_likelihood(self: GPInstance, tree=None) -> np.ndarray:
    """Classical likelihoods of the loaded trees (or a given tree) with GP
    branch lengths (reference compute_tree_likelihood)."""
    engine = _get_likelihood_tree_engine(self)
    trees = ([tree] if tree is not None
             else self.currently_loaded_trees_with_gp_branch_lengths().trees)
    return np.asarray(engine.log_likelihoods(trees, {}))


def _compute_tree_parsimony(self: GPInstance, tree=None) -> np.ndarray:
    engine = _get_parsimony_tree_engine(self)
    trees = ([tree] if tree is not None
             else self.tree_collection.trees)
    return engine.run_sankoff(trees)


def _sbn_prior_to_csv(self: GPInstance, path: str):
    import csv as _csv

    eng = self.get_gp_engine()
    with open(path, "w", newline="") as f:
        w = _csv.writer(f)
        for key, val in zip(self.dag.pretty_edges(), eng.sbn_prior):
            w.writerow([key, repr(float(val))])


def _get_perpcsp_llh_surface(self: GPInstance, edge_id: int,
                             scale_min: float = 0.01,
                             scale_max: float = 10.0,
                             steps: int = 41) -> np.ndarray:
    """Per-PCSP log-likelihood surface over scaled branch lengths
    (reference GetPerGPCSPLogLikelihoodSurfaces,
    src/gp_instance.hpp:105-116).  Returns [steps, 2]: (bl, llh)."""
    import jax.numpy as jnp

    eng = self.get_gp_engine()
    base = float(np.asarray(eng.branch_lengths)[edge_id])
    scales = np.exp(np.linspace(np.log(scale_min), np.log(scale_max), steps))
    out = np.zeros((steps, 2))
    saved = eng.branch_lengths
    for i, s in enumerate(scales):
        bl = np.asarray(saved).copy()
        bl[edge_id] = base * s
        eng.branch_lengths = jnp.asarray(bl, dtype=eng.dtype)
        eng.populate_plvs()
        eng.compute_likelihoods()
        out[i] = (base * s, eng.per_gpcsp_log_likelihoods()[edge_id])
    eng.branch_lengths = saved
    eng.populate_plvs()
    eng.compute_likelihoods()
    return out


def _per_gpcsp_llh_surfaces_to_csv(self: GPInstance, path: str,
                                   steps: int = 21):
    import csv as _csv

    with open(path, "w", newline="") as f:
        w = _csv.writer(f)
        for e in range(self.dag.edge_count()):
            surf = _get_perpcsp_llh_surface(self, e, steps=steps)
            for bl, llh in surf:
                w.writerow([self.dag.pretty_edge(e), repr(bl), repr(llh)])


def _perturb_and_track_optimization_values(self: GPInstance, edge_id: int,
                                           perturbation: float = 0.1,
                                           max_iter: int = 10):
    """Perturb one branch length and track re-optimization (reference
    PerturbAndTrackValuesFromOptimization diagnostics)."""
    import jax.numpy as jnp

    eng = self.get_gp_engine()
    bl = np.asarray(eng.branch_lengths).copy()
    bl[edge_id] = bl[edge_id] * (1.0 + perturbation)
    eng.branch_lengths = jnp.asarray(bl, dtype=eng.dtype)
    trace = []
    for _ in range(max_iter):
        eng.populate_plvs()
        eng.compute_likelihoods()
        trace.append({
            "branch_length": float(np.asarray(eng.branch_lengths)[edge_id]),
            "marginal": eng.log_marginal_likelihood(),
        })
        eng.optimize_branch_lengths_once()
    return trace


def _print_dag(self: GPInstance):
    dag = self.get_dag()
    for i, ss in enumerate(dag.nodes):
        print(f"node {i}: {ss.pretty()}")
    for e in range(dag.edge_count()):
        print(f"edge {e}: {dag.pretty_edge(e)}")


def _print_status(self: GPInstance):
    print(f"{self.name}: trees={self.tree_count()} "
          f"dag={'yes' if self.dag else 'no'} "
          f"engine={'yes' if self.engine else 'no'}")


def _set_rescaling(self: GPInstance, use_rescaling: bool):
    # This engine's per-site log-scale rescaling is exact and structural
    # (folded into every wavefront op), so enabling it is already true;
    # disabling it has no faithful equivalent and silently ignoring the
    # request would misrepresent the computation — refuse loudly.
    if not use_rescaling:
        raise NotImplementedError(
            "bito_tpu's GP engine always applies exact per-site rescaling; "
            "running without rescaling is not supported")
    self._rescaling = True


def _use_gradient_optimization(self: GPInstance, use_gradients: bool = True):
    """Reference GPInstance::UseGradientOptimization
    (src/gp_instance.cpp:385-387): Brent vs Brent-with-gradient-fallback."""
    self._use_gradients = use_gradients
    if self.engine is not None:
        self.engine.use_gradient_optimization(use_gradients)


def _set_optimization_method(self: GPInstance, method: str):
    """Reference GPInstance::SetOptimizationMethod: full method selection
    (brent / brent_with_gradients / gradient_ascent /
    log_space_gradient_ascent / newton)."""
    self.get_gp_engine().set_optimization_method(method)


def _read_newick_file_gz(self: GPInstance, path: str):
    self.read_newick_file(path)  # gzip handled transparently by _open_text


def _read_nexus_file_gz(self: GPInstance, path: str):
    self.read_nexus_file(path)


for _name, _fn in [
    ("make_tp_engine", _make_tp_engine),
    ("get_tp_engine", _get_tp_engine),
    ("tp_engine_set_choice_map_by_taking_first",
     _tp_engine_set_choice_map_by_taking_first),
    ("tp_engine_set_branch_lengths_by_taking_first",
     _tp_engine_set_branch_lengths_by_taking_first),
    ("make_nni_engine", _make_nni_engine),
    ("get_nni_engine", _get_nni_engine),
    ("make_likelihood_tree_engine", _make_likelihood_tree_engine),
    ("get_likelihood_tree_engine", _get_likelihood_tree_engine),
    ("make_parsimony_tree_engine", _make_parsimony_tree_engine),
    ("get_parsimony_tree_engine", _get_parsimony_tree_engine),
    ("compute_tree_likelihood", _compute_tree_likelihood),
    ("compute_tree_parsimony", _compute_tree_parsimony),
    ("compute_likelihood", _compute_tree_likelihood),
    ("compute_parsimony", _compute_tree_parsimony),
    ("sbn_prior_to_csv", _sbn_prior_to_csv),
    ("get_perpcsp_llh_surface", _get_perpcsp_llh_surface),
    ("per_gpcsp_llh_surfaces_to_csv", _per_gpcsp_llh_surfaces_to_csv),
    ("per_gpcsp_llhs_to_csv", GPInstance.per_gpcsp_log_likelihoods_to_csv),
    ("get_per_pcsp_log_likelihoods", GPInstance.get_per_gpcsp_log_likelihoods),
    ("perturb_and_track_optimization_values",
     _perturb_and_track_optimization_values),
    ("print_dag", _print_dag),
    ("print_status", _print_status),
    ("set_rescaling", _set_rescaling),
    ("use_gradient_optimization", _use_gradient_optimization),
    ("set_optimization_method", _set_optimization_method),
    ("read_newick_file_gz", _read_newick_file_gz),
    ("read_nexus_file_gz", _read_nexus_file_gz),
]:
    setattr(GPInstance, _name, _fn)
