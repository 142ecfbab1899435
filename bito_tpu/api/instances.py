"""Instance facades mirroring bito's Python API surface.

JAX rebuild of GenericSBNInstance / UnrootedSBNInstance /
RootedSBNInstance (reference: src/generic_sbn_instance.hpp:1-502,
src/unrooted_sbn_instance.{hpp,cpp}, src/rooted_sbn_instance.{hpp,cpp},
bound in src/pybito.cpp:91-700).  A bito user's workflow maps one-to-one:

    inst = bito_tpu.unrooted_instance("name")
    inst.read_newick_file(path); inst.read_fasta_file(path)
    inst.process_loaded_trees(); inst.train_simple_average()
    inst.sample_trees(k)
    inst.prepare_for_phylo_likelihood(spec, thread_count)
    inst.log_likelihoods(); inst.phylo_gradients()
    inst.topology_gradients(log_f, use_vimco)

The "engine" underneath is the batched XLA program (treelike/pruning.py), so
thread_count and beagle flags are accepted-and-ignored.
"""
from __future__ import annotations

import csv as _csv
from typing import Dict, List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..core.newick import (
    parse_newick_file,
    parse_newick_text,
    parse_nexus_file,
    read_fasta,
)
from ..core.site_pattern import SitePattern
from ..core.tree import Topology, Tree, TreeCollection
from ..models.phylo_model import PhyloModel, PhyloModelSpecification
from ..sbn import device as sbn_device
from ..sbn import gradients as sbn_gradients
from ..sbn import probability as sbn_probability
from ..sbn.psp import PSPIndexer
from ..sbn.sampler import TopologySampler
from ..sbn.support import SBNSupport, build_support
from ..treelike.engine import TreeLikelihoodEngine
from ..treelike import phylo_flags as phylo_flags_mod

DOUBLE_MINIMUM = np.finfo(np.float64).min


def _resolve_sbn_backend(backend: str, f32_ok: bool = False) -> str:
    """The device (XLA) SBN kernels are calibrated for float64: EM golden
    parity is pinned at 1e-12 and the monotonicity assert assumes f64 score
    noise.  Without jax_enable_x64 they would run in float32, so refuse —
    except for callers that declare f32 acceptable (`f32_ok`): VIMCO/ELBO
    topology gradients are stochastic estimates fed to SGD, where f32
    sampling noise dwarfs arithmetic noise."""
    if backend == "device" and not f32_ok and not jax.config.jax_enable_x64:
        raise ValueError(
            "the device SBN backend needs float64: enable it with "
            "jax.config.update('jax_enable_x64', True), or pass "
            "backend='numpy' to run the host implementation")
    return backend


class PhyloGradient:
    """Mirror of bito.PhyloGradient (src/phylo_gradient.hpp): a log
    likelihood plus a string->vector gradient map."""

    def __init__(self, log_likelihood: float, gradient: Dict[str, np.ndarray]):
        self.log_likelihood_ = float(log_likelihood)
        self.gradient_ = gradient

    def log_likelihood(self) -> float:
        return self.log_likelihood_

    @property
    def gradient(self) -> Dict[str, np.ndarray]:
        return self.gradient_


class GenericSBNInstance:
    rooted: bool = False

    def __init__(self, name: str = "instance"):
        self.name = name
        self.tree_collection: Optional[TreeCollection] = None
        self.alignment: Dict[str, str] = {}
        self.sbn_support: Optional[SBNSupport] = None
        self.sbn_parameters: np.ndarray = np.zeros(0)
        self.psp_indexer: Optional[PSPIndexer] = None
        self.engine: Optional[TreeLikelihoodEngine] = None
        self.phylo_model: Optional[PhyloModel] = None
        self.phylo_model_params: Optional[np.ndarray] = None
        self.rescaling = True
        self.rng = np.random.default_rng(0)
        self._topology_counter = None
        self.phylo_flags: Optional[phylo_flags_mod.PhyloFlags] = None

    # -- io -------------------------------------------------------------
    def read_newick_file(self, path: str, sort_taxa: bool = False):
        self.tree_collection = parse_newick_file(path, sort_taxa=sort_taxa)

    def read_nexus_file(self, path: str, sort_taxa: bool = False):
        self.tree_collection = parse_nexus_file(path, sort_taxa=sort_taxa)

    def read_fasta_file(self, path: str):
        self.alignment = read_fasta(path)
        self._invalidate_engine()

    def read_newick_file_gz(self, path: str, sort_taxa: bool = False):
        self.read_newick_file(path, sort_taxa)  # gzip is transparent

    def read_nexus_file_gz(self, path: str, sort_taxa: bool = False):
        self.read_nexus_file(path, sort_taxa)

    def tree_count(self) -> int:
        return len(self.tree_collection) if self.tree_collection else 0

    def taxon_names(self) -> List[str]:
        return list(self.tree_collection.taxon_names)

    def print_status(self):
        """Reference GenericSBNInstance::PrintStatus."""
        print(f"{self.name}: {self.tree_count()} trees, "
              f"support size {self.sbn_support.size() if self.sbn_support else 0}")

    def resize_phylo_model_params(self):
        """Reference ResizePhyloModelParams: grow/shrink the per-tree model
        parameter matrix to the current tree count."""
        if self.phylo_model is None:
            return
        count = self.tree_count()
        base = (self.phylo_model_params[0]
                if self.phylo_model_params is not None
                and len(self.phylo_model_params)
                else self.phylo_model.default_param_vector())
        self.phylo_model_params = np.tile(base, (max(count, 1), 1))

    def set_rescaling(self, use_rescaling: bool):
        """Rescaling here is exact per-site scale bookkeeping, always on;
        accepted for API compatibility (reference SetRescaling)."""
        self.rescaling = use_rescaling

    # -- SBN support and training ---------------------------------------
    def process_loaded_trees(self):
        assert self.tree_collection is not None, "Load some trees first"
        if not self.rooted:
            # Unrooted instances operate on trifurcating-root trees (the
            # reference asserts this; we deroot bifurcating-rooted input,
            # fusing the two root edges).
            self.tree_collection.trees = [
                t.deroot() for t in self.tree_collection.trees
            ]
        counter = {}
        topo_by_key = {}
        for t in self.tree_collection.trees:
            k = t.topology.key()
            counter[k] = counter.get(k, 0) + 1
            topo_by_key[k] = t.topology
        self._topology_counter = {
            topo_by_key[k]: c for k, c in counter.items()
        }
        self.sbn_support = build_support(
            self._topology_counter, self.tree_collection.taxon_names,
            rooted=self.rooted,
        )
        self.sbn_parameters = np.ones(self.sbn_support.size())
        self.psp_indexer = PSPIndexer(self.sbn_support)

    def split_counters(self):
        """[rootsplit_support, subsplit_support] keyed by pretty strings
        (reference inst.split_counters(), src/pybito.cpp)."""
        from ..sbn import maps as sbn_maps

        counters = (
            sbn_maps.rooted_counters(self._topology_counter)
            if self.rooted
            else sbn_maps.unrooted_counters(self._topology_counter)
        )
        rs_counter, pcsp_counter, rs_bits, pcsp_bits = counters
        n = len(self.tree_collection.taxon_names)
        # Raw bitset-string keys, like the reference's ToString() maps
        # (src/sbn_maps.cpp StringPCSPMapOf): parent = 2n chars as stored in
        # the PCSP (sister|focal order), child = the stored n-char min clade.
        rootsplit = dict(rs_counter)
        subsplit: Dict[str, Dict[str, int]] = {}
        for k, v in pcsp_counter.items():
            parent = k[: 2 * n]
            child = k[2 * n:]
            subsplit.setdefault(parent, {})[child] = v
        return [rootsplit, subsplit]

    def make_indexer_representations(self):
        # Memoized per tree set: a VBPI step asks for the representations of
        # the same sampled trees several times (SBN probabilities, topology
        # gradients), and each computation walks every virtual rooting.
        # Hold strong references to the keyed objects alongside the id key:
        # without them CPython may free a replaced tree set and recycle its
        # ids for new topologies, silently matching a stale entry.
        refs = (self.sbn_support,) + tuple(
            t.topology for t in self.tree_collection.trees)
        key = tuple(id(r) for r in refs)
        cached = getattr(self, "_indexer_reps_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        native = (None if self.rooted
                  else self.sbn_support._native_pcsp_indexer())
        if native is not None:
            # One native call for the whole tree set (the per-tree loop
            # paid ctypes marshaling 20x per VBPI step; round 5).
            sentinel = len(self.sbn_support.indexer)
            reps = native.unrooted_representations(
                [np.asarray(t.topology.parents, dtype=np.int32)
                 for t in self.tree_collection.trees], sentinel)
        else:
            reps = [
                self.sbn_support.indexer_representation_of(t.topology)
                for t in self.tree_collection.trees
            ]
        self._indexer_reps_cache = (key, reps, refs)
        return reps

    def make_psp_indexer_representations(self):
        return [
            self.psp_indexer.representation_of(t.topology)
            for t in self.tree_collection.trees
        ]

    def _representation_counter(self):
        reps, counts = [], []
        for topo, count in self._topology_counter.items():
            reps.append(self.sbn_support.indexer_representation_of(topo))
            counts.append(count)
        return reps, counts

    def train_simple_average(self):
        reps, counts = self._representation_counter()
        self.sbn_parameters = sbn_probability.simple_average(
            self.sbn_support, reps, counts
        )

    def calculate_sbn_probabilities(self) -> np.ndarray:
        norm = sbn_probability.normalize_in_log(
            self.sbn_parameters, self.sbn_support
        )
        return sbn_probability.probabilities_of_collection(
            self.sbn_support, norm, self.make_indexer_representations()
        )

    def normalized_sbn_parameters(self) -> np.ndarray:
        return np.exp(
            sbn_probability.normalize_in_log(self.sbn_parameters,
                                             self.sbn_support)
        )

    def pretty_indexer(self) -> List[str]:
        return self.sbn_support.pretty_indexer()

    def pretty_indexed_sbn_parameters(self):
        return list(zip(self.pretty_indexer(),
                        self.normalized_sbn_parameters()))

    def sbn_parameters_to_csv(self, path: str):
        with open(path, "w", newline="") as f:
            w = _csv.writer(f)
            for key, val in self.pretty_indexed_sbn_parameters():
                w.writerow([key, repr(float(val))])

    def read_sbn_parameters_from_csv(self, path: str):
        with open(path, newline="") as f:
            pretty = {row[0]: float(row[1]) for row in _csv.reader(f) if row}
        self.set_sbn_parameters(pretty)

    def set_sbn_parameters(self, pretty_sbn_parameters: Dict[str, float],
                           warn_missing: bool = True):
        """Reference GenericSBNInstance::SetSBNParameters
        (src/generic_sbn_instance.hpp:115-148): linear-space input."""
        missing = 0
        out = np.empty(self.sbn_support.size())
        for i, key in enumerate(self.pretty_indexer()):
            v = pretty_sbn_parameters.get(key)
            if v is None:
                out[i] = DOUBLE_MINIMUM
                missing += 1
            elif v > 0:
                out[i] = np.log(v)
            elif v == 0:
                out[i] = DOUBLE_MINIMUM
            else:
                raise ValueError(
                    "Negative probability in set_sbn_parameters; expected "
                    "linear (not log) space"
                )
        if warn_missing and missing:
            print(f"Warning: {missing} SBN parameters in support but not "
                  f"specified; set to log-zero sentinel.")
        self.sbn_parameters = out

    # -- sampling --------------------------------------------------------
    def sample_topology(self) -> Topology:
        sampler = TopologySampler(self.sbn_support, self.rng)
        probs = self.normalized_sbn_parameters()
        return sampler.sample(probs, rooted=self.rooted)

    def sample_trees(self, count: int):
        assert self.sbn_support is not None
        sampler = TopologySampler(self.sbn_support, self.rng)
        probs = self.normalized_sbn_parameters()
        trees = []
        for _ in range(count):
            topo = sampler.sample(probs, rooted=self.rooted)
            trees.append(Tree(topo, np.zeros(topo.num_nodes)))
        self.tree_collection = TreeCollection(
            trees, self.tree_collection.taxon_names
        )

    # -- likelihood engine ----------------------------------------------
    def _invalidate_engine(self):
        self.engine = None

    # -- PhyloFlags (reference src/pybito.cpp:577-599) -------------------
    def init_phylo_flags(self):
        self.phylo_flags = phylo_flags_mod.PhyloFlags()

    def set_phylo_flag(self, flag_name: str, set_to: bool = True,
                       set_value: float = 1.0):
        if self.phylo_flags is None:
            self.init_phylo_flags()
        self.phylo_flags.set(flag_name, set_to, set_value)

    def set_phylo_defaults(self, use_defaults: bool = True):
        if self.phylo_flags is None:
            self.init_phylo_flags()
        self.phylo_flags.use_defaults = use_defaults

    def clear_phylo_flags(self):
        self.phylo_flags = None

    def _resolve_flags(self, flags, use_defaults: bool = True):
        return phylo_flags_mod.resolve(flags, self.phylo_flags, use_defaults)

    def prepare_for_phylo_likelihood(
        self, specification: PhyloModelSpecification, thread_count: int = 1,
        beagle_flags: Sequence[int] = (), use_tip_states: bool = True,
        tree_count_option: Optional[int] = None,
    ):
        assert self.alignment, "Read a fasta file first"
        assert self.tree_collection is not None, "Load trees first"
        self.phylo_model = PhyloModel(specification)
        sp = SitePattern(self.alignment, self.tree_collection.taxon_names)
        self.engine = TreeLikelihoodEngine(sp, self.phylo_model)
        count = tree_count_option or len(self.tree_collection)
        base = self.phylo_model.default_param_vector()
        self.phylo_model_params = np.tile(base, (count, 1))

    def get_phylo_model_params(self) -> np.ndarray:
        return self.phylo_model_params

    def get_phylo_model_param_block_map(self) -> Dict[str, np.ndarray]:
        """Zero-copy views into the per-tree parameter matrix (reference
        GetPhyloModelParamBlockMap)."""
        out = {}
        for key, (start, length) in self.phylo_model.blocks.items():
            out[key] = self.phylo_model_params[:, start:start + length]
        return out

    def _params_dict(self):
        count = len(self.tree_collection)
        mat = self.phylo_model_params
        if mat.shape[0] != count:
            mat = np.tile(mat[:1], (count, 1))
        d = {}
        for key, (start, length) in self.phylo_model.blocks.items():
            d[key] = jnp.asarray(mat[:, start:start + length])
        return d

    def log_likelihoods(self, phylo_flags=None, use_defaults: bool = True
                        ) -> np.ndarray:
        assert self.engine is not None, "prepare_for_phylo_likelihood first"
        self._resolve_flags(phylo_flags, use_defaults)  # validates names
        return np.asarray(
            self.engine.log_likelihoods(
                self.tree_collection.trees, self._params_dict()
            )
        )

    def phylo_gradients(self, phylo_flags=None, use_defaults: bool = True
                        ) -> List[PhyloGradient]:
        assert self.engine is not None, "prepare_for_phylo_likelihood first"
        self._resolve_flags(phylo_flags, use_defaults)
        trees = self.tree_collection.trees
        ll, grads = self.engine.ll_and_branch_gradients(
            trees, self._params_dict()
        )
        # One device-to-host transfer for both outputs.
        ll, grads = jax.device_get((ll, grads))
        ll = np.asarray(ll)
        grads = np.asarray(grads)
        out = []
        for b, t in enumerate(trees):
            n_edges = t.topology.num_nodes
            out.append(
                PhyloGradient(
                    ll[b],
                    {"branch_lengths": grads[b, :n_edges].copy()},
                )
            )
        return out


class UnrootedSBNInstance(GenericSBNInstance):
    rooted = False

    def train_expectation_maximization(self, alpha: float, max_iter: int,
                                       score_epsilon: float = 0.0,
                                       backend: str = "device"):
        """SBN-EM.  backend="device" runs the XLA while-loop kernel
        (sbn/device.py); backend="numpy" runs the vectorized host loop
        (golden parity between the two is ~1e-11 over 23 DS1 iterations)."""
        reps, counts = self._representation_counter()
        backend = _resolve_sbn_backend(backend)
        em = (sbn_device.expectation_maximization if backend == "device"
              else sbn_probability.expectation_maximization)
        self.sbn_parameters, score = em(
            self.sbn_support, reps, counts, alpha, max_iter, score_epsilon
        )
        return score

    def topology_gradients(self, log_f: np.ndarray, use_vimco: bool = True,
                           backend: str = "device") -> np.ndarray:
        reps = self.make_indexer_representations()
        backend = _resolve_sbn_backend(backend, f32_ok=True)
        grads = (sbn_device.topology_gradients if backend == "device"
                 else sbn_gradients.topology_gradients)
        return grads(
            self.sbn_support, self.sbn_parameters, reps, np.asarray(log_f),
            use_vimco=use_vimco,
        )

    def split_lengths(self):
        result = [[] for _ in range(self.psp_indexer.after_rootsplits_index)]
        for t in self.tree_collection.trees:
            split_idx = self.psp_indexer.representation_of(t.topology)[0]
            for edge, idx in enumerate(split_idx):
                result[idx].append(float(t.branch_lengths[edge]))
        return result


class RootedSBNInstance(GenericSBNInstance):
    """Rooted/time-tree instance (reference src/rooted_sbn_instance.{hpp,cpp},
    bound in src/pybito.cpp:240-430): tip dates, height/ratio gradient
    transforms, and model-parameter gradients via autodiff (replacing the
    reference's central finite differences, src/fat_beagle.cpp:422-508)."""

    rooted = True

    def __init__(self, name: str = "instance"):
        super().__init__(name)
        self.tree_states = None  # List[RootedTreeState]

    # -- tip dates -------------------------------------------------------
    def _init_states(self, dates_by_taxon: Dict[str, float],
                     initialize_time_trees: bool):
        from ..treelike import rooted as rooted_mod

        names = self.tree_collection.taxon_names
        max_date = max(dates_by_taxon.values())
        # Reference semantics: date := max_date - date (most recent tip at 0).
        dates = [max_date - dates_by_taxon[t] for t in names]
        self.tree_states = []
        for tree in self.tree_collection.trees:
            state = rooted_mod.set_tip_dates(tree, dates)
            if initialize_time_trees:
                rooted_mod.initialize_time_tree_using_branch_lengths(state)
            self.tree_states.append(state)

    def parse_dates_from_taxon_names(self, initialize_time_trees: bool = False):
        import re

        pat = re.compile(r"^.+_(\d*\.?\d+(?:[eE][-+]?\d+)?)$")
        dates = {}
        for t in self.tree_collection.taxon_names:
            m = pat.match(t)
            assert m, f"Taxon {t!r} has no parseable date suffix"
            dates[t] = float(m.group(1))
        self._init_states(dates, initialize_time_trees)

    def set_dates_to_be_constant(self, initialize_time_trees: bool = False):
        self._init_states(
            {t: 0.0 for t in self.tree_collection.taxon_names},
            initialize_time_trees,
        )

    def parse_dates_from_csv(self, csv_path: str,
                             initialize_time_trees: bool = False):
        dates = {}
        with open(csv_path, newline="") as f:
            for row in _csv.reader(f):
                if row:
                    dates[row[0].strip('"')] = float(row[1])
        self._init_states(dates, initialize_time_trees)

    # -- likelihood with substitution-length branches --------------------
    def _subst_branch_lengths(self):
        """Per-tree substitution lengths rate_i * time_i as the engine's
        branch-length input (reference FatBeagle rooted semantics)."""
        import jax.numpy as jnp

        enc = self.engine.encode(self.tree_collection.trees)
        bl = np.zeros((len(self.tree_collection.trees), enc.num_slots))
        for i, tree in enumerate(self.tree_collection.trees):
            N = tree.topology.num_nodes
            rates = (self.tree_states[i].rates if self.tree_states
                     else np.ones(N - 1))
            bl[i, : N - 1] = tree.branch_lengths[: N - 1] * rates
        return jnp.asarray(bl, dtype=self.engine.dtype)

    def log_likelihoods(self, phylo_flags=None, use_defaults: bool = True,
                        include_log_det_jacobian: Optional[bool] = None
                        ) -> np.ndarray:
        """Rooted log likelihoods; by default includes the log-det Jacobian
        of the height transform (reference LogLikelihoodFlagOptions default;
        disable via the INCLUDE_LOG_DET_JACOBIAN_LIKELIHOOD flag)."""
        from ..treelike import rooted as rooted_mod

        assert self.engine is not None, "prepare_for_phylo_likelihood first"
        resolved = self._resolve_flags(phylo_flags, use_defaults)
        if include_log_det_jacobian is None:
            include_log_det_jacobian = resolved.is_set(
                phylo_flags_mod.INCLUDE_LOG_DET_JACOBIAN_LIKELIHOOD
            )
        ll = np.asarray(
            self.engine.log_likelihoods(
                self.tree_collection.trees, self._params_dict(),
                branch_lengths=self._subst_branch_lengths(),
            )
        )
        if include_log_det_jacobian and self.tree_states:
            ll = ll + np.array([
                rooted_mod.log_det_jacobian_height_transform(s)
                for s in self.tree_states
            ])
        return ll

    def log_det_jacobian_of_height_transform(self) -> np.ndarray:
        from ..treelike import rooted as rooted_mod

        return np.array([
            rooted_mod.log_det_jacobian_height_transform(s)
            for s in self.tree_states
        ])

    def gradient_log_det_jacobian_of_height_transform(self) -> List[np.ndarray]:
        from ..treelike import rooted as rooted_mod

        return [
            rooted_mod.gradient_log_det_jacobian(s) for s in self.tree_states
        ]

    def phylo_gradients(self, phylo_flags=None, use_defaults: bool = True
                        ) -> List[PhyloGradient]:
        """Gradient map per tree: branch_lengths (substitution space),
        ratios_root_height, and model-parameter gradients
        (substitution_model in stick-breaking space, site_model,
        clock_model) via autodiff.  Selection follows PhyloFlags: a bare
        call computes everything available; explicit selection flags
        restrict the map (reference PhyloGradientFlagOptions)."""
        from ..treelike import rooted as rooted_mod

        assert self.engine is not None, "prepare_for_phylo_likelihood first"
        flags = self._resolve_flags(phylo_flags, use_defaults)
        want_ratios = flags.is_set(phylo_flags_mod.RATIOS_ROOT_HEIGHT)
        want_subst = flags.is_set(phylo_flags_mod.SUBSTITUTION_MODEL)
        want_site = flags.is_set(phylo_flags_mod.SITE_MODEL)
        want_clock = flags.is_set(phylo_flags_mod.CLOCK_MODEL)
        include_jac = flags.is_set(
            phylo_flags_mod.INCLUDE_LOG_DET_JACOBIAN_GRADIENT
        )
        trees = self.tree_collection.trees
        bl = self._subst_branch_lengths()
        ll, grads = self.engine.ll_and_branch_gradients(
            trees, self._params_dict(), branch_lengths=bl
        )
        # One device-to-host transfer for both outputs.
        ll, grads = jax.device_get((ll, grads))
        ll = np.asarray(ll)
        grads = np.asarray(grads)
        model_grads = (
            self._model_param_gradients(bl, want_subst, want_site)
            if (want_subst or want_site) else {}
        )
        out = []
        for i, tree in enumerate(trees):
            n_edges = tree.topology.num_nodes
            gmap = {"branch_lengths": grads[i, :n_edges].copy()}
            if self.tree_states and want_ratios:
                gmap["ratios_root_height"] = (
                    rooted_mod.ratio_gradient_of_branch_gradient(
                        self.tree_states[i], grads[i, :n_edges],
                        include_log_det_jacobian=include_jac,
                    )
                )
                # Clock gradient (reference ClockGradient,
                # src/fat_beagle.cpp:375-399).
            if self.tree_states and want_clock:
                per_branch = (grads[i, : n_edges - 1]
                              * tree.branch_lengths[: n_edges - 1])
                gmap["clock_model"] = np.array([per_branch.sum()])
                gmap["clock_model_rates"] = per_branch
            for key, val in model_grads.items():
                gmap[key] = np.asarray(val[i])
            out.append(PhyloGradient(ll[i], gmap))
        return out

    def _model_param_gradients(self, bl, want_subst: bool = True,
                               want_site: bool = True
                               ) -> Dict[str, np.ndarray]:
        """Autodiff gradients wrt substitution (stick-breaking space) and
        site model parameters, per tree."""
        import jax
        import jax.numpy as jnp

        from ..models.transforms import (
            stick_breaking_forward,
            stick_breaking_inverse,
        )
        from ..treelike import pruning

        model = self.phylo_model
        spec = model.spec
        out: Dict[str, np.ndarray] = {}
        if spec.substitution == "JC69" and model.site.kind == "constant":
            return out
        engine = self.engine
        trees = self.tree_collection.trees
        enc = engine.encode(trees)
        params0 = self._params_dict()
        B = len(trees)

        def ll_with(params_dict):
            eig, rates, props, clock = engine._model_ingredients(
                params_dict, B
            )
            return pruning.log_likelihoods_impl(
                jnp.asarray(enc.post_ops), jnp.asarray(enc.root),
                engine.tip_partials, engine.weights, bl,
                eig, rates, props, clock,
                num_slots=enc.num_slots, pattern_pad=engine.pattern_pad,
                category_count=model.category_count,
            )

        if want_subst and spec.substitution in ("GTR", "HKY"):
            rates0 = np.asarray(params0["substitution_model_rates"])
            freqs0 = np.asarray(params0["substitution_model_frequencies"])
            if rates0.ndim == 2:
                rates0, freqs0 = rates0[0], freqs0[0]
            y_freqs = jnp.asarray(stick_breaking_inverse(freqs0))
            if spec.substitution == "GTR":
                y_rates = jnp.asarray(stick_breaking_inverse(rates0))

                def f(y):
                    yr, yf = y[:5], y[5:]
                    p = dict(params0)
                    p["substitution_model_rates"] = stick_breaking_forward(yr)
                    p["substitution_model_frequencies"] = (
                        stick_breaking_forward(yf)
                    )
                    return ll_with(p)

                y0 = jnp.concatenate([y_rates, y_freqs])
            else:
                kappa0 = jnp.log(jnp.asarray(rates0[:1]))

                def f(y):
                    p = dict(params0)
                    p["substitution_model_rates"] = jnp.exp(y[:1])
                    p["substitution_model_frequencies"] = (
                        stick_breaking_forward(y[1:])
                    )
                    return ll_with(p)

                y0 = jnp.concatenate([kappa0, y_freqs])
            jac = jax.jacfwd(f)(y0)  # [B, K]
            if spec.substitution == "HKY":
                # Reference reports d/d(kappa), not d/d(log kappa).
                jac = jac.at[:, 0].set(jac[:, 0] / jnp.exp(y0[0]))
            out["substitution_model"] = np.asarray(jac)
        if want_site and model.site.kind in ("weibull", "gamma"):
            shape0 = np.asarray(params0["site_model_parameters"])
            if shape0.ndim == 2:
                shape0 = shape0[0]

            def g(shape):
                p = dict(params0)
                p["site_model_parameters"] = shape
                return ll_with(p)

            out["site_model"] = np.asarray(
                jax.jacfwd(g)(jnp.asarray(shape0))
            )
        return out

    def unconditional_subsplit_probabilities(self) -> Dict[str, float]:
        """Reference UnconditionalSubsplitProbabilities via the DAG path:
        probability of seeing each subsplit in an SBN sample."""
        from ..dag.subsplit_dag import build_dag_from_topologies

        dag = build_dag_from_topologies(
            [t.topology for t in self.tree_collection.trees],
            self.tree_collection.taxon_names,
        )
        # Map the instance's normalized SBN parameters onto DAG edges.
        norm = self.normalized_sbn_parameters()
        q = np.zeros(dag.edge_count())
        indexer = self.sbn_support.indexer
        for e in range(dag.edge_count()):
            key = dag.edge_pcsp(e).to_string()
            if key in indexer:
                q[e] = norm[indexer[key]]
            else:
                q[e] = 1.0  # leaf subsplit edges
        node_probs = dag.unconditional_node_probabilities(q)
        out = {}
        for i, ss in enumerate(dag.nodes):
            if i >= dag.taxon_count and i != dag.root_id:
                out[ss.to_string()] = float(node_probs[i])
        return out

    def unconditional_subsplit_probabilities_to_csv(self, path: str):
        with open(path, "w", newline="") as f:
            w = _csv.writer(f)
            for key, val in self.unconditional_subsplit_probabilities().items():
                w.writerow([key, repr(val)])


def unrooted_instance(name: str = "instance") -> UnrootedSBNInstance:
    return UnrootedSBNInstance(name)


def rooted_instance(name: str = "instance") -> RootedSBNInstance:
    return RootedSBNInstance(name)
