"""Tree-batch likelihood engine (the Engine/FatBeagle replacement).

Reference: src/engine.cpp:27-119 dispatches per-tree work to a pool of
FatBeagles; here one jitted XLA program evaluates the whole batch, with
per-tree phylogenetic model parameter rows (the analog of
FatBeagleParallelize's per-tree SetParameters, src/fat_beagle.hpp:151-184).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..core.site_pattern import SitePattern
from ..core.tree import Tree
from ..models.phylo_model import PhyloModel
from . import pruning
from .encode import (
    LeveledEncoding,
    TreeBatchEncoding,
    encode_trees,
    encode_trees_leveled,
)


class TreeLikelihoodEngine:
    """Batched likelihood/gradient evaluation for a fixed tree batch.

    The encoding is rebuilt when topologies change; branch lengths and model
    parameters are plain device arrays, so sweeps over them stay jitted.
    """

    def __init__(
        self,
        site_pattern: SitePattern,
        model: PhyloModel,
        dtype=None,
    ):
        self.site_pattern = site_pattern
        self.model = model
        self.dtype = dtype or jnp.zeros(0).dtype
        # Per-state dimension A: 4 for nucleotide models, 64 for the
        # padded codon models (MG94).  All buffer shapes flow from here.
        self.num_states = getattr(model, "num_states", 4)
        S0 = site_pattern.pattern_count
        self.pattern_pad = pruning.pad_patterns(S0)
        # Pre-pad tips to a multiple of 128 patterns (padded columns are
        # all-ones "gaps" with weight zero), so the pattern axis can be
        # sharded across a device mesh directly.
        tips = np.ones((site_pattern.num_taxa, self.pattern_pad,
                        self.num_states))
        tips[:, :S0, :] = site_pattern.tip_partials()
        self.tip_partials = jnp.asarray(tips, dtype=self.dtype)
        w = np.zeros(self.pattern_pad)
        w[:S0] = site_pattern.weights
        self.weights = jnp.asarray(w, dtype=self.dtype)
        self._encoding: Optional[TreeBatchEncoding] = None
        self._encoding_key = None
        self._leveled: Optional[LeveledEncoding] = None
        self._leveled_key = None
        # The scan tape is the product path.  The levelized wavefront
        # variant (~tree-depth wide steps instead of ~node-count narrow
        # ones) computes the same values and stays for comparison.
        self.use_leveled = False

    def _rate_Q(self, params: Dict[str, jnp.ndarray]):
        """Shared-model padded rate matrix for the uniformized transition
        route (codon models; None otherwise).  Per-tree parameter rows
        fall back to the eigen route."""
        if any(jnp.asarray(params[k]).ndim != 1 for k in self.model.blocks):
            return None
        return self.model.rate_matrix(params)

    def shard_patterns(self, mesh, axis: str = "sites"):
        """Shard the site-pattern axis across a device mesh (SURVEY P5/P6:
        patterns are the single distributed axis; tree encodings, branch
        lengths, and model parameters stay replicated).  The engine's tips
        are padded with weight-zero columns to a multiple of the mesh size,
        so re-placing tips [T, S, A] and weights [S] with NamedShardings is
        enough: XLA propagates the sharding through the pruning scans and
        inserts psums for the per-tree reductions."""
        from jax.sharding import PartitionSpec

        from ..dist import multihost

        n_dev = mesh.shape[axis]
        if self.pattern_pad % n_dev:
            extra = (-self.pattern_pad) % n_dev
            tips = np.ones((self.tip_partials.shape[0],
                            self.pattern_pad + extra, self.num_states))
            tips[:, : self.pattern_pad] = np.asarray(self.tip_partials)
            w = np.zeros(self.pattern_pad + extra)
            w[: self.pattern_pad] = np.asarray(self.weights)
            self.pattern_pad += extra
            self.tip_partials = jnp.asarray(tips, dtype=self.dtype)
            self.weights = jnp.asarray(w, dtype=self.dtype)
        # multihost.place works for single- and multi-process meshes alike.
        self.tip_partials = multihost.place(
            self.tip_partials, mesh, PartitionSpec(None, axis, None))
        self.weights = multihost.place(
            self.weights, mesh, PartitionSpec(axis))

    # -- encoding cache -------------------------------------------------
    def encode(self, trees: Sequence[Tree]) -> TreeBatchEncoding:
        key = tuple(t.topology.key() for t in trees)
        if key != self._encoding_key:
            self._encoding = encode_trees([t.topology for t in trees])
            self._encoding_key = key
        return self._encoding

    def encode_leveled(self, trees: Sequence[Tree]) -> LeveledEncoding:
        key = tuple(t.topology.key() for t in trees)
        if key != self._leveled_key:
            self._leveled = encode_trees_leveled(
                [t.topology for t in trees]
            )
            self._leveled_key = key
        return self._leveled

    def branch_length_matrix(self, trees: Sequence[Tree],
                             enc: TreeBatchEncoding) -> jnp.ndarray:
        bl = np.zeros((len(trees), enc.num_slots))
        for b, t in enumerate(trees):
            bl[b, : t.topology.num_nodes] = t.branch_lengths
        return jnp.asarray(bl, dtype=self.dtype)

    def _model_ingredients(self, params: Dict[str, jnp.ndarray], batch: int):
        """Per-tree model ingredients (eig fields [B,...], rates/props [B,C],
        clock [B]).  `params` values may be shared (unbatched) or carry a
        leading per-tree axis (the reference's phylo_model_params_ matrix,
        src/generic_sbn_instance.hpp:32-40)."""

        def one(p):
            eig = self.model.eigen(p)
            eig = type(eig)(*(jnp.asarray(x, dtype=self.dtype) for x in eig))
            rates = self.model.category_rates(p).astype(self.dtype)
            props = self.model.category_proportions(p).astype(self.dtype)
            clock = jnp.asarray(self.model.clock_rate(p), dtype=self.dtype)
            return eig, rates, props, clock

        vals = {k: jnp.asarray(params[k]) for k in self.model.blocks}
        if all(v.ndim == 1 for v in vals.values()):
            # Shared model: one eigendecomposition, broadcast — not B
            # identical vmapped ones.  With concrete params (the normal
            # engine call path; closure constants stay concrete even
            # inside an outer jit trace) this also lets models with
            # host-side eigen paths (MG94's float64 61-state eigh,
            # models/codon.py mg94_eigen) take them.
            eig, rates, props, clock = one(vals)
            bcast = lambda x: jnp.broadcast_to(x, (batch,) + x.shape)
            return (type(eig)(*(bcast(x) for x in eig)), bcast(rates),
                    bcast(props), bcast(clock))
        batched = {
            k: (jnp.broadcast_to(v, (batch, self.model.blocks[k][1]))
                if v.ndim == 1 else v)
            for k, v in vals.items()
        }
        return jax.vmap(one)(batched)

    # -- public API ------------------------------------------------------
    @staticmethod
    def _bucket_trees(trees: Sequence[Tree]):
        """Pad a tree batch to the next multiple of 32 (powers of two below)
        by repeating the last tree.  Callers with iteration-varying batch
        sizes (the NNI loop scores a different candidate count every epoch)
        opt in so the jitted programs compile once per bucket instead of
        once per iteration.  Returns (padded_trees, true_count)."""
        b = len(trees)
        target = 4
        while target < b:
            target = target * 2 if target < 32 else target + 32
        return list(trees) + [trees[-1]] * (target - b), b

    def log_likelihoods(
        self, trees: Sequence[Tree], params: Dict[str, jnp.ndarray],
        branch_lengths: Optional[jnp.ndarray] = None,
        bucket: bool = False,
    ) -> jnp.ndarray:
        if bucket and branch_lengths is None:
            padded, b = self._bucket_trees(trees)
            return self.log_likelihoods(padded, params)[:b]
        enc = self.encode(trees)
        bl = (branch_lengths if branch_lengths is not None
              else self.branch_length_matrix(trees, enc))
        eig, rates, props, clock = self._model_ingredients(params, len(trees))
        if self.use_leveled:
            lev = self.encode_leveled(trees)
            return pruning.log_likelihoods_leveled_impl(
                jnp.asarray(lev.post_levels), jnp.asarray(lev.root),
                self.tip_partials, self.weights, bl,
                eig, rates, props, clock,
                num_slots=lev.num_slots, pattern_pad=self.pattern_pad,
                category_count=self.model.category_count,
            )
        return pruning.log_likelihoods_impl(
            jnp.asarray(enc.post_ops), jnp.asarray(enc.root),
            self.tip_partials, self.weights, bl,
            eig, rates, props, clock, self._rate_Q(params),
            num_slots=enc.num_slots, pattern_pad=self.pattern_pad,
            category_count=self.model.category_count,
        )

    def ll_and_branch_gradients(
        self, trees: Sequence[Tree], params: Dict[str, jnp.ndarray],
        branch_lengths: Optional[jnp.ndarray] = None,
    ):
        enc = self.encode(trees)
        bl = (branch_lengths if branch_lengths is not None
              else self.branch_length_matrix(trees, enc))
        eig, rates, props, clock = self._model_ingredients(params, len(trees))
        if self.use_leveled:
            lev = self.encode_leveled(trees)
            return pruning.ll_and_branch_gradients_leveled_impl(
                jnp.asarray(lev.post_levels), jnp.asarray(lev.pre_levels),
                jnp.asarray(lev.root),
                jnp.asarray(lev.edge_mask, dtype=self.dtype),
                self.tip_partials, self.weights, bl,
                eig, rates, props, clock,
                num_slots=lev.num_slots, pattern_pad=self.pattern_pad,
                category_count=self.model.category_count,
            )
        return pruning.ll_and_branch_gradients_impl(
            jnp.asarray(enc.post_ops), jnp.asarray(enc.pre_ops),
            jnp.asarray(enc.root), jnp.asarray(enc.edge_mask, dtype=self.dtype),
            self.tip_partials, self.weights, bl,
            eig, rates, props, clock, self._rate_Q(params),
            num_slots=enc.num_slots, pattern_pad=self.pattern_pad,
            category_count=self.model.category_count,
        )

    def branch_eval_fn(self, trees: Sequence[Tree],
                       params: Dict[str, jnp.ndarray]):
        """Return a traceable closure bl[B, N] -> (ll[B], grads[B, N]) bound
        to this tree batch and model parameters — for embedding many
        evaluations in one jitted sweep (a VBPI inner loop or branch-length
        scan) without per-call host work.  This is the engine's hot path;
        bench.py drives it."""
        enc = self.encode(trees)
        eig, rates, props, clock = self._model_ingredients(params, len(trees))
        post_ops = jnp.asarray(enc.post_ops)
        pre_ops = jnp.asarray(enc.pre_ops)
        root = jnp.asarray(enc.root)
        edge_mask = jnp.asarray(enc.edge_mask, dtype=self.dtype)
        Q = self._rate_Q(params)

        def fn(bl):
            return pruning.ll_and_branch_gradients_impl(
                post_ops, pre_ops, root, edge_mask,
                self.tip_partials, self.weights, bl,
                eig, rates, props, clock, Q,
                num_slots=enc.num_slots, pattern_pad=self.pattern_pad,
                category_count=self.model.category_count,
            )

        return fn

    def ll_eval_fn(self, trees: Sequence[Tree],
                   params: Dict[str, jnp.ndarray]):
        """LL-only analog of branch_eval_fn: a traceable closure
        bl[B, N] -> ll[B] bound to this tree batch, serving the same path
        log_likelihoods dispatches."""

        def fn(bl):
            return self.log_likelihoods(trees, params, branch_lengths=bl)

        return fn

    def optimize_selected_branches(
        self, trees: Sequence[Tree], params: Dict[str, jnp.ndarray],
        selected_nodes: Sequence[Sequence[int]], iterations: int = 2,
        max_selected: int = 8, bucket: bool = False,
    ) -> np.ndarray:
        """Exact conditional Brent optimization of selected branches per
        tree (batched); returns the branch-length matrix [B, N].  The
        classical-engine counterpart of the reference TPEngine's
        proposed-NNI new-edge optimization (src/tp_engine.cpp:1423-1427)."""
        if bucket:
            # Pad the batch to a bucket and pin K at max_selected so the
            # jitted program compiles once per bucket, not per NNI epoch.
            padded, b = self._bucket_trees(list(trees))
            sel = list(selected_nodes) + [[]] * (len(padded) - b)
            K = max_selected
            trees, selected_nodes = padded, sel
        else:
            b = len(trees)
            K = min(max_selected,
                    max((len(s) for s in selected_nodes), default=1)) or 1
        enc = self.encode(trees)
        bl = self.branch_length_matrix(trees, enc)
        eig, rates, props, clock = self._model_ingredients(params, len(trees))
        sel = np.full((len(trees), K), enc.num_slots, dtype=np.int32)
        mask = np.zeros((len(trees), K), dtype=bool)
        for i, nodes in enumerate(selected_nodes):
            nodes = list(nodes)[:K]
            sel[i, : len(nodes)] = nodes
            mask[i, : len(nodes)] = True
        out = pruning.optimize_selected_branches_impl(
            jnp.asarray(enc.post_ops), jnp.asarray(enc.pre_ops),
            jnp.asarray(enc.root), self.tip_partials, self.weights, bl,
            eig, rates, props, clock,
            jnp.asarray(sel), jnp.asarray(mask),
            num_slots=enc.num_slots, pattern_pad=self.pattern_pad,
            category_count=self.model.category_count,
            iterations=iterations,
        )
        return np.asarray(out)[:b]
