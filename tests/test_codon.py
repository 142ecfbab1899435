"""Codon-model (A=64-padded MG94) correctness vs a dense host computation.

The scan tape is state-generic; these tests pin the 61-state model against
an independent numpy implementation (expm via eigendecomposition, plain
per-site pruning, no rescaling tricks) on a 5-taxon tree.
"""
import numpy as np
import pytest

from bito_tpu.core.newick import parse_newick_file
from bito_tpu.models import codon as cd


def _dense_ll(topo, bl, tips61, pi, Q):
    """Per-site pruning in plain numpy over the 61 real states."""
    lam, V = np.linalg.eig(Q)
    Vinv = np.linalg.inv(V)

    def P(t):
        return np.real(V @ np.diag(np.exp(lam * t)) @ Vinv)

    S = tips61.shape[1]
    ch = topo.children()
    partial = {}
    for leaf in range(topo.num_taxa):
        partial[leaf] = tips61[leaf].T  # [61, S]
    for u in range(topo.num_taxa, topo.num_nodes):
        acc = np.ones((61, S))
        for c in ch[u]:
            acc = acc * (P(bl[c]) @ partial[c])
        partial[u] = acc
    site = pi @ partial[topo.root]
    return float(np.log(site).sum())


class TestCodonModel:
    def test_mg94_rate_matrix_properties(self):
        model = cd.CodonModel(kappa=2.5, omega=0.3,
                              nuc_freqs=(0.3, 0.2, 0.3, 0.2))
        Q, pi = model.Q61, model.pi61
        np.testing.assert_allclose(Q.sum(axis=1), 0.0, atol=1e-12)
        # reversibility: pi_i q_ij == pi_j q_ji
        np.testing.assert_allclose(pi[:, None] * Q, (pi[:, None] * Q).T,
                                   atol=1e-12)
        # unit expected rate
        np.testing.assert_allclose(-np.dot(pi, np.diag(Q)), 1.0,
                                   rtol=1e-12)
        # padded eigensystem reconstructs Q with identity pads
        U, vals, Uinv = model.U, model.values, model.U_inv
        Qp = U @ np.diag(vals) @ Uinv
        np.testing.assert_allclose(Qp[:61, :61], Q, atol=1e-10)
        np.testing.assert_allclose(Qp[61:, 61:], 0.0, atol=1e-12)

    def test_ll_matches_dense_host(self, data_dir):
        coll = parse_newick_file(str(data_dir / "five_taxon_unrooted.nwk"))
        topo = coll.trees[0].topology
        rng = np.random.default_rng(11)
        bl = rng.uniform(0.05, 0.6, topo.num_nodes)
        model = cd.CodonModel(kappa=2.0, omega=0.15,
                              nuc_freqs=(0.28, 0.22, 0.26, 0.24))
        # random codon alignment: 40 codons over the taxa
        S = 40
        states = rng.integers(0, 61, (topo.num_taxa, S))
        tips = np.zeros((topo.num_taxa, S, 64))
        tips[np.arange(topo.num_taxa)[:, None], np.arange(S)[None, :],
             states] = 1.0
        weights = np.ones(S)
        ll = cd.codon_log_likelihoods(
            [topo], bl[None, :], tips, weights, model)
        dense = _dense_ll(topo, bl, tips[:, :, :61], model.pi61, model.Q61)
        assert float(np.asarray(ll)[0]) == pytest.approx(dense, rel=1e-9)

    def test_tip_partials_and_gaps(self):
        seqs = {"a": "ATGTTT", "b": "ATGNNN"}
        tp = cd.codon_tip_partials(seqs, ["a", "b"])
        assert tp.shape == (2, 2, 64)
        assert tp[0, 0, cd.CODON_INDEX["ATG"]] == 1.0
        assert tp[0, 0].sum() == 1.0
        # ambiguous codon: all-ones over sense states, zero on pads
        assert tp[1, 1, :61].sum() == 61
        assert tp[1, 1, 61:].sum() == 0

    def test_gamma_categories(self, data_dir):
        """Codon model composes with discrete rate categories."""
        coll = parse_newick_file(str(data_dir / "five_taxon_unrooted.nwk"))
        topo = coll.trees[0].topology
        rng = np.random.default_rng(3)
        bl = rng.uniform(0.05, 0.4, topo.num_nodes)
        model = cd.CodonModel()
        S = 12
        states = rng.integers(0, 61, (topo.num_taxa, S))
        tips = np.zeros((topo.num_taxa, S, 64))
        tips[np.arange(topo.num_taxa)[:, None], np.arange(S)[None, :],
             states] = 1.0
        w = np.ones(S)
        rates = [0.5, 1.5]
        props = [0.5, 0.5]
        ll = float(np.asarray(cd.codon_log_likelihoods(
            [topo], bl[None, :], tips, w, model,
            category_rates=rates, category_proportions=props))[0])
        # dense: average of the two scaled-rate likelihood surfaces
        per_site = []
        for r in rates:
            lam, V = np.linalg.eig(model.Q61)
            Vinv = np.linalg.inv(V)
            ch = topo.children()
            partial = {leaf: tips[leaf, :, :61].T
                       for leaf in range(topo.num_taxa)}
            for u in range(topo.num_taxa, topo.num_nodes):
                acc = np.ones((61, S))
                for c in ch[u]:
                    P = np.real(V @ np.diag(
                        np.exp(lam * bl[c] * r)) @ Vinv)
                    acc = acc * (P @ partial[c])
                partial[u] = acc
            per_site.append(model.pi61 @ partial[topo.root])
        dense = float(np.log(
            0.5 * per_site[0] + 0.5 * per_site[1]).sum())
        assert ll == pytest.approx(dense, rel=1e-9)

    def test_gradients_match_finite_difference(self, data_dir):
        """A=64 branch gradients (linear-time preorder pass on the same
        tape) vs central finite differences."""
        coll = parse_newick_file(str(data_dir / "five_taxon_unrooted.nwk"))
        topo = coll.trees[0].topology
        rng = np.random.default_rng(5)
        bl = rng.uniform(0.05, 0.5, topo.num_nodes)
        model = cd.CodonModel(kappa=2.0, omega=0.2)
        S = 20
        states = rng.integers(0, 61, (topo.num_taxa, S))
        tips = np.zeros((topo.num_taxa, S, 64))
        tips[np.arange(topo.num_taxa)[:, None], np.arange(S)[None, :],
             states] = 1.0
        w = np.ones(S)
        ll, grads = cd.codon_ll_and_gradients(
            [topo], bl[None, :], tips, w, model)
        ll, grads = float(np.asarray(ll)[0]), np.asarray(grads)[0]
        eps = 1e-6
        for e in (0, 2, topo.num_taxa):
            blp = bl.copy(); blp[e] += eps
            blm = bl.copy(); blm[e] -= eps
            lp = float(np.asarray(cd.codon_log_likelihoods(
                [topo], blp[None, :], tips, w, model))[0])
            lm = float(np.asarray(cd.codon_log_likelihoods(
                [topo], blm[None, :], tips, w, model))[0])
            fd = (lp - lm) / (2 * eps)
            assert grads[e] == pytest.approx(fd, rel=1e-5, abs=1e-6)


def _synthetic_codon_alignment(taxon_names, n_codons=40, seed=7,
                               missing_rate=0.05):
    """Random codon sequences (strings) over the 61 sense codons, with a
    few missing ('---') and stop ('TAA') triplets to exercise the
    missing-data path."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in taxon_names:
        parts = []
        for _ in range(n_codons):
            u = rng.random()
            if u < missing_rate / 2:
                parts.append("---")
            elif u < missing_rate:
                parts.append("TAA")  # stop codon -> treated as missing
            else:
                parts.append(cd.SENSE_CODONS[rng.integers(0, 61)])
        out[t] = "".join(parts)
    return out


class TestCodonProductPath:
    """MG94 as a product model: PhyloModelSpecification('MG94') +
    CodonSitePattern + TreeLikelihoodEngine (VERDICT round-4 task 2 —
    previously codon ran only through free functions)."""

    def _setup(self, data_dir, site="constant"):
        from bito_tpu.core.site_pattern import CodonSitePattern
        from bito_tpu.models.phylo_model import (
            PhyloModel, PhyloModelSpecification)
        from bito_tpu.treelike.engine import TreeLikelihoodEngine

        coll = parse_newick_file(str(data_dir / "five_taxon_unrooted.nwk"))
        aln = _synthetic_codon_alignment(coll.taxon_names)
        sp = CodonSitePattern(aln, coll.taxon_names)
        spec = PhyloModelSpecification(substitution="MG94", site=site)
        engine = TreeLikelihoodEngine(sp, PhyloModel(spec))
        return coll, sp, engine

    def _params(self):
        import jax.numpy as jnp

        return {
            "substitution_model_rates": jnp.asarray([2.5, 0.3]),
            "substitution_model_frequencies": jnp.asarray(
                [0.3, 0.2, 0.3, 0.2]),
        }

    def test_codon_site_pattern_compression(self, data_dir):
        coll, sp, _ = self._setup(data_dir)
        assert sp.num_taxa == 5
        assert sp.weights.sum() == sp.site_count == 40
        tp = sp.tip_partials()
        assert tp.shape == (5, sp.pattern_count, 64)
        # pad states always zero; missing columns all-ones over sense
        assert (tp[:, :, 61:] == 0).all()
        rows = tp.reshape(-1, 64)
        sums = rows.sum(axis=1)
        assert set(np.unique(sums)) <= {1.0, 61.0}

    def test_engine_scan_matches_free_function(self, data_dir):
        coll, sp, engine = self._setup(data_dir)
        params = self._params()
        trees = coll.trees
        for t in trees:
            t.branch_lengths[:] = np.linspace(
                0.05, 0.4, t.branch_lengths.shape[0])
        ll_engine = np.asarray(engine.log_likelihoods(trees, params))

        model = cd.CodonModel(kappa=2.5, omega=0.3,
                              nuc_freqs=(0.3, 0.2, 0.3, 0.2))
        enc_topos = [t.topology for t in trees]
        N = max(t.num_nodes for t in enc_topos)
        bl = np.zeros((len(trees), N))
        for b, t in enumerate(trees):
            bl[b, : t.topology.num_nodes] = t.branch_lengths
        ll_free = np.asarray(cd.codon_log_likelihoods(
            enc_topos, bl, sp.tip_partials(), sp.weights, model))
        np.testing.assert_allclose(ll_engine, ll_free, rtol=1e-9)

    def test_mg94_traceable_eigen_matches_host(self):
        """The traceable jnp MG94 eigensystem (used when parameters are
        traced, e.g. model-parameter gradients) reconstructs the same Q
        as the concrete float64 host path."""
        import jax
        import jax.numpy as jnp

        k, w = 2.5, 0.3
        freqs = jnp.asarray([0.3, 0.2, 0.3, 0.2])
        host = cd.mg94_eigen(k, w, freqs)

        def recon(kw):
            e = cd.mg94_eigen(kw[0], kw[1], freqs)
            return e.U @ jnp.diag(e.values) @ e.U_inv

        Q_traced = jax.jit(recon)(jnp.asarray([k, w]))
        Q_host = np.asarray(host.U) @ np.diag(
            np.asarray(host.values)) @ np.asarray(host.U_inv)
        np.testing.assert_allclose(np.asarray(Q_traced), Q_host,
                                   rtol=1e-8, atol=1e-10)


class TestUniformizedTransitions:
    """The positivity-preserving uniformization route (round-5 fix): f32
    eigen-reconstruction of codon P(t) makes small entries cancellation
    noise, which measured as an 18x branch-gradient error vs float64 on
    DS1 codon data.  The uniformized series has only nonnegative terms,
    so every entry is computed to f32 RELATIVE accuracy."""

    def test_uniformized_matches_eigen_expm_f64(self):
        import jax.numpy as jnp
        from bito_tpu.models.substitution import (
            uniformized_stack, uniformized_transition_matrices)

        model = cd.CodonModel(kappa=2.5, omega=0.3,
                              nuc_freqs=(0.3, 0.2, 0.3, 0.2))
        Qp = np.zeros((64, 64))
        Qp[:61, :61] = model.Q61
        stack, q = uniformized_stack(jnp.asarray(Qp))
        for t in (0.0, 0.01, 0.3, 2.0, 7.0):  # 7.0: qt ~ 11, K=40 margin
            P_u = np.asarray(uniformized_transition_matrices(
                stack, q, jnp.asarray(t)))
            lam, V = np.linalg.eig(model.Q61)
            P_e = np.real(V @ np.diag(np.exp(lam * t)) @ np.linalg.inv(V))
            np.testing.assert_allclose(P_u[:61, :61], P_e,
                                       rtol=1e-9, atol=1e-12)
            # pad block stays the identity
            np.testing.assert_allclose(P_u[61:, 61:], np.eye(3),
                                       atol=1e-12)
            assert (P_u >= 0).all()

    def test_uniformized_small_entries_relative_accuracy_f32(self):
        """f32 uniformized P reproduces tiny entries to relative (not
        absolute) accuracy — the property the eigen route lacks."""
        import jax.numpy as jnp
        from bito_tpu.models.substitution import (
            uniformized_stack, uniformized_transition_matrices)

        model = cd.CodonModel(kappa=2.5, omega=0.3,
                              nuc_freqs=(0.3, 0.2, 0.3, 0.2))
        Qp = np.zeros((64, 64))
        Qp[:61, :61] = model.Q61
        t = 0.02  # short branch: many entries are ~1e-7..1e-12
        s64, q64 = uniformized_stack(jnp.asarray(Qp, jnp.float64))
        P64 = np.asarray(uniformized_transition_matrices(
            s64, q64, jnp.asarray(t, jnp.float64)))
        s32, q32 = uniformized_stack(jnp.asarray(Qp, jnp.float32))
        P32 = np.asarray(uniformized_transition_matrices(
            s32, q32, jnp.asarray(t, jnp.float32)))
        mask = P64[:61, :61] > 1e-14
        rel = np.abs(P32[:61, :61][mask] - P64[:61, :61][mask]) / \
            P64[:61, :61][mask]
        assert rel.max() < 1e-4, rel.max()

    def test_f32_codon_gradients_match_f64_at_ds1_scale(self, data_dir):
        """THE regression this round fixed: on DS1 read as codons, f32
        branch gradients (scan tape, through the product engine) were
        18x off vs f64 with the eigen route; the uniformized route pins
        them at <1e-5 relative."""
        import jax.numpy as jnp
        from bito_tpu.core.newick import parse_nexus_file, read_fasta
        from bito_tpu.core.site_pattern import CodonSitePattern
        from bito_tpu.models.phylo_model import (
            PhyloModel, PhyloModelSpecification)
        from bito_tpu.treelike.engine import TreeLikelihoodEngine

        coll = parse_nexus_file(str(data_dir / "DS1.subsampled_10.t"))
        seqs = read_fasta(str(data_dir / "DS1.fasta"))
        sp = CodonSitePattern(seqs, coll.taxon_names)
        spec = PhyloModelSpecification(substitution="MG94")
        params = {
            "substitution_model_rates": jnp.asarray([2.5, 0.3]),
            "substitution_model_frequencies": jnp.asarray(
                [0.3, 0.2, 0.3, 0.2]),
        }
        trees = coll.trees[:2]
        e32 = TreeLikelihoodEngine(sp, PhyloModel(spec),
                                   dtype=jnp.float32)
        ll32, g32 = e32.ll_and_branch_gradients(trees, params)
        e64 = TreeLikelihoodEngine(sp, PhyloModel(spec))
        ll64, g64 = e64.ll_and_branch_gradients(trees, params)
        g32, g64 = np.asarray(g32), np.asarray(g64)
        assert np.abs((np.asarray(ll32) - np.asarray(ll64))
                      / np.asarray(ll64)).max() < 1e-5
        assert np.abs(g32 - g64).max() / np.abs(g64).max() < 1e-5

class TestCodonProductPathExtras:
    _setup = TestCodonProductPath._setup
    _params = TestCodonProductPath._params

    def test_engine_codon_with_gamma_categories(self, data_dir):
        """MG94 x gamma+4 through the product engine (C=4, A=64,
        CA=256): the scan route must match the free-function path with
        explicit category rates."""
        import jax.numpy as jnp
        from bito_tpu.models.site import gamma_median_category_rates

        coll, sp, _ = self._setup(data_dir, site="gamma+4")
        from bito_tpu.models.phylo_model import (
            PhyloModel, PhyloModelSpecification)
        from bito_tpu.treelike.engine import TreeLikelihoodEngine

        spec = PhyloModelSpecification(substitution="MG94", site="gamma+4")
        engine = TreeLikelihoodEngine(sp, PhyloModel(spec))
        params = dict(self._params(),
                      site_model_parameters=jnp.asarray([0.6]))
        trees = coll.trees[:2]
        for t in trees:
            t.branch_lengths[:] = np.linspace(
                0.05, 0.4, t.branch_lengths.shape[0])
        ll = np.asarray(engine.log_likelihoods(trees, params))
        _, g = engine.ll_and_branch_gradients(trees, params)
        assert np.isfinite(ll).all() and np.isfinite(np.asarray(g)).all()

        model = cd.CodonModel(kappa=2.5, omega=0.3,
                              nuc_freqs=(0.3, 0.2, 0.3, 0.2))
        rates = np.asarray(gamma_median_category_rates(0.6, 4))
        props = np.full(4, 0.25)
        N = max(t.topology.num_nodes for t in trees)
        bl = np.zeros((2, N))
        for b, t in enumerate(trees):
            bl[b, : t.topology.num_nodes] = t.branch_lengths
        ll_free = np.asarray(cd.codon_log_likelihoods(
            [t.topology for t in trees], bl, sp.tip_partials(),
            sp.weights, model, category_rates=rates,
            category_proportions=props))
        np.testing.assert_allclose(ll, ll_free, rtol=1e-6)

