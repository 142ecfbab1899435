"""Single-tree likelihood parity tests.

Oracles (reference):
  - hello JC69 LL == -84.852358 (src/unrooted_sbn_instance.hpp:243)
  - DS1 10-tree JC69 LLs == pybeagle goldens
    (src/unrooted_sbn_instance.hpp:252-257)
  - brute-force enumeration over internal states on tiny trees
  - finite-difference checks of branch gradients
"""
import itertools

import numpy as np
import pytest

from bito_tpu.core.newick import (
    parse_newick_file,
    parse_nexus_file,
    read_fasta,
)
from bito_tpu.core.site_pattern import SitePattern
from bito_tpu.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu.treelike.engine import TreeLikelihoodEngine

PYBEAGLE_DS1_LLS = [
    -14582.995273982739, -6911.294207416366, -6916.880235529542,
    -6904.016888831189, -6915.055570693576, -6915.50496696512,
    -6910.958836661867, -6909.02639968063, -6912.967861935749,
    -6910.7871105783515,
]


def make_engine(fasta, trees_file, spec=None, nexus=False, data_dir=None):
    if nexus:
        coll = parse_nexus_file(str(data_dir / trees_file))
    else:
        coll = parse_newick_file(str(data_dir / trees_file))
    seqs = read_fasta(str(data_dir / fasta))
    sp = SitePattern(seqs, coll.taxon_names)
    model = PhyloModel(spec or PhyloModelSpecification())
    return coll, TreeLikelihoodEngine(sp, model), model


def brute_force_ll(tree, tip_states, Q_eig, pi, cat_rates, cat_props, weights):
    """Enumerate internal-node states: exact likelihood for tiny trees."""
    from bito_tpu.models.substitution import transition_matrices
    import jax.numpy as jnp

    topo = tree.topology
    n = topo.num_taxa
    N = topo.num_nodes
    parents = topo.parents
    S = tip_states.shape[1]
    total = 0.0
    lls = np.zeros(S)
    for s in range(S):
        site_l = 0.0
        for c, rate in enumerate(cat_rates):
            P = {
                u: np.asarray(
                    transition_matrices(Q_eig, jnp.asarray(tree.branch_lengths[u] * rate))
                )
                for u in range(N - 1)
            }
            acc = 0.0
            internals = list(range(n, N))
            for assign in itertools.product(range(4), repeat=len(internals)):
                state = {internals[i]: assign[i] for i in range(len(internals))}
                for t_ in range(n):
                    state[t_] = tip_states[t_, s]
                prob = pi[state[N - 1]]
                for u in range(N - 1):
                    su = state[u]
                    sp_ = state[parents[u]]
                    if su == 4:  # gap: sum over states = 1 contribution per row
                        prob *= 1.0
                    else:
                        prob *= P[u][sp_, su]
                acc += prob
            site_l += cat_props[c] * acc
        lls[s] = np.log(site_l)
    return float(lls @ weights), lls


class TestHello:
    def test_hello_likelihood_parity(self, data_dir):
        coll, engine, model = make_engine(
            "hello.fasta", "hello.nwk", data_dir=data_dir
        )
        ll = np.asarray(engine.log_likelihoods(coll.trees, {}))
        assert ll.shape == (1,)
        assert abs(ll[0] - -84.852358) < 1e-6

    def test_hello_vs_brute_force(self, data_dir):
        from bito_tpu.models.substitution import jc69_eigen

        coll, engine, model = make_engine(
            "hello.fasta", "hello.nwk", data_dir=data_dir
        )
        sp = engine.site_pattern
        eig = jc69_eigen()
        expected, _ = brute_force_ll(
            coll.trees[0], sp.tip_states(), eig, np.full(4, 0.25),
            [1.0], [1.0], sp.weights,
        )
        got = float(np.asarray(engine.log_likelihoods(coll.trees, {}))[0])
        assert abs(got - expected) < 1e-9


class TestDS1:
    def test_ds1_jc69_parity_with_pybeagle(self, data_dir):
        coll, engine, model = make_engine(
            "DS1.fasta", "DS1.subsampled_10.t", nexus=True, data_dir=data_dir
        )
        assert len(coll.trees) == 10
        ll = np.asarray(engine.log_likelihoods(coll.trees, {}))
        np.testing.assert_allclose(ll, PYBEAGLE_DS1_LLS, rtol=0, atol=2e-6)

    def test_ds1_jc69_equals_gtr_at_jc_params(self, data_dir):
        import jax.numpy as jnp

        coll, engine_jc, _ = make_engine(
            "DS1.fasta", "DS1.subsampled_10.t", nexus=True, data_dir=data_dir
        )
        trees = coll.trees[:3]
        ll_jc = np.asarray(engine_jc.log_likelihoods(trees, {}))
        spec = PhyloModelSpecification(substitution="GTR")
        coll2, engine_gtr, model_gtr = make_engine(
            "DS1.fasta", "DS1.subsampled_10.t", spec=spec, nexus=True,
            data_dir=data_dir,
        )
        params = {
            "substitution_model_rates": jnp.full((6,), 1 / 6),
            "substitution_model_frequencies": jnp.full((4,), 0.25),
        }
        ll_gtr = np.asarray(engine_gtr.log_likelihoods(trees, params))
        np.testing.assert_allclose(ll_jc, ll_gtr, atol=1e-8)


class TestGradients:
    @pytest.mark.parametrize("subst", ["JC69", "GTR"])
    @pytest.mark.parametrize("site", ["constant", "weibull+4"])
    def test_branch_gradients_vs_finite_differences(self, data_dir, subst, site):
        import jax.numpy as jnp

        spec = PhyloModelSpecification(substitution=subst, site=site)
        coll, engine, model = make_engine(
            "five_taxon.fasta", "five_taxon_unrooted.nwk", spec=spec,
            data_dir=data_dir,
        )
        trees = coll.trees[:2]
        for t in trees:
            rng = np.random.RandomState(hash(subst + site) % 2**31)
            t.branch_lengths[:-1] = 0.05 + 0.2 * rng.rand(len(t.branch_lengths) - 1)
        params = {}
        if subst == "GTR":
            params["substitution_model_rates"] = jnp.asarray(
                [0.1, 0.3, 0.1, 0.2, 0.25, 0.05]
            )
            params["substitution_model_frequencies"] = jnp.asarray(
                [0.3, 0.25, 0.2, 0.25]
            )
        if site == "weibull+4":
            params["site_model_parameters"] = jnp.asarray([0.7])
        ll, grads = engine.ll_and_branch_gradients(trees, params)
        ll = np.asarray(ll)
        grads = np.asarray(grads)
        eps = 1e-6
        for b, t in enumerate(trees):
            for u in range(t.topology.num_nodes - 1):
                t.branch_lengths[u] += eps
                lp = float(np.asarray(engine.log_likelihoods(trees, params))[b])
                t.branch_lengths[u] -= 2 * eps
                lm = float(np.asarray(engine.log_likelihoods(trees, params))[b])
                t.branch_lengths[u] += eps
                fd = (lp - lm) / (2 * eps)
                assert abs(grads[b, u] - fd) < 1e-4, (b, u, grads[b, u], fd)


class TestSitePattern:
    def test_compression_weights_sum_to_length(self, data_dir):
        seqs = read_fasta(str(data_dir / "DS1.fasta"))
        names = list(seqs.keys())
        sp = SitePattern(seqs, names)
        assert sp.weights.sum() == len(next(iter(seqs.values())))
        assert sp.patterns.shape[0] == len(names)

    def test_hello_patterns(self, data_dir):
        seqs = read_fasta(str(data_dir / "hello.fasta"))
        sp = SitePattern(seqs, list(seqs.keys()))
        assert sp.weights.sum() == 31


class TestNewick:
    def test_roundtrip_five_taxon(self, data_dir):
        coll = parse_newick_file(str(data_dir / "five_taxon_unrooted.nwk"))
        assert len(coll.trees) == 4
        assert coll.num_taxa == 5
        # Round trip: newick out, parse again, same topology keys.
        text = coll.newick()
        from bito_tpu.core.newick import parse_newick_text

        coll2 = parse_newick_text(text, taxon_names=coll.taxon_names)
        for a, b in zip(coll.trees, coll2.trees):
            assert a.topology.key() == b.topology.key()
            np.testing.assert_allclose(a.branch_lengths, b.branch_lengths)

    def test_nexus_translate(self, data_dir):
        coll = parse_nexus_file(str(data_dir / "DS1.subsampled_10.t"))
        assert coll.num_taxa == 27
        assert coll.taxon_names[0] == "Alligator_mississippiensis"
        assert len(coll.trees) == 10
