"""SBN layer parity tests.

Oracles:
  - SA/EM probabilities on DS1.100_topologies.nwk vs zcrabbit/sbn goldens
    (reference src/sbn_probability.hpp:78-167, extracted to
    tests/data/sbn_golden.json)
  - rooted indexer representation strings (src/unrooted_sbn_instance.hpp:215-233)
  - rooting invariance of unrooted representations (test/test_bito.py:126-154)
  - DS1 subsplit support vs vbpi-exported JSON (test/test_bito.py:76-95)
  - gradient of log q vs finite differences
    (src/unrooted_sbn_instance.hpp "gradient of log q WRT phi")
"""
import json
import pathlib

import numpy as np
import pytest

from bito_tpu.api.instances import rooted_instance, unrooted_instance

GOLDEN = json.load(open(pathlib.Path(__file__).parent / "data/sbn_golden.json"))


@pytest.fixture(scope="module")
def ds1_100(data_dir):
    inst = unrooted_instance("ds1")
    inst.read_newick_file(str(data_dir / "DS1.100_topologies.nwk"))
    inst.process_loaded_trees()
    return inst


class TestTraining:
    def test_simple_average_golden(self, ds1_100):
        ds1_100.train_simple_average()
        probs = ds1_100.calculate_sbn_probabilities()
        np.testing.assert_allclose(probs, GOLDEN["SA"], atol=1e-12)

    def test_em_alpha0_golden(self, ds1_100):
        ds1_100.train_expectation_maximization(0.0, 1)
        np.testing.assert_allclose(
            ds1_100.calculate_sbn_probabilities(), GOLDEN["EM_0_1"], atol=1e-12
        )
        ds1_100.train_expectation_maximization(0.0, 23)
        np.testing.assert_allclose(
            ds1_100.calculate_sbn_probabilities(), GOLDEN["EM_0_23"], atol=1e-12
        )

    def test_em_alpha05_golden(self, ds1_100):
        ds1_100.train_expectation_maximization(0.5, 100)
        np.testing.assert_allclose(
            ds1_100.calculate_sbn_probabilities(), GOLDEN["EM_05_100"],
            atol=1e-5,
        )


class TestIndexerRepresentations:
    """Goldens from reference src/unrooted_sbn_instance.hpp:99-233, all over
    the five_taxon_unrooted.nwk support."""

    @pytest.fixture(scope="class")
    def five(self, data_dir):
        inst = unrooted_instance("charlie")
        inst.read_newick_file(str(data_dir / "five_taxon_unrooted.nwk"))
        inst.process_loaded_trees()
        return inst

    def test_pretty_rootsplits(self, five):
        correct = {
            "00000|11111|01110", "00000|11111|01010", "00000|11111|00101",
            "00000|11111|00111", "00000|11111|00001", "00000|11111|00011",
            "00000|11111|00010", "00000|11111|00100", "00000|11111|00110",
            "00000|11111|01000", "00000|11111|01111", "00000|11111|01001",
        }
        pretty = five.pretty_indexer()
        assert set(pretty[: len(correct)]) == correct

    def test_pretty_pcsp_block(self, five):
        pretty = set(five.pretty_indexer())
        for p in ("00001|11110|01110", "00001|11110|00010",
                  "00001|11110|01000", "00001|11110|00100"):
            assert p in pretty

    def _string_rep(self, five, parent_ids):
        from bito_tpu.core.tree import Topology

        topo = Topology.of_parent_id_vector(parent_ids)
        sup = five.sbn_support
        sentinel = sup.size()
        rep = sup.indexer_representation_of(topo)
        return [
            {sup.pretty[i] if i < sentinel else "sentinel" for i in rooted}
            for rooted in rep
        ]

    def test_unrooted_representation_1(self, five):
        # Topology (2,(1,3)5,(0,4)6)7.
        got = self._string_rep(five, [6, 5, 7, 5, 6, 7, 7])
        correct = [
            {"00000|11111|01111", "10000|01111|00001", "00001|01110|00100",
             "00100|01010|00010"},
            {"00000|11111|01000", "01000|10111|00010", "00100|10001|00001",
             "00010|10101|00100"},
            {"00000|11111|00100", "10001|01010|00010", "01010|10001|00001",
             "00100|11011|01010"},
            {"00000|11111|00010", "00010|11101|01000", "00100|10001|00001",
             "01000|10101|00100"},
            {"00000|11111|00001", "00001|11110|01110", "10000|01110|00100",
             "00100|01010|00010"},
            {"00000|11111|01010", "10101|01010|00010", "00100|10001|00001",
             "01010|10101|00100"},
            {"00000|11111|01110", "00100|01010|00010", "10001|01110|00100",
             "01110|10001|00001"},
        ]
        assert got == correct

    def test_unrooted_representation_2(self, five):
        # Topology (((0,1)5,2)6,3,4)7.
        got = self._string_rep(five, [5, 5, 6, 7, 7, 6, 7])
        correct = [
            {"00000|11111|01111", "10000|01111|00111", "00100|00011|00001",
             "01000|00111|00011"},
            {"00000|11111|01000", "01000|10111|00111", "00100|00011|00001",
             "10000|00111|00011"},
            {"00000|11111|00100", "00100|11011|00011", "11000|00011|00001",
             "00011|11000|01000"},
            {"00000|11111|00010", "00100|11000|01000", "00001|11100|00100",
             "00010|11101|00001"},
            {"00000|11111|00001", "00100|11000|01000", "00001|11110|00010",
             "00010|11100|00100"},
            {"00000|11111|00111", "00111|11000|01000", "00100|00011|00001",
             "11000|00111|00011"},
            {"00000|11111|00011", "00100|11000|01000", "11100|00011|00001",
             "00011|11100|00100"},
        ]
        assert got == correct

    def test_psp_string_representations(self, five):
        from bito_tpu.core.tree import Topology

        psp = five.psp_indexer
        strings = psp.to_string_vector()

        def rep_str(parent_ids):
            topo = Topology.of_parent_id_vector(parent_ids)
            return [
                [strings[i] for i in row]
                for row in psp.representation_of(topo)
            ]

        assert rep_str([6, 5, 7, 5, 6, 7, 7]) == [
            ["10000|01111", "10111|01000", "11011|00100", "11101|00010",
             "11110|00001", "10101|01010", "10001|01110"],
            ["", "", "", "", "", "01000|00010", "10000|00001"],
            ["01110|00001", "10101|00010", "10001|01010", "10101|01000",
             "10000|01110", "10001|00100", "01010|00100"],
        ]
        assert rep_str([5, 5, 6, 7, 7, 6, 7]) == [
            ["10000|01111", "10111|01000", "11011|00100", "11101|00010",
             "11110|00001", "11000|00111", "11100|00011"],
            ["", "", "", "", "", "10000|01000", "11000|00100"],
            ["01000|00111", "10000|00111", "11000|00011", "11100|00001",
             "11100|00010", "00100|00011", "00010|00001"],
        ]

    def test_rooted_representation_strings(self, five):
        """Reference src/unrooted_sbn_instance.hpp:210-233."""
        from bito_tpu.core.tree import Topology
        from bito_tpu.sbn.maps import rooted_representation

        sup = five.sbn_support
        sentinel = sup.size()

        def rep_strings(parent_ids):
            topo = Topology.of_parent_id_vector(parent_ids)
            rep = rooted_representation(sup.indexer, topo, sentinel)
            return {
                sup.pretty[idx] if idx < sentinel else "sentinel"
                for idx in rep
            }

        # Topology ((((0,1),2),3),4) with internal ids 5..8.
        assert rep_strings([5, 5, 6, 7, 8, 6, 7, 8]) == {
            "00000|11111|00001", "00001|11110|00010", "00010|11100|00100",
            "00100|11000|01000",
        }
        # Topology (((0,1),2),(3,4)).
        assert rep_strings([5, 5, 6, 7, 7, 6, 8, 8]) == {
            "00000|11111|00011", "11100|00011|00001", "00011|11100|00100",
            "00100|11000|01000",
        }

    def test_rooting_invariance(self, data_dir):
        """All rootings of one tree give the same set of rooted
        representations (reference test/test_bito.py:126-154)."""
        inst = unrooted_instance("rootings")
        inst.read_newick_file(str(data_dir / "many_rootings.nwk"))
        inst.process_loaded_trees()
        reps = inst.make_indexer_representations()
        canon = [
            sorted((rr[0], frozenset(rr[1:])) for rr in rep) for rep in reps
        ]
        for other in canon[1:]:
            assert canon[0] == other

    def test_ds1_support_vs_vbpi(self, data_dir):
        inst = unrooted_instance("DS1")
        inst.read_nexus_file(str(data_dir / "DS1.subsampled_10.t.reordered"))
        inst.process_loaded_trees()
        rootsplit_support, subsplit_support = inst.split_counters()
        with open(data_dir / "DS1.subsampled_10.t_support.json") as f:
            supports = json.load(f)
        assert set(rootsplit_support.keys()) == set(
            supports["rootsplit_supp_dict"].keys()
        )
        assert set(subsplit_support.keys()) == set(
            supports["subsplit_supp_dict"].keys()
        )


class TestSampling:
    def test_sampled_tree_probabilities_chi2(self, data_dir):
        """Sampling frequencies should track SBN probabilities
        (reference src/unrooted_sbn_instance.hpp tree sampling test)."""
        inst = unrooted_instance("charlie")
        inst.read_newick_file(str(data_dir / "five_taxon_unrooted.nwk"))
        inst.process_loaded_trees()
        inst.train_simple_average()
        probs = inst.calculate_sbn_probabilities()
        # Sample a bunch of topologies; empirical frequency of the loaded
        # trees should approximate their SBN probability.
        def canon(rep):
            # representations are ordered by node id, which is not
            # topology-invariant; canonicalize as a sorted set of rootings
            return tuple(sorted(tuple(sorted(r)) for r in rep))

        inst_probs = {}
        reps0 = [canon(r) for r in inst.make_indexer_representations()]
        for i, rep in enumerate(reps0):
            inst_probs[rep] = probs[i]
        counts = {rep: 0 for rep in reps0}
        trials = 2000
        other = 0
        for _ in range(trials):
            topo = inst.sample_topology()
            rep = canon(inst.sbn_support.indexer_representation_of(topo))
            if rep in counts:
                counts[rep] += 1
            else:
                other += 1
        # The SA-trained SBN on these four trees puts all mass on them.
        assert other == 0
        for rep in counts:
            emp = counts[rep] / trials
            assert abs(emp - inst_probs[rep]) < 0.05, (emp, inst_probs[rep])

    def test_sample_trees_replaces_collection(self, data_dir):
        inst = unrooted_instance("charlie")
        inst.read_newick_file(str(data_dir / "five_taxon_unrooted.nwk"))
        inst.process_loaded_trees()
        inst.train_simple_average()
        inst.sample_trees(7)
        assert inst.tree_count() == 7
        for t in inst.tree_collection.trees:
            assert t.topology.num_taxa == 5
            # unrooted: trifurcating root
            assert len(t.topology.children()[t.topology.root]) == 3


class TestGradientOfLogQ:
    def test_vs_finite_differences(self, data_dir):
        from bito_tpu.sbn.gradients import (
            NormalizedParamCache,
            gradient_of_log_q,
        )
        from bito_tpu.sbn.probability import normalize_in_log, probability_of

        inst = unrooted_instance("charlie")
        inst.read_newick_file(str(data_dir / "five_taxon_unrooted.nwk"))
        inst.process_loaded_trees()
        rng = np.random.default_rng(42)
        inst.sbn_parameters = rng.normal(size=inst.sbn_support.size())
        rep = inst.make_indexer_representations()[0]

        def log_q(params):
            norm = normalize_in_log(params, inst.sbn_support)
            return np.log(probability_of(inst.sbn_support.size(), norm, rep))

        cache = NormalizedParamCache(inst.sbn_parameters)
        grad = gradient_of_log_q(inst.sbn_support, cache, rep)
        eps = 1e-7
        base = inst.sbn_parameters
        for i in range(inst.sbn_support.size()):
            p = base.copy(); p[i] += eps
            m = base.copy(); m[i] -= eps
            fd = (log_q(p) - log_q(m)) / (2 * eps)
            assert abs(grad[i] - fd) < 1e-5, (i, grad[i], fd)

    def test_vimco_factors_sum_properties(self):
        from bito_tpu.sbn.gradients import (
            multiplicative_factors,
            vimco_multiplicative_factors,
        )

        rng = np.random.default_rng(0)
        log_f = rng.normal(size=8) - 100
        mf = multiplicative_factors(log_f)
        vf = vimco_multiplicative_factors(log_f)
        assert mf.shape == vf.shape == (8,)
        assert np.all(np.isfinite(mf)) and np.all(np.isfinite(vf))


class TestPSP:
    def test_details_and_representation(self, data_dir):
        inst = unrooted_instance("charlie")
        inst.read_newick_file(str(data_dir / "five_taxon_unrooted.nwk"))
        inst.process_loaded_trees()
        details = inst.psp_indexer.details()
        assert details["rootsplit_position"] == 0
        assert details["subsplit_down_position"] == 1
        assert details["subsplit_up_position"] == 2
        reps = inst.make_psp_indexer_representations()
        sentinel = details["first_empty_index"]
        for rep, tree in zip(reps, inst.tree_collection.trees):
            rootsplits, down, up = rep
            E = tree.topology.num_nodes - 1
            assert len(rootsplits) == len(down) == len(up) == E
            # every edge has a rootsplit and an up-PSP in-support
            assert all(r < sentinel for r in rootsplits)
            assert all(u < sentinel for u in up)
            # pendant edges have sentinel down-PSPs
            n = tree.topology.num_taxa
            assert all(down[i] == sentinel for i in range(n))
            assert all(down[i] < sentinel for i in range(n, E))


class TestDeviceBackend:
    """Device (XLA) EM + topology gradients match the numpy implementations
    (bito_tpu/sbn/device.py vs probability.py / gradients.py)."""

    def test_em_parity(self, ds1_100):
        from bito_tpu.sbn import device, probability

        reps, counts = ds1_100._representation_counter()
        sup = ds1_100.sbn_support
        for alpha, it in [(0.0, 5), (0.5, 10)]:
            a, ha = probability.expectation_maximization(
                sup, reps, counts, alpha, it)
            b, hb = device.expectation_maximization(
                sup, reps, counts, alpha, it)
            mask = np.isfinite(a)
            assert (np.isfinite(b) == mask).all()
            np.testing.assert_allclose(b[mask], a[mask], atol=1e-9)
            np.testing.assert_allclose(hb, ha, rtol=1e-11)

    def test_em_score_epsilon_stops_early(self, ds1_100):
        from bito_tpu.sbn import device

        reps, counts = ds1_100._representation_counter()
        _, hist = device.expectation_maximization(
            ds1_100.sbn_support, reps, counts, 0.0, 100, score_epsilon=1e-3)
        assert 1 < len(hist) < 100
        imp = np.diff(hist) / np.abs(hist[:-1])
        assert abs(imp[-1]) < 1e-3

    def test_topology_gradients_parity(self, ds1_100):
        from bito_tpu.sbn import device, gradients

        ds1_100.train_simple_average()
        reps, _ = ds1_100._representation_counter()
        sup = ds1_100.sbn_support
        rng = np.random.default_rng(7)
        sample = reps[:6]
        log_f = rng.normal(size=len(sample)) * 3 - 6000
        for vimco in (True, False):
            g_np = gradients.topology_gradients(
                sup, ds1_100.sbn_parameters, sample, log_f, vimco)
            g_dev = device.topology_gradients(
                sup, ds1_100.sbn_parameters, sample, log_f, vimco)
            np.testing.assert_allclose(g_dev, g_np, atol=1e-10)

    def test_instance_backends_agree(self, ds1_100):
        score_d = ds1_100.train_expectation_maximization(0.1, 4)
        p_dev = ds1_100.calculate_sbn_probabilities()
        score_n = ds1_100.train_expectation_maximization(
            0.1, 4, backend="numpy")
        p_np = ds1_100.calculate_sbn_probabilities()
        np.testing.assert_allclose(score_d, score_n, rtol=1e-11)
        np.testing.assert_allclose(p_dev, p_np, atol=1e-12)


@pytest.mark.parametrize("x64,backend,f32_ok,expected", [
    (False, "device", False, ValueError),
    (False, "device", True, "device"),
    (False, "numpy", False, "numpy"),
    (True, "device", False, "device"),
])
def test_sbn_backend_needs_x64_or_numpy(x64, backend, f32_ok, expected):
    """The device SBN kernels are f64-calibrated: without x64 the device
    backend refuses, naming both remedies, unless f32 is declared fine."""
    import jax

    from bito_tpu.api.instances import _resolve_sbn_backend

    with jax.enable_x64(x64):
        if expected is ValueError:
            with pytest.raises(ValueError,
                               match="jax_enable_x64.*backend='numpy'"):
                _resolve_sbn_backend(backend, f32_ok=f32_ok)
        else:
            assert _resolve_sbn_backend(backend, f32_ok=f32_ok) == expected
