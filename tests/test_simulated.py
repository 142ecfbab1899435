"""The seeded simulator, and the scan tape on simulated data against the
plain f64 numpy reference (scripts/cpu_baseline.py) and against itself in
f32 at the tolerances chip_smoke.py asserts on the GPU."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bito_tpu.core.newick import parse_newick_file, parse_nexus_file
from bito_tpu.core.newick import read_fasta
from bito_tpu.core.site_pattern import CodonSitePattern, SitePattern
from bito_tpu.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu.models.site import gamma_median_category_rates
from bito_tpu.treelike.engine import TreeLikelihoodEngine
from bito_tpu.utils import simulate

REPO = pathlib.Path(__file__).resolve().parent.parent


def _reference():
    spec = importlib.util.spec_from_file_location(
        "cpu_baseline", REPO / "scripts" / "cpu_baseline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(tmp_path, seed, num_taxa, num_sites):
    sim = simulate.simulate(seed, num_taxa=num_taxa, num_sites=num_sites)
    return sim, simulate.write_files(sim, str(tmp_path))


@pytest.mark.parametrize("seed,num_taxa,num_sites",
                         [(0, 27, 1949), (3, 8, 300), (5, 5, 120)])
def test_simulator_is_seeded_and_sized(tmp_path, seed, num_taxa,
                                       num_sites):
    sim, files = _files(tmp_path, seed, num_taxa, num_sites)
    again = simulate.simulate(seed, num_taxa=num_taxa, num_sites=num_sites)
    assert sim.alignment == again.alignment
    for (p, l), (p2, l2) in zip(sim.trees, again.trees):
        np.testing.assert_array_equal(p, p2)
        np.testing.assert_array_equal(l, l2)
    other = simulate.simulate(seed + 1, num_taxa=num_taxa,
                              num_sites=num_sites)
    assert other.alignment != sim.alignment

    seqs = read_fasta(files["fasta"])
    assert list(seqs) == sim.names and len(sim.names) == num_taxa
    assert {len(s) for s in seqs.values()} == {num_sites}
    unrooted = parse_nexus_file(files["nexus"])
    rooted = parse_newick_file(files["rooted_newick"])
    assert len(unrooted.trees) == len(rooted.trees) == 10
    assert unrooted.taxon_names == sim.names
    for u, r in zip(unrooted.trees, rooted.trees):
        assert r.topology.num_nodes == 2 * num_taxa - 1
        assert u.topology.num_nodes == 2 * num_taxa - 2
        assert len(u.topology.children()[u.topology.root]) == 3
    # The sample is the true tree plus NNI neighbours: distinct topologies.
    assert len({t.topology.key() for t in unrooted.trees}) > 1
    assert SitePattern(seqs, sim.names).site_count == num_sites


@pytest.mark.parametrize("substitution,site", [("GTR", "gamma+4"),
                                               ("JC69", "constant")])
def test_scan_tape_matches_numpy_reference(tmp_path, substitution, site):
    """f64 LL and branch gradients against cpu_baseline.ll_and_gradient,
    an independent serial numpy implementation (8 taxa, 300 sites)."""
    ref = _reference()
    sim, files = _files(tmp_path, 3, 8, 300)
    coll = parse_nexus_file(files["nexus"])
    sp = SitePattern(read_fasta(files["fasta"]), coll.taxon_names)
    spec = PhyloModelSpecification(substitution=substitution, site=site)
    engine = TreeLikelihoodEngine(sp, PhyloModel(spec), dtype=jnp.float64)
    if substitution == "GTR":
        rates, pi = np.asarray(simulate.GTR_RATES), np.asarray(
            simulate.FREQUENCIES)
        cat = np.asarray(gamma_median_category_rates(
            jnp.asarray(simulate.GAMMA_SHAPE), 4))
        np.testing.assert_allclose(
            cat, ref.gamma4_rates(simulate.GAMMA_SHAPE), rtol=1e-10)
        params = simulate.gtr_gamma_params()
    else:
        rates, pi, cat, params = np.ones(6), np.full(4, 0.25), [1.0], {}
    ll, grads = engine.ll_and_branch_gradients(coll.trees, params)
    ll, grads = np.asarray(ll), np.asarray(grads)
    U, w, Uinv = ref.gtr_eigen(rates, pi)
    tips, weights = sp.tip_partials(), np.asarray(sp.weights)
    for b, tree in enumerate(coll.trees):
        ll_ref, g_ref = ref.ll_and_gradient(tree, tips, weights, U, w,
                                            Uinv, np.asarray(cat), pi)
        n = tree.topology.num_nodes
        assert abs(ll[b] - ll_ref) <= 1e-9 * abs(ll_ref)
        assert (np.max(np.abs(grads[b, :n] - g_ref))
                <= 1e-7 * np.max(np.abs(g_ref)))


@pytest.mark.parametrize("model", ["GTR+G4", "MG94"])
def test_f32_matches_f64_at_smoke_tolerances(tmp_path, model):
    """f32 scan tape against f64 on the same backend: LL <= 1e-5 (codon
    5e-5) relative, gradients <= 1e-4 of max|g|.  The 27-taxon sample has
    branches near 6e-4, where P(t) built as U exp(Lt) U^-1 cancelled away
    the f32 digits of the off-diagonal entries (4e-4 gradient error)."""
    sim, files = _files(tmp_path, 0, 27, 300)
    coll = parse_nexus_file(files["nexus"])
    seqs = read_fasta(files["fasta"])
    if model == "MG94":
        sp = CodonSitePattern(seqs, coll.taxon_names)
        spec = PhyloModelSpecification(substitution="MG94")
        params = {"substitution_model_rates": [2.5, 0.3],
                  "substitution_model_frequencies": [0.3, 0.2, 0.3, 0.2]}
        trees, ll_tol = coll.trees[:4], 5e-5
    else:
        sp = SitePattern(seqs, coll.taxon_names)
        spec = PhyloModelSpecification(substitution="GTR", site="gamma+4")
        params = simulate.gtr_gamma_params()
        trees, ll_tol = coll.trees, 1e-5
    out = {}
    for dtype in (jnp.float32, jnp.float64):
        engine = TreeLikelihoodEngine(sp, PhyloModel(spec), dtype=dtype)
        p = {k: jnp.asarray(v, dtype) for k, v in params.items()}
        out[dtype] = jax.device_get(engine.ll_and_branch_gradients(trees, p))
    (ll32, g32), (ll64, g64) = out[jnp.float32], out[jnp.float64]
    assert ll32.dtype == np.float32 and ll64.dtype == np.float64
    assert np.max(np.abs(ll32 - ll64) / np.abs(ll64)) <= ll_tol
    assert np.max(np.abs(g32 - g64)) <= 1e-4 * np.max(np.abs(g64))
