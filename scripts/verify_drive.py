"""End-to-end verify driver (the /verify skill's flows, in one script).

Drives the library surface: parsing reference data, hello + DS1 likelihood
parity vs goldens, gradient finite-difference check, and a one-dispatch
batched NNI scoring pass against the serial faithful path.
"""
import jax

jax.config.update("jax_enable_x64", True)

import numpy as np

from bito_tpu.core.newick import parse_newick_file, parse_nexus_file, read_fasta
from bito_tpu.core.site_pattern import SitePattern
from bito_tpu.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu.treelike.engine import TreeLikelihoodEngine

DATA = "/root/reference/data"

# 1. hello parity (reference src/unrooted_sbn_instance.hpp:243).
coll = parse_newick_file(f"{DATA}/hello.nwk")
seqs = read_fasta(f"{DATA}/hello.fasta")
eng = TreeLikelihoodEngine(SitePattern(seqs, coll.taxon_names),
                           PhyloModel(PhyloModelSpecification()))
ll = float(np.asarray(eng.log_likelihoods(coll.trees, {}))[0])
assert abs(ll - (-84.852358)) < 1e-5, ll
print(f"hello LL {ll:.6f} OK")

# 2. DS1 10-tree JC69 parity vs pybeagle goldens.
coll = parse_nexus_file(f"{DATA}/DS1.subsampled_10.t")
seqs = read_fasta(f"{DATA}/DS1.fasta")
sp = SitePattern(seqs, coll.taxon_names)
eng = TreeLikelihoodEngine(sp, PhyloModel(PhyloModelSpecification()))
lls = np.asarray(eng.log_likelihoods(coll.trees, {}))
gold = np.array([
    -14582.995273982739, -6911.294207416366, -6916.880235529542,
    -6904.016888831189, -6915.055570693576, -6915.50496696512,
    -6910.958836661867, -6909.02639968063, -6912.967861935749,
    -6910.7871105783515])
assert np.abs(lls - gold).max() < 1e-8, np.abs(lls - gold).max()
print(f"DS1 JC69 parity max|diff| {np.abs(lls - gold).max():.2e} OK")

# 3. Gradient finite-difference check (GTR+Gamma4).
import jax.numpy as jnp
params = {
    "substitution_model_rates": jnp.asarray([0.1, 0.3, 0.1, 0.2, 0.25, 0.05]),
    "substitution_model_frequencies": jnp.asarray([0.3, 0.25, 0.2, 0.25]),
    "site_model_parameters": jnp.asarray([0.5]),
}
eng_g = TreeLikelihoodEngine(
    sp, PhyloModel(PhyloModelSpecification(substitution="GTR",
                                           site="gamma+4")))
trees = coll.trees[:2]
ll0, grads = eng_g.ll_and_branch_gradients(trees, params)
enc = eng_g.encode(trees)
bl = np.asarray(eng_g.branch_length_matrix(trees, enc))
eps = 1e-6
node = 3
bl2 = bl.copy(); bl2[0, node] += eps
llp = eng_g.ll_and_branch_gradients(trees, params, jnp.asarray(bl2))[0]
fd = (float(llp[0]) - float(ll0[0])) / eps
ad = float(grads[0, node])
assert abs(fd - ad) / max(abs(ad), 1e-9) < 1e-4, (fd, ad)
print(f"gradient FD check: analytic {ad:.8f} vs fd {fd:.8f} OK")

# 4. Batched NNI scoring == serial faithful scoring (one dispatch).
from bito_tpu.dag.reference_order import build_dag_reference_ordered
from bito_tpu.nni.golden import GoldenNNISearch

c5 = parse_newick_file(f"{DATA}/five_taxon_trees_3_4_diff_branches.nwk")
a5 = read_fasta(f"{DATA}/five_taxon.fasta")
sp5 = SitePattern(a5, c5.taxon_names)
dag = build_dag_reference_ordered(c5)
search = GoldenNNISearch(dag, sp5, c5.trees, opt_max=5)
search.run_init()
nnis = sorted(search.adjacent, key=lambda n: (n[0].to_string(),
                                              n[1].to_string()))
bem = search.engine.build_best_edge_map(nnis)
serial = [search.engine.score_proposed_nni(n, bem) for n in nnis]
batched = search.engine.score_proposed_nnis_batched(nnis, bem)
np.testing.assert_allclose(batched, serial, rtol=1e-12)
print(f"batched NNI scorer parity on {len(nnis)} candidates OK")
print("VERIFY PASS")
