"""Side benchmarks for the other BASELINE.json configs.

bench.py's stdout JSON line stays the single flagship metric (config 2,
DS1-shape GTR+Gamma4 LL+gradient); bench.py calls run_all() for the rest
(the reference ships per-stage benchmark machinery for exactly these,
extras/benchmark.cpp:118-127, src/gp_instance.cpp:303-309).

Configs (BASELINE.json "configs"):
  1. hello JC69 single-tree log likelihood (parity + throughput)
  2. [bench.py] DS1-shape GTR+Gamma4 LL+gradient evals/sec
  3. GP engine on the DS1-shape simulated tree sample: PLV populate +
     per-PCSP likelihoods per dispatch, and one branch-optimization sweep
  4. VBPI 20-particle gradient step (vip/burrito mirror), DS1 shape
  5. End-to-end NNI search iterations/sec: GP-scored six_taxon and the
     faithful TP-likelihood DS1 search (the golden-run path)
  6. MG94 codon LL+gradient, DS1 shape read as codons

Configs 3, 4 and 6 run on data simulated at DS1's shape
(bito_tpu/utils/simulate.py).  Configs 1 and 5 replay bito's own fixture
files and report themselves skipped while those are absent.  Times are
medians over reps, with every rep listed.
"""
import json
import os
import tempfile
import time

DATA = "/root/reference/data"


def _reps(fn, reps=5):
    """(median seconds, [seconds per rep]) of `reps` calls of fn."""
    import numpy as np

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), [round(t, 6) for t in times]


class FixturesMissing(Exception):
    pass


def _fixture(name):
    path = os.path.join(DATA, name)
    if not os.path.exists(path):
        raise FixturesMissing(f"needs bito's fixture file {name}")
    return path


def config1_hello():
    """hello.fasta + hello.nwk JC69 LL (reference
    src/unrooted_sbn_instance.hpp:243; golden LL -84.852358)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bito_tpu.core.newick import parse_newick_file, read_fasta
    from bito_tpu.core.site_pattern import SitePattern
    from bito_tpu.models.phylo_model import (
        PhyloModel,
        PhyloModelSpecification,
    )
    from bito_tpu.treelike.engine import TreeLikelihoodEngine

    coll = parse_newick_file(_fixture("hello.nwk"))
    seqs = read_fasta(_fixture("hello.fasta"))
    engine = TreeLikelihoodEngine(SitePattern(seqs, coll.taxon_names),
                                  PhyloModel(PhyloModelSpecification()))
    trees = coll.trees
    ll = np.asarray(engine.log_likelihoods(trees, {}))
    parity = abs(float(ll[0]) - (-84.852358))
    assert parity < 1e-3, ll

    # Bench the product dispatch (ll_eval_fn serves log_likelihoods' path).
    iters = 200
    trees2 = trees + trees
    enc = engine.encode(trees2)
    bl = engine.branch_length_matrix(trees2, enc)
    eval_fn = engine.ll_eval_fn(trees2, {})

    @jax.jit
    def sweep(b):
        def body(carry, k):
            lls = eval_fn(b * (1.0 + 0.001 * k))
            return carry + lls.sum(), 0.0

        total, _ = jax.lax.scan(body, jnp.zeros((), bl.dtype),
                                jnp.arange(iters, dtype=bl.dtype))
        return total

    sweep(bl).block_until_ready()
    med, reps = _reps(lambda: sweep(bl * 1.0001).block_until_ready())

    # A 2-tree batch measures fixed per-step overhead more than per-tree
    # compute; report a 128-tree batch alongside.
    trees128 = [trees[i % len(trees)] for i in range(128)]
    enc128 = engine.encode(trees128)
    bl128 = engine.branch_length_matrix(trees128, enc128)
    fn128 = engine.ll_eval_fn(trees128, {})

    @jax.jit
    def sweep128(b):
        def body(carry, k):
            return carry + fn128(b * (1.0 + 0.001 * k)).sum(), 0.0

        total, _ = jax.lax.scan(body, jnp.zeros((), b.dtype),
                                jnp.arange(iters, dtype=b.dtype))
        return total

    sweep128(bl128).block_until_ready()
    med128, _ = _reps(
        lambda: sweep128(bl128 * 1.0001).block_until_ready(), reps=3)
    return {
        "metric": "hello JC69 single-tree LL evals/sec",
        "value": round(2 * iters / med, 2),
        "unit": "evals/sec",
        "rep_seconds": reps,
        "parity_abs": parity,
        "batch128_evals_per_sec": round(128 * iters / med128, 1),
    }


def config3_gp(files):
    """GP engine: populate + per-PCSP likelihoods per dispatch and one
    branch-optimization sweep on the DAG of the simulated rooted tree
    sample (reference src/gp_instance.cpp:303-309 timing hooks)."""
    from bito_tpu.api.gp import gp_instance
    from bito_tpu.utils.timing import PhaseTimer

    timer = PhaseTimer()
    inst = gp_instance("")
    inst.read_fasta_file(files["fasta"])
    inst.read_newick_file(files["rooted_newick"])
    with timer.phase("make_dag"):
        inst.make_dag()
    with timer.phase("make_engine+first_populate"):
        inst.make_gp_engine()
        inst.populate_plvs()
        inst.compute_likelihoods()
    eng = inst.get_gp_engine()

    def populate_pass():
        eng.populate_plvs()
        eng.compute_likelihoods()
        eng.per_gpcsp_log_likelihoods()

    populate_pass()
    t_pop, pop_reps = _reps(populate_pass)

    def opt_sweep():
        import numpy as np

        eng.optimize_branch_lengths_once()
        np.asarray(eng.branch_lengths)  # block on the async dispatch

    with timer.phase("opt_compile"):
        opt_sweep()
    t_opt, _ = _reps(opt_sweep)
    marg = float(inst.get_log_marginal_likelihood())
    return {
        "metric": "GP DS1-shape populate+per-PCSP ms/pass",
        "value": round(t_pop * 1e3, 3),
        "unit": "ms",
        "rep_seconds": pop_reps,
        "optimize_ms": round(t_opt * 1e3, 2),
        "edges": int(eng.dag.edge_count()),
        "log_marginal": marg,
        "phases": {k: round(v, 3) for k, v in timer.totals.items()},
    }


def config4_vbpi(files):
    """VBPI 20-particle gradient step, DS1 shape (vip/benchmark.py:18-82)."""
    from bito_tpu.models.phylo_model import PhyloModelSpecification
    from bito_tpu.vi.burrito import Burrito

    burro = Burrito(
        mcmc_nexus_path=files["nexus"],
        burn_in_fraction=0.0,
        fasta_path=files["fasta"],
        phylo_model_specification=PhyloModelSpecification(
            substitution="JC69", site="constant", clock="strict"),
        branch_model_name="split",
        scalar_model_name="lognormal",
        optimizer_name="simple",
        particle_count=20,
        thread_count=1,
    )
    burro.gradient_step()  # warm up (compiles)
    med, reps = _reps(lambda: burro.gradient_step(), reps=5)
    # Per-phase budget: where the step's milliseconds go, over 5 steps.
    from bito_tpu.utils.timing import PhaseTimer

    timer = PhaseTimer()
    for _ in range(5):
        burro.gradient_step(timer=timer)
    phases_ms = {k: round(v / 5 * 1e3, 2)
                 for k, v in timer.totals.items()}
    return {
        "metric": "VBPI DS1-shape 20-particle gradient step",
        "value": round(med * 1e3, 3),
        "unit": "ms/step",
        "rep_seconds": reps,
        "phases_ms": phases_ms,
    }


def config5_nni():
    """End-to-end NNI search iterations/sec (reference
    src/nni_engine.cpp:230-257 Run loop): GP-scored six_taxon to
    completion, and 20 iterations of the faithful TP-likelihood DS1
    search (the golden-run product path)."""
    from bito_tpu.api.gp import gp_instance

    out = {}
    # six_taxon, GP scoring, run to completion
    inst = gp_instance("")
    inst.read_fasta_file(_fixture("six_taxon.fasta"))
    inst.read_newick_file(_fixture("six_taxon_rooted_simple.nwk"))
    inst.make_dag()
    inst.make_gp_engine()
    inst.take_first_branch_length()
    eng = inst.make_nni_engine("gp_likelihood")
    eng.set_top_k_score_filtering_scheme(1)
    t0 = time.perf_counter()
    eng.run_init()
    iters = 0
    while iters < 10 and eng.adjacent_nni_count():
        if not eng.run_main_loop():
            break
        iters += 1
    t_six = time.perf_counter() - t0
    out["six_taxon_gp_iters"] = iters
    out["six_taxon_gp_iters_per_sec"] = round(iters / t_six, 3)

    # DS1 faithful TP-likelihood search, 20 iterations, on the device.
    # The faithful path's precision contract is f64; the context keeps
    # x64 from leaking into the configs that share this process.
    import jax

    from bito_tpu.nni.golden import golden_nni_search

    fasta, top1 = _fixture("ds1/ds1.fasta"), _fixture("ds1/ds1.top1.nwk")
    with jax.enable_x64(True):
        t0 = time.perf_counter()
        search = golden_nni_search(fasta, top1, iter_max=20, opt_max=1)
        t_ds1 = time.perf_counter() - t0
    out.update({
        "metric": "NNI search iterations/sec (DS1 TP-likelihood, 20 it)",
        "value": round(20 / t_ds1, 3),
        "unit": "iters/sec",
        "ds1_acceptances": len(search.records),
    })
    return out


def config6_codon(files):
    """A=64 MG94 codon LL+gradient through the product engine
    (PhyloModelSpecification route), with an f32-vs-f64 on-device parity
    check.  Data: the DS1-shape alignment read as codons (649 triplets,
    27 taxa)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bito_tpu.core.newick import parse_nexus_file, read_fasta
    from bito_tpu.core.site_pattern import CodonSitePattern
    from bito_tpu.models.phylo_model import (
        PhyloModel,
        PhyloModelSpecification,
    )
    from bito_tpu.treelike.engine import TreeLikelihoodEngine
    from bito_tpu.utils.timing import time_branch_sweep

    coll = parse_nexus_file(files["nexus"])
    sp = CodonSitePattern(read_fasta(files["fasta"]), coll.taxon_names)
    spec = PhyloModelSpecification(substitution="MG94")
    engine = TreeLikelihoodEngine(sp, PhyloModel(spec), dtype=jnp.float32)

    def params():
        return {"substitution_model_rates": jnp.asarray([2.5, 0.3]),
                "substitution_model_frequencies": jnp.asarray(
                    [0.3, 0.2, 0.3, 0.2])}

    batch, iters = 128, 10
    trees = [coll.trees[i % len(coll.trees)] for i in range(batch)]
    compile_s, times, _ = time_branch_sweep(engine, trees, params(), iters)
    ll32, g32 = jax.device_get(engine.ll_and_branch_gradients(trees,
                                                              params()))
    with jax.enable_x64(True):
        e64 = TreeLikelihoodEngine(sp, PhyloModel(spec), dtype=jnp.float64)
        ll64, g64 = jax.device_get(e64.ll_and_branch_gradients(trees,
                                                               params()))
    rel_ll = float(np.max(np.abs(ll32 - ll64) / np.abs(ll64)))
    rel_g = float(np.max(np.abs(g32 - g64)) / np.max(np.abs(g64)))
    # The tolerances chip_smoke.py asserts for the same call.
    assert rel_ll <= 5e-5 and rel_g <= 1e-4, (rel_ll, rel_g)
    return {
        "metric": "MG94 codon (A=64) LL+gradient evals/sec",
        "value": round(batch * iters / float(np.median(times)), 1),
        "unit": "evals/sec",
        "compile_s": round(compile_s, 3),
        "rep_seconds": [round(t, 6) for t in times],
        "batch": batch,
        "patterns": sp.pattern_count,
        "parity_ll_rel": rel_ll,
        "parity_grad_rel": rel_g,
    }


def run_all(log=print):
    """Run every config; `log` receives one line per config."""
    from bito_tpu.utils import simulate

    with tempfile.TemporaryDirectory() as tmp:
        files = simulate.write_files(simulate.simulate(0), tmp)
        for name, fn in (("config1_hello_jc69", config1_hello),
                         ("config3_gp", lambda: config3_gp(files)),
                         ("config4_vbpi", lambda: config4_vbpi(files)),
                         ("config5_nni_search", config5_nni),
                         ("config6_codon_mg94",
                          lambda: config6_codon(files))):
            t0 = time.perf_counter()
            try:
                result = fn()
            except FixturesMissing as exc:
                result = {"skipped": f"{exc} (ROADMAP C1)"}
            result["wall_s"] = round(time.perf_counter() - t0, 3)
            log(f"{name}: {json.dumps(result)}")


if __name__ == "__main__":
    run_all()
