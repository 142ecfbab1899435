"""Smoke test of the product path on one NVIDIA GPU, at DS1 width.

    python chip_smoke.py [--seed N]     # phases 0-5 on one GPU
    python chip_smoke.py --chips 4      # phase 6 only: pattern sharding

Phases:
  0. device: refuse to run without a GPU; name the card and its power limit
  1. data: simulate a DS1-shaped alignment (27 taxa, 1,949 sites, GTR+G4)
     and 10 trees from --seed; write FASTA, Nexus and rooted Newick and
     read them back through the product readers
  2. flagship GTR+G4 LL + branch gradients, f32, batch 200, against the
     same engine in f64 and the plain f64 numpy reference
     (scripts/cpu_baseline.py)
  3. MG94 codon LL + gradients, f32, batch 128, against f64
  4. VBPI (Burrito, 20 particles); first step in f64 on the GPU and on
     the CPU backend must agree
  5. GP: branch lengths, SBN parameters and marginal likelihood, f64 on
     the GPU against the CPU backend
  6. (--chips 4) LL + gradients and the GP marginal sharded over the
     pattern axis of a 4-GPU mesh, against the unsharded calls

Every number printed carries the card's name and power limit.  Any failed
check raises, so the script exits non-zero; the last line of a passing run
is one JSON object naming the device.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CARD = ""


def say(msg):
    print(f"{msg}  [{CARD}]", flush=True)


def check(name, value, tol):
    ok = value <= tol
    say(f"{name}: {value:.3e} (tolerance {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} = {value:.3e} exceeds {tol:.0e}")


def rel_ll(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref) / np.abs(ref)))


def rel_grad(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / np.max(np.abs(ref)))


def mg94_params():
    return {"substitution_model_rates": np.asarray([2.5, 0.3]),
            "substitution_model_frequencies":
                np.asarray([0.3, 0.2, 0.3, 0.2])}


def peak_bytes(device):
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


def memory_line(label, compiled):
    import jax

    m = compiled.memory_analysis()
    peak = peak_bytes(jax.devices()[0])
    say(f"{label} memory: arguments {m.argument_size_in_bytes} B, "
        f"outputs {m.output_size_in_bytes} B, temp {m.temp_size_in_bytes} B, "
        f"code {m.generated_code_size_in_bytes} B; device peak_bytes_in_use "
        f"{peak} B")


def device_phase():
    """Phase 0.  Exits non-zero, printing no result, without a GPU."""
    global CARD
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX platform is "
                 f"{dev.platform!r}); this smoke test runs only on a GPU")
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    CARD = "; ".join(CARD.splitlines())
    print(CARD, flush=True)
    say(f"device_kind {dev.device_kind}, {len(jax.devices())} device(s)")

    from bito_tpu import _native

    say(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    say(f"native parser library loaded: {_native.get_lib() is not None}")
    return dev


def data_phase(seed, directory, num_sites=1949):
    """Phase 1: simulate, write, and read back through the readers."""
    from bito_tpu import parse_nexus_file, read_fasta, unrooted_instance
    from bito_tpu.core.site_pattern import SitePattern
    from bito_tpu.utils import simulate

    t0 = time.perf_counter()
    sim = simulate.simulate(seed, num_taxa=27, num_sites=num_sites)
    files = simulate.write_files(sim, directory)
    coll = parse_nexus_file(files["nexus"])
    seqs = read_fasta(files["fasta"])
    inst = unrooted_instance("smoke")
    inst.read_nexus_file(files["nexus"])
    inst.read_fasta_file(files["fasta"])
    assert inst.tree_count() == len(coll.trees) == 10
    sp = SitePattern(seqs, coll.taxon_names)
    assert sp.num_taxa == 27 and sp.site_count == num_sites
    say(f"data: {sp.num_taxa} taxa, {sp.site_count} sites, "
        f"{sp.pattern_count} patterns, {len(coll.trees)} trees, "
        f"{time.perf_counter() - t0:.2f} s")
    return files, coll, seqs, sp


def flagship_phase(coll, sp, batch=200, iters=40):
    """Phase 2: GTR+G4 LL + branch gradients in f32."""
    import importlib.util

    import jax
    import jax.numpy as jnp

    from bito_tpu.models.phylo_model import PhyloModel, PhyloModelSpecification
    from bito_tpu.models.site import gamma_median_category_rates
    from bito_tpu.treelike.engine import TreeLikelihoodEngine
    from bito_tpu.utils import simulate
    from bito_tpu.utils.timing import time_branch_sweep

    spec = PhyloModelSpecification(substitution="GTR", site="gamma+4")
    trees = [coll.trees[i % len(coll.trees)] for i in range(batch)]
    e32 = TreeLikelihoodEngine(sp, PhyloModel(spec), dtype=jnp.float32)
    params = simulate.gtr_gamma_params()

    t0 = time.perf_counter()
    ll32, g32 = jax.block_until_ready(
        e32.ll_and_branch_gradients(trees, params))
    first = time.perf_counter() - t0
    calls = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(e32.ll_and_branch_gradients(trees, params))
        calls.append(time.perf_counter() - t0)
    say(f"flagship ll_and_branch_gradients f32 batch {batch}: first call "
        f"(compile) {first:.2f} s, steady median {np.median(calls)*1e3:.2f} "
        f"ms/call = {batch / np.median(calls):.0f} evals/s")

    compile_s, times, compiled = time_branch_sweep(e32, trees, params, iters)
    med = float(np.median(times))
    say(f"flagship branch_eval_fn sweep of {iters} x batch {batch}: compile "
        f"{compile_s:.2f} s; reps {[round(t * 1e3, 3) for t in times]} ms; "
        f"median {med / iters * 1e3:.3f} ms/call = "
        f"{batch * iters / med:.0f} evals/s")
    memory_line("flagship sweep", compiled)

    with jax.enable_x64(True):
        e64 = TreeLikelihoodEngine(sp, PhyloModel(spec), dtype=jnp.float64)
        ll64, g64 = jax.device_get(
            e64.ll_and_branch_gradients(trees, params))
        assert ll64.dtype == np.float64
    # f32 sums ~1,000 pattern logs: about 1e-7 relative per term.
    check("flagship f32 vs f64 LL, max relative", rel_ll(ll32, ll64), 1e-5)
    check("flagship f32 vs f64 gradients, max|d|/max|g|",
          rel_grad(g32, g64), 1e-4)

    spec_path = os.path.join(REPO, "scripts", "cpu_baseline.py")
    mod = importlib.util.spec_from_file_location("cpu_baseline", spec_path)
    ref = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(ref)
    U, w, Uinv = ref.gtr_eigen(np.asarray(simulate.GTR_RATES),
                               np.asarray(simulate.FREQUENCIES))
    with jax.enable_x64(True):
        cat = np.asarray(gamma_median_category_rates(
            jnp.asarray(simulate.GAMMA_SHAPE), 4))
    np.testing.assert_allclose(cat, ref.gamma4_rates(simulate.GAMMA_SHAPE),
                               rtol=1e-10)
    tips, weights = sp.tip_partials(), np.asarray(sp.weights)
    ll_ref, g_ref = [], []
    for tree in coll.trees:
        ll, g = ref.ll_and_gradient(tree, tips, weights, U, w, Uinv, cat,
                                    np.asarray(simulate.FREQUENCIES))
        ll_ref.append(ll)
        g_ref.append(g)
    n = len(coll.trees)
    nodes = coll.trees[0].topology.num_nodes
    # Both f64; only the order of summation differs.
    check("flagship f64 device vs numpy reference LL, max relative",
          rel_ll(ll64[:n], ll_ref), 1e-9)
    check("flagship f64 device vs numpy reference gradients, "
          "max|d|/max|g|", rel_grad(g64[:n, :nodes], np.stack(g_ref)), 1e-7)


def codon_phase(coll, seqs, batch=128, iters=10):
    """Phase 3: MG94 (A=64) LL + gradients in f32."""
    import jax
    import jax.numpy as jnp

    from bito_tpu.core.site_pattern import CodonSitePattern
    from bito_tpu.models.phylo_model import PhyloModel, PhyloModelSpecification
    from bito_tpu.treelike.engine import TreeLikelihoodEngine
    from bito_tpu.utils.timing import time_branch_sweep

    sp = CodonSitePattern(seqs, coll.taxon_names)
    spec = PhyloModelSpecification(substitution="MG94")
    trees = [coll.trees[i % len(coll.trees)] for i in range(batch)]
    params = mg94_params()
    e32 = TreeLikelihoodEngine(sp, PhyloModel(spec), dtype=jnp.float32)
    ll32, g32 = jax.device_get(e32.ll_and_branch_gradients(trees, params))
    compile_s, times, compiled = time_branch_sweep(e32, trees, params, iters)
    med = float(np.median(times))
    say(f"codon MG94 {sp.site_count} codons, {sp.pattern_count} patterns, "
        f"f32 batch {batch}: sweep compile {compile_s:.2f} s; median "
        f"{med / iters * 1e3:.3f} ms/call = {batch * iters / med:.0f} "
        f"evals/s")
    memory_line("codon sweep", compiled)
    with jax.enable_x64(True):
        e64 = TreeLikelihoodEngine(sp, PhyloModel(spec), dtype=jnp.float64)
        ll64, g64 = jax.device_get(e64.ll_and_branch_gradients(trees,
                                                               params))
    # The 64x64 evolves are the dots whose precision matters here.
    check("codon f32 vs f64 LL, max relative", rel_ll(ll32, ll64), 5e-5)
    check("codon f32 vs f64 gradients, max|d|/max|g|",
          rel_grad(g32, g64), 1e-4)


def _burrito(files):
    from bito_tpu.models.phylo_model import PhyloModelSpecification
    from bito_tpu.vi.burrito import Burrito

    return Burrito(
        mcmc_nexus_path=files["nexus"], burn_in_fraction=0.0,
        fasta_path=files["fasta"],
        phylo_model_specification=PhyloModelSpecification(
            substitution="JC69", site="constant", clock="strict"),
        branch_model_name="split", scalar_model_name="lognormal",
        optimizer_name="simple", particle_count=20, thread_count=1, seed=0)


def vbpi_phase(files):
    """Phase 4: Burrito gradient steps, then first-step f64 parity."""
    import jax

    burro = _burrito(files)
    before = (np.array(burro.branch_model.scalar_model.q_params),
              np.array(burro.inst.sbn_parameters))
    t0 = time.perf_counter()
    burro.gradient_step()
    warm = time.perf_counter() - t0
    steps = []
    for _ in range(5):
        t0 = time.perf_counter()
        burro.gradient_step()
        steps.append(time.perf_counter() - t0)
    elbo = burro.estimate_elbo(20)
    say(f"VBPI 20 particles, f32: warm-up step {warm:.2f} s; steps "
        f"{[round(s * 1e3, 2) for s in steps]} ms; ELBO {elbo:.4f}")
    if not np.isfinite(elbo):
        raise AssertionError(f"VBPI ELBO is not finite: {elbo}")
    after = (np.asarray(burro.branch_model.scalar_model.q_params),
             np.asarray(burro.inst.sbn_parameters))
    if np.array_equal(before[0], after[0]) or np.array_equal(before[1],
                                                             after[1]):
        raise AssertionError("VBPI steps left the parameters unchanged")

    elbos = {}
    for name, dev in (("gpu", jax.devices()[0]),
                      ("cpu", jax.devices("cpu")[0])):
        with jax.enable_x64(True), jax.default_device(dev):
            b = _burrito(files)
            b.gradient_step()
            elbos[name] = b.estimate_elbo(20)
    say(f"VBPI f64 first-step ELBO: gpu {elbos['gpu']:.10f}, "
        f"cpu {elbos['cpu']:.10f}")
    # Same seeds, so the trees and branch samples are identical.
    check("VBPI f64 first-step ELBO gpu vs cpu, relative",
          abs(elbos["gpu"] - elbos["cpu"]) / abs(elbos["cpu"]), 1e-8)


def _gp_marginal(files, mesh=None):
    from bito_tpu.api.gp import gp_instance

    inst = gp_instance("smoke")
    inst.read_fasta_file(files["fasta"])
    inst.read_newick_file(files["rooted_newick"])
    inst.make_gp_engine()
    if mesh is not None:
        inst.get_gp_engine().shard_patterns(mesh)
    inst.estimate_branch_lengths(1e-4, 100)
    inst.estimate_sbn_parameters()
    inst.populate_plvs()
    inst.compute_likelihoods()
    return inst.get_log_marginal_likelihood()


def gp_phase(files):
    """Phase 5: GP marginal likelihood, f64, GPU against the CPU backend."""
    import jax

    out = {}
    for name, dev in (("gpu", jax.devices()[0]),
                      ("cpu", jax.devices("cpu")[0])):
        with jax.enable_x64(True), jax.default_device(dev):
            t0 = time.perf_counter()
            out[name] = _gp_marginal(files)
            say(f"GP f64 on {name}: log marginal {out[name]:.10f} in "
                f"{time.perf_counter() - t0:.2f} s (compile included)")
    check("GP f64 marginal gpu vs cpu, relative",
          abs(out["gpu"] - out["cpu"]) / abs(out["cpu"]), 1e-9)


def sharded_phase(coll, sp, files, mesh, batch=64):
    """Phase 6: pattern sharding over `mesh` against unsharded calls on
    device 0, for LL + gradients (f32) and the GP marginal (f64)."""
    import jax
    import jax.numpy as jnp

    from bito_tpu.models.phylo_model import PhyloModel, PhyloModelSpecification
    from bito_tpu.treelike.engine import TreeLikelihoodEngine
    from bito_tpu.utils import simulate

    spec = PhyloModelSpecification(substitution="GTR", site="gamma+4")
    params = simulate.gtr_gamma_params()
    trees = [coll.trees[i % len(coll.trees)] for i in range(batch)]
    ref = TreeLikelihoodEngine(sp, PhyloModel(spec), dtype=jnp.float32)
    ll1, g1 = jax.device_get(ref.ll_and_branch_gradients(trees, params))
    eng = TreeLikelihoodEngine(sp, PhyloModel(spec), dtype=jnp.float32)
    eng.shard_patterns(mesh)
    shards = eng.tip_partials.addressable_shards
    devices = {s.device for s in shards}
    if len(shards) != mesh.size or len(devices) != mesh.size:
        raise AssertionError(
            f"tip partials sit on {len(devices)} device(s) in "
            f"{len(shards)} shard(s), not {mesh.size}")
    t0 = time.perf_counter()
    lln, gn = jax.device_get(eng.ll_and_branch_gradients(trees, params))
    say(f"sharded LL+gradients, {sp.pattern_count} patterns, batch {batch}, "
        f"{mesh.size} devices: first call {time.perf_counter() - t0:.2f} s")
    for d in jax.devices():
        say(f"{d}: peak_bytes_in_use {peak_bytes(d)}")
    check("sharded vs unsharded LL, max relative", rel_ll(lln, ll1), 1e-5)
    check("sharded vs unsharded gradients, max|d|/max|g|",
          rel_grad(gn, g1), 1e-4)
    with jax.enable_x64(True):
        m1 = _gp_marginal(files)
        mn = _gp_marginal(files, mesh)
    say(f"GP f64 marginal: unsharded {m1:.10f}, sharded {mn:.10f}")
    check("GP f64 marginal sharded vs unsharded, relative",
          abs(mn - m1) / abs(m1), 1e-9)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()

    dev = device_phase()
    import jax

    with tempfile.TemporaryDirectory() as tmp:
        if args.chips == 4:
            from bito_tpu.dist.mesh import make_mesh

            # About 16k patterns, so each of the four cards holds about 4k.
            files, coll, _, sp = data_phase(args.seed, tmp, num_sites=36000)
            sharded_phase(coll, sp, files, make_mesh(4))
        else:
            files, coll, seqs, sp = data_phase(args.seed, tmp)
            flagship_phase(coll, sp)
            codon_phase(coll, seqs)
            vbpi_phase(files)
            gp_phase(files)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
