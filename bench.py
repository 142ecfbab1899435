"""Benchmark: DS1-shaped GTR+Gamma4 log-likelihood + branch-gradient
throughput on one GPU.

    python bench.py

The data are simulated from a seed at DS1's published shape (27 taxa,
1,949 sites; bito_tpu/utils/simulate.py).  The timed path is the product
API: TreeLikelihoodEngine.branch_eval_fn inside one jitted lax.scan of
BENCH_ITERS evaluations of a BENCH_TREE_BATCH-tree batch, the way a VBPI
inner loop or a branch-length sweep embeds it.  Compile time is reported
apart from the steady state, and every rep is printed.

stderr gets the card with its power limit, the compile time, every rep, an
f32-vs-f64 on-device parity line and the side configs of bench_configs.py
(BENCH_CONFIGS=0 skips them); stdout's last line is one JSON object.  It
exits non-zero without a GPU or when parity fails.  vs_baseline divides by
the single-thread f64 numpy reference rate in scripts/cpu_baseline.json
(`python scripts/cpu_baseline.py` remeasures it on the same data).
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU found (JAX platform is {dev.platform!r})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()

    from bito_tpu.core.newick import parse_nexus_file
    from bito_tpu.core.site_pattern import SitePattern
    from bito_tpu.models.phylo_model import PhyloModel, PhyloModelSpecification
    from bito_tpu.treelike.engine import TreeLikelihoodEngine
    from bito_tpu.utils import simulate
    from bito_tpu.utils.timing import time_branch_sweep

    def log(msg):
        print(f"# {msg}  [{card}]", file=sys.stderr, flush=True)

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "scripts", "cpu_baseline.json")) as f:
        cpu_rate = float(json.load(f)["evals_per_sec"])

    sim = simulate.simulate(0)
    with tempfile.TemporaryDirectory() as tmp:
        coll = parse_nexus_file(simulate.write_files(sim, tmp)["nexus"])
    sp = SitePattern(sim.alignment, coll.taxon_names)
    spec = PhyloModelSpecification(substitution="GTR", site="gamma+4")
    engine = TreeLikelihoodEngine(sp, PhyloModel(spec), dtype=jnp.float32)
    params = simulate.gtr_gamma_params()

    batch = int(os.environ.get("BENCH_TREE_BATCH", "200"))
    iters = int(os.environ.get("BENCH_ITERS", "40"))
    trees = [coll.trees[i % len(coll.trees)] for i in range(batch)]
    compile_s, times, _ = time_branch_sweep(engine, trees, params, iters)
    rate = batch * iters / float(np.median(times))
    log(f"{jax.devices()}: {sp.pattern_count} patterns, batch {batch}, "
        f"{iters} evals per sweep; compile {compile_s:.3f} s; reps "
        f"{[round(t, 6) for t in times]} s")

    ll32, g32 = jax.device_get(engine.ll_and_branch_gradients(trees,
                                                              params))
    with jax.enable_x64(True):
        e64 = TreeLikelihoodEngine(sp, PhyloModel(spec), dtype=jnp.float64)
        ll64, g64 = jax.device_get(e64.ll_and_branch_gradients(trees,
                                                               params))
    rel_ll = float(np.max(np.abs(ll32 - ll64) / np.abs(ll64)))
    rel_g = float(np.max(np.abs(g32 - g64)) / np.max(np.abs(g64)))
    log(f"f32-vs-f64 on-device parity: LL rel {rel_ll:.2e}, "
        f"grad rel {rel_g:.2e}")
    # The tolerances chip_smoke.py asserts for the same call.
    assert rel_ll <= 1e-5 and rel_g <= 1e-4, (rel_ll, rel_g)

    if os.environ.get("BENCH_CONFIGS", "1") == "1":
        import bench_configs

        bench_configs.run_all(log)

    print(json.dumps({
        "metric": "DS1-shape GTR+Gamma4 LL+branch-gradient evals/sec",
        "value": round(rate, 2),
        "unit": "evals/sec",
        "vs_baseline": round(rate / cpu_rate, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
