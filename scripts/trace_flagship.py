"""Trace one flagship LL + branch-gradient call on the GPU and count what
ran on the device.

    python scripts/trace_flagship.py [--batch 200] [--out DIR]

Builds the DS1-shaped simulated flagship (27 taxa, 1,949 sites, GTR+G4,
f32), compiles `branch_eval_fn` for the batch, then traces a single call
with jax.profiler and reduces the trace: for each line of each GPU plane,
the number of events and their summed device time; the busy share of the
call's window on the kernel streams; and the kernels that took the most
time.  Needs a GPU; it exits non-zero without one.
"""
import argparse
import collections
import glob
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def busy_ns(events):
    """Length of the union of [start, end) intervals."""
    total, end = 0, None
    for s, e in sorted((e.start_ns, e.end_ns) for e in events):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=200)
    ap.add_argument("--out", default=None, help="keep the trace here")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        sys.exit("trace_flagship: no GPU found")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()

    from bito_tpu.core.site_pattern import SitePattern
    from bito_tpu.core.newick import parse_nexus_file
    from bito_tpu.models.phylo_model import PhyloModel, PhyloModelSpecification
    from bito_tpu.treelike.engine import TreeLikelihoodEngine
    from bito_tpu.utils import simulate

    with tempfile.TemporaryDirectory() as tmp:
        sim = simulate.simulate(0)
        coll = parse_nexus_file(simulate.write_files(sim, tmp)["nexus"])
    sp = SitePattern(sim.alignment, coll.taxon_names)
    spec = PhyloModelSpecification(substitution="GTR", site="gamma+4")
    engine = TreeLikelihoodEngine(sp, PhyloModel(spec), dtype=jnp.float32)
    trees = [coll.trees[i % len(coll.trees)] for i in range(args.batch)]
    params = simulate.gtr_gamma_params()
    bl = engine.branch_length_matrix(trees, engine.encode(trees))
    call = jax.jit(engine.branch_eval_fn(trees, params))
    jax.block_until_ready(call(bl))
    jax.block_until_ready(call(bl * 1.001))

    out = args.out or tempfile.mkdtemp()
    with jax.profiler.trace(out):
        jax.block_until_ready(call(bl * 1.002))
    path = sorted(glob.glob(os.path.join(out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    for plane in data.planes:
        if "GPU" not in plane.name:
            continue
        kernels = []
        for line in plane.lines:
            events = list(line.events)
            total = sum(e.duration_ns for e in events)
            print(f"{plane.name} | {line.name}: {len(events)} events, "
                  f"{total / 1e3:.1f} us  [{card}]")
            if line.name.startswith("Stream"):
                kernels += events
        if not kernels:
            continue
        window = (max(e.end_ns for e in kernels)
                  - min(e.start_ns for e in kernels))
        print(f"{plane.name}: {len(kernels)} stream events in one call; "
              f"window {window / 1e3:.1f} us, busy "
              f"{busy_ns(kernels) / 1e3:.1f} us  [{card}]")
        by_name = collections.Counter()
        count = collections.Counter()
        for e in kernels:
            by_name[e.name] += e.duration_ns
            count[e.name] += 1
        for name, ns in by_name.most_common(12):
            print(f"  {ns / 1e3:9.1f} us  x{count[name]:<4d} {name[:100]}")


if __name__ == "__main__":
    main()
