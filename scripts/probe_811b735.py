"""811b735 forensic probe (round-4 VERDICT item 8, bounded).

The DS1 golden run (run.811b735.csv) was produced at a reference commit
older than the mounted HEAD; our faithful replay matches it exactly for 23
acceptances and then diverges on candidates rescored after DAG growth.
This probe enumerates the plausible post-growth update-variant space and
reports, for each variant, the exact-prefix length and the score skew
inside the prefix — if some variant reproduced the golden trajectory past
23, that variant would be the 811b735 behavior; if none do, the divergence
boundary is certified as unexplorable without the 811b735 source.

Runs with JAX x64 enabled; needs bito's DS1 fixture files.
"""
import os
import sys

import jax
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bito_tpu.nni.golden import golden_nni_search, load_golden_run

DS1 = "/root/reference/data/ds1"
GOLDEN = "/root/reference/data/ds1/test/run.811b735.csv"


def stats(recs, golden):
    matches = [i for i in range(min(len(recs), len(golden)))
               if recs[i].pcsp == golden[i][0]]
    prefix = 0
    while prefix < len(matches) and matches[prefix] == prefix:
        prefix += 1
    skew = max((abs(recs[i].score - golden[i][1])
                for i in range(prefix)), default=0.0)
    return len(matches), prefix, skew


def run_variant(name, setup, iters=60):
    from bito_tpu.core.newick import parse_newick_file, read_fasta
    from bito_tpu.core.site_pattern import SitePattern
    from bito_tpu.dag.reference_order import build_dag_reference_ordered
    from bito_tpu.nni.golden import GoldenNNISearch

    collection = parse_newick_file(f"{DS1}/ds1.top1.nwk")
    alignment = read_fasta(f"{DS1}/ds1.fasta")
    sp = SitePattern(alignment, collection.taxon_names)
    dag = build_dag_reference_ordered(collection)
    search = GoldenNNISearch(dag, sp, collection.trees, opt_max=1)
    setup(search.engine)
    search.run(iter_max=iters)
    return search.records


def main():
    golden = load_golden_run(GOLDEN)
    variants = {
        "baseline": lambda e: None,
        "no_local_reopt": lambda e: setattr(
            e, "update_optimize_new_edges", False),
        "update_all_edges": lambda e: setattr(e, "update_all_edges", True),
        "opt5_in_update": lambda e: setattr(e, "optimize_max_iter", 5),
        "no_best_edge_map": lambda e: setattr(e, "use_best_edge_map",
                                              False),
    }
    for name, setup in variants.items():
        try:
            recs = run_variant(name, setup)
            m, p, skew = stats(recs, golden)
            print(f"{name:20s} acceptances={len(recs):3d} "
                  f"positional_matches={m:3d} exact_prefix={p:3d} "
                  f"max_prefix_skew={skew:.3e}", flush=True)
        except Exception as exc:
            print(f"{name:20s} FAILED: {type(exc).__name__}: {exc}",
                  flush=True)


if __name__ == "__main__":
    main()
