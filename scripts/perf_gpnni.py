"""GP-scored NNI iteration budget (VERDICT round-4 task 8).

Runs the six_taxon GP-scored search (BENCH config5's slow half) with the
engine's PhaseTimer hooks and prints the per-phase split: host graft
rebuild / engine build / carry / device scoring / DAG rebuild / GP grow /
branch-length re-estimation.  Needs bito's six_taxon fixture files.  Run
it alone: one JAX process per card.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = "/root/reference/data"


def main():
    from bito_tpu.api.gp import gp_instance
    from bito_tpu.utils.timing import PhaseTimer

    inst = gp_instance("")
    inst.read_fasta_file(f"{DATA}/six_taxon.fasta")
    inst.read_newick_file(f"{DATA}/six_taxon_rooted_simple.nwk")
    inst.make_dag()
    inst.make_gp_engine()
    inst.take_first_branch_length()
    t0 = time.perf_counter()
    eng = inst.make_nni_engine("gp_likelihood")
    print(f"# engine build (incl. first estimate_branch_lengths): "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    eng.set_top_k_score_filtering_scheme(1)
    eng.timer = PhaseTimer()
    t0 = time.perf_counter()
    eng.run_init()
    iters = 0
    while iters < 10 and eng.adjacent_nni_count():
        t1 = time.perf_counter()
        if not eng.run_main_loop():
            break
        eng.run_post_loop()
        iters += 1
        print(f"# iter {iters}: {time.perf_counter() - t1:.2f}s", flush=True)
    wall = time.perf_counter() - t0
    phases = {k: round(v, 3) for k, v in eng.timer.totals.items()}
    accounted = sum(eng.timer.totals.values())
    print(json.dumps({
        "iters": iters,
        "wall_s": round(wall, 2),
        "iters_per_sec": round(iters / wall, 3),
        "phases_s": phases,
        "unaccounted_s": round(wall - accounted, 2),
    }, indent=1))


if __name__ == "__main__":
    main()
