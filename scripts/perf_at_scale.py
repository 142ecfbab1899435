"""At-scale growth-path stress benchmark (VERDICT round-4 task 5).

Builds the DS1 100-topology support DAG (data/DS1.100_topologies.nwk,
27 taxa — the largest DAG the reference ships data for) and measures the
terms the six_taxon config cannot see:

  - DAG build + GP engine build (host schedule/prior construction)
  - populate + per-PCSP likelihoods per pass (device)
  - one branch-optimization sweep (device)
  - adjacent-NNI enumeration (host), graft rebuild of the DAG with ALL
    candidates, grafted engine build, carry, device scoring pass
  - host-rebuild share of a full GP-scored NNI scoring iteration

Decision anchor (VERDICT task 5): if the host rebuild exceeds ~25% of a
GP-NNI iteration at this scale, the spare-scratch graft overlay gets
built next round.  Needs bito's DS1 fixture files.  Run it alone: one JAX
process per card.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = "/root/reference/data"


def best_of(fn, reps=3):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    import numpy as np

    from bito_tpu.api.gp import gp_instance
    from bito_tpu.core.site_pattern import SitePattern
    from bito_tpu.nni.engine import GPScoredNNIEngine
    from bito_tpu.utils.timing import PhaseTimer

    from bito_tpu.core.tree import Tree, _renumber

    def rooted(tree):
        """Root a trifurcating (unrooted) tree: (a, b, c) -> (a, (b, c))."""
        topo = tree.topology
        ch = [list(k) for k in topo.children()]
        root = topo.num_nodes - 1
        kids = ch[root]
        if len(kids) == 2:
            return tree
        assert len(kids) == 3, kids
        u = topo.num_nodes  # new internal node
        ch.append(kids[1:])
        ch[root] = [kids[0], u]
        new_topo = _renumber(ch, topo.num_taxa, root)
        bl = np.zeros(new_topo.num_nodes)
        old_cl = topo.clades()
        new_cl = new_topo.clades()
        by_clade = {old_cl[v]: tree.branch_lengths[v]
                    for v in range(topo.num_nodes - 1)}
        for v in range(new_topo.num_nodes - 1):
            bl[v] = by_clade.get(new_cl[v], 1e-4)
        return Tree(new_topo, bl)

    def nni_perturb(tree, rng, moves=3):
        """Random rooted-NNI surgery: swap an internal node's child with
        its sibling, `moves` times (synthesizes DAG diversity the
        too-similar credible set lacks — its union DAG is only ~190
        edges; the verdict's stress target is thousands)."""
        topo = tree.topology
        ch = [list(k) for k in topo.children()]
        T = topo.num_taxa
        root = topo.num_nodes - 1
        for _ in range(moves):
            parent_of = {}
            for u, kids in enumerate(ch):
                for k in kids:
                    parent_of[k] = u
            v = int(rng.integers(T, root))
            p = parent_of.get(v)
            if p is None:
                continue
            sibs = [c for c in ch[p] if c != v]
            if not sibs or not ch[v]:
                continue
            s = sibs[0]
            c = ch[v][int(rng.integers(0, len(ch[v])))]
            ch[p] = [x if x != s else c for x in ch[p]]
            ch[v] = [x if x != c else s for x in ch[v]]
        new_topo = _renumber(ch, T, root)
        bl = np.full(new_topo.num_nodes, 0.05)
        return Tree(new_topo, bl)

    out = {}
    inst = gp_instance("")
    inst.read_fasta_file(f"{DATA}/DS1.fasta")
    inst.read_newick_file(f"{DATA}/DS1.100_topologies.nwk")
    rng = np.random.default_rng(0)
    base = [rooted(t) for t in inst.tree_collection.trees]
    extra = [nni_perturb(t, rng) for t in base for _ in range(4)]
    inst.tree_collection.trees = base + extra
    t0 = time.perf_counter()
    inst.make_dag()
    out["dag_build_s"] = round(time.perf_counter() - t0, 3)
    out["topologies"] = len(base) + len(extra)
    dag = inst.get_dag()
    out["nodes"] = dag.node_count()
    out["edges"] = dag.edge_count()

    t0 = time.perf_counter()
    inst.make_gp_engine()
    out["engine_build_s"] = round(time.perf_counter() - t0, 3)
    eng = inst.get_gp_engine()

    def populate_pass():
        eng.populate_plvs()
        eng.compute_likelihoods()
        np.asarray(eng.per_gpcsp_log_likelihoods())

    populate_pass()  # compile
    out["populate_per_pcsp_ms"] = round(best_of(populate_pass) * 1e3, 1)

    def opt_sweep():
        eng.optimize_branch_lengths_once()
        np.asarray(eng.branch_lengths)

    t0 = time.perf_counter()
    opt_sweep()
    out["opt_compile_s"] = round(time.perf_counter() - t0, 1)
    out["opt_sweep_ms"] = round(best_of(opt_sweep) * 1e3, 1)

    # GP-scored NNI scoring pass at scale, phase-split.
    sp = SitePattern(inst.alignment, inst.tree_collection.taxon_names)
    t0 = time.perf_counter()
    nni = GPScoredNNIEngine(dag, sp, inst.tree_collection.trees)
    out["nni_engine_build_s"] = round(time.perf_counter() - t0, 1)
    nni.timer = PhaseTimer()
    t0 = time.perf_counter()
    nni.sync_adjacent_nnis_with_dag()
    out["adjacent_sync_s"] = round(time.perf_counter() - t0, 2)
    out["adjacent_count"] = len(nni.adjacent)

    t0 = time.perf_counter()
    nni.score_adjacent_nnis()
    out["first_score_pass_s"] = round(time.perf_counter() - t0, 1)
    # Second pass = warm numbers (compiles done).
    nni.timer = PhaseTimer()
    nni.scored.clear()
    t0 = time.perf_counter()
    nni.score_adjacent_nnis()
    warm = time.perf_counter() - t0
    out["warm_score_pass_s"] = round(warm, 2)
    phases = {k: round(v, 3) for k, v in nni.timer.totals.items()}
    out["score_phases_s"] = phases
    host = sum(v for k, v in nni.timer.totals.items()
               if k != "score.device")
    out["host_rebuild_share_pct"] = round(100 * host / warm, 1)

    # FULL GP-NNI iterations at scale (the verdict's decision anchor is
    # the rebuild share of a whole iteration, not of the scoring pass).
    nni.set_filter_top_k(1)
    nni.timer = PhaseTimer()
    iters = 0
    t0 = time.perf_counter()
    while iters < 3 and nni.adjacent_nni_count():
        if not nni.run_main_loop():
            break
        nni.run_post_loop()
        iters += 1
    wall = time.perf_counter() - t0
    ph = {k: round(v, 2) for k, v in nni.timer.totals.items()}
    rebuild = (nni.timer.totals.get("score.graft_rebuild", 0)
               + nni.timer.totals.get("accept.dag_rebuild", 0)
               + nni.timer.totals.get("score.engine_build", 0))
    out["full_iters"] = iters
    out["full_iter_s"] = round(wall / max(iters, 1), 2)
    out["full_iter_phases_s"] = ph
    out["rebuild_share_of_iteration_pct"] = round(
        100 * rebuild / max(wall, 1e-9), 1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
