"""NNI systematic-search harness with posterior-recovery tracking.

The JAX counterpart of the reference's search driver
(reference: test/nni_search.py — Loader, PosteriorProbabilityMaps,
Results, Program.nni_search, lines 185-1290): load a seed DAG and a
credible posterior (trees + per-tree and per-PCSP posterior weights from
an MCMC run), run the staged NNI search loop, and record per-iteration
acceptance data — which accepted NNIs are in the credible set, the DAG's
accumulated tree posterior, per-PCSP posterior ranks, and DAG size — so
search quality is measurable against the MrBayes ground truth.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.bitset import subsplit
from ..core.newick import parse_newick_file


def load_pps(pp_csv: str) -> List[float]:
    """One posterior weight per line, aligned with the credible trees
    (reference Loader.load_pps, test/nni_search.py:282-288)."""
    with open(pp_csv) as fp:
        return [float(line) for line in fp if line.strip()]


def load_pcsp_pp_map(pcsp_pp_csv: str) -> Dict[Tuple[str, str], float]:
    """CSV rows (index, parent, child, pcsp_pp) with 'clade|clade' subsplit
    strings -> {(parent, child): pp} (reference Loader.load_pcsp_pp_map,
    test/nni_search.py:290-302)."""
    import csv as _csv

    out: Dict[Tuple[str, str], float] = {}
    with open(pcsp_pp_csv) as fp:
        reader = _csv.DictReader(fp)
        for row in reader:
            parent = subsplit(*row["parent"].split("|")).to_string()
            child = subsplit(*row["child"].split("|")).to_string()
            out[(parent, child)] = float(row["pcsp_pp"])
    return out


class PosteriorProbabilityMaps:
    """Credible-posterior lookups for search tracking (reference
    PosteriorProbabilityMaps, test/nni_search.py:480-563)."""

    def __init__(self, fasta_path: str, credible_newick: str, pp_csv: str,
                 pcsp_pp_csv: str, sort_taxa: bool = False):
        self.credible_trees = parse_newick_file(
            credible_newick, sort_taxa=sort_taxa
        ).trees
        # The pp list may cover the full MCMC sample; the credible newick is
        # its head, so pairs truncate to the shorter (reference
        # Loader.build_tree_pp_map zips, test/nni_search.py:304-309).
        self.tree_pps = load_pps(pp_csv)[: len(self.credible_trees)]
        self.pcsp_pp = load_pcsp_pp_map(pcsp_pp_csv)

    def get_tree_pp(self, dag) -> float:
        """Total posterior of credible trees the DAG contains."""
        return sum(
            pp for tree, pp in zip(self.credible_trees, self.tree_pps)
            if dag.contains_tree(tree)
        )

    def get_tree_pp_total(self) -> float:
        return float(sum(self.tree_pps))

    def get_pcsp_pp(self, nni_or_key) -> float:
        key = (nni_or_key.key() if hasattr(nni_or_key, "key")
               else tuple(nni_or_key))
        return self.pcsp_pp.get(key, 0.0)

    def get_pcsp_pp_rank(self, best_key, adjacent_keys) -> int:
        """1-based rank of the accepted NNI's posterior among the adjacent
        set's posteriors."""
        best = self.get_pcsp_pp(best_key)
        return 1 + sum(
            1 for k in adjacent_keys if self.get_pcsp_pp(k) > best
        )

    def _dag_edge_keys(self, dag) -> List[Tuple[str, str]]:
        return [
            (dag.nodes[int(dag.edge_parent[e])].to_string(),
             dag.nodes[int(dag.edge_child[e])].to_string())
            for e in range(dag.edge_count())
        ]

    def get_credible_edge_count(self, dag) -> Tuple[int, int]:
        """(credible, non-credible) edge counts of the DAG."""
        cred = sum(1 for k in self._dag_edge_keys(dag) if k in self.pcsp_pp)
        return cred, dag.edge_count() - cred

    def get_credible_edge_total(self) -> int:
        return len(self.pcsp_pp)

    def get_credible_adjacent_nni_count(self, adjacent_keys) -> int:
        return sum(1 for k in adjacent_keys if self.get_pcsp_pp(k) > 0.0)


@dataclass
class SearchResults:
    """Per-accepted-NNI rows (reference Results.data_,
    test/nni_search.py:350)."""

    rows: List[dict] = field(default_factory=list)

    def add_entry(self, iteration: int, dag, engine, pp_maps,
                  scored_before: Dict[Tuple[str, str], float]):
        accepted_scores = getattr(engine, "accepted_scores_this_iter", {})
        adjacent_keys = list(scored_before) + [
            k for k in accepted_scores if k not in scored_before
        ]
        cred_edges, _ = pp_maps.get_credible_edge_count(dag)
        for nni in engine.accepted_nnis():
            key = nni.key()
            self.rows.append(dict(
                iter=iteration,
                acc_nni_count=engine.accepted_nni_count(),
                score=accepted_scores.get(key, float("nan")),
                is_nni_cred=pp_maps.get_pcsp_pp(key) > 0.0,
                tree_pp=pp_maps.get_tree_pp(dag),
                pcsp_pp=pp_maps.get_pcsp_pp(key),
                pcsp_pp_rank=pp_maps.get_pcsp_pp_rank(key, adjacent_keys),
                node_count=dag.node_count_without_dag_root(),
                edge_count=dag.edge_count(),
                cred_edge_count=cred_edges,
                adj_nni_count=len(adjacent_keys),
                cred_adj_nni_count=pp_maps.get_credible_adjacent_nni_count(
                    adjacent_keys),
                parent=key[0],
                child=key[1],
            ))

    def to_dataframe(self):
        import pandas as pd

        return pd.DataFrame(self.rows)

    def accepted_keys(self) -> List[Tuple[str, str]]:
        return [(r["parent"], r["child"]) for r in self.rows]


def nni_search(
    fasta_path: str,
    seed_newick: str,
    credible_newick: str,
    pp_csv: str,
    pcsp_pp_csv: str,
    *,
    iter_max: int = 10,
    scoring: str = "tp_likelihood",
    top_k: int = 1,
    cutoff: Optional[float] = None,
    sort_taxa: bool = False,
    verbose: bool = False,
):
    """Run the systematic NNI search (reference Program.nni_search,
    test/nni_search.py:1124-1290) and return (gp_instance, SearchResults).

    scoring: 'tp_likelihood' | 'tp_parsimony' | 'gp_likelihood'.
    The default filter is top-k (k=1): accept the single best adjacent NNI
    each iteration, as in the reference's golden DS1 run."""
    from ..api.gp import gp_instance

    inst = gp_instance("")
    inst.read_fasta_file(fasta_path)
    inst.read_newick_file(seed_newick, sort_taxa=sort_taxa)
    inst.make_dag()
    if scoring in ("tp_likelihood", "tp_parsimony"):
        inst.make_tp_engine()
        inst.tp_engine_set_branch_lengths_by_taking_first()
        inst.tp_engine_set_choice_map_by_taking_first()
        engine = inst.make_nni_engine(scoring)
    else:
        inst.make_gp_engine()
        inst.take_first_branch_length()
        engine = inst.make_nni_engine("gp_likelihood")
    if cutoff is not None:
        engine.set_filter_cutoff(cutoff)
    else:
        engine.set_top_k_score_filtering_scheme(top_k)

    pp_maps = PosteriorProbabilityMaps(
        fasta_path, credible_newick, pp_csv, pcsp_pp_csv,
        sort_taxa=sort_taxa,
    )
    results = SearchResults()

    engine.run_init()
    iteration = 1
    while iteration <= iter_max and engine.adjacent_nni_count():
        scored_before = None
        any_accepted = engine.run_main_loop(quiet=not verbose)
        scored_before = engine.scored_nnis()
        results.add_entry(iteration, engine.dag, engine, pp_maps,
                          scored_before)
        if verbose:
            cred, noncred = pp_maps.get_credible_edge_count(engine.dag)
            print(f"iter {iteration}: accepted "
                  f"{engine.accepted_nni_count()}, credible edges "
                  f"{cred}/{pp_maps.get_credible_edge_total()}")
        if not any_accepted:
            break
        engine.run_post_loop()
        iteration += 1
    return inst, results
