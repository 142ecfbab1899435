"""TP choice maps: per-edge best adjacent edges and top-tree extraction.

JAX rebuild of the reference TPChoiceMap
(reference: src/tp_choice_map.hpp:4-8, src/tp_choice_map.cpp): for every DAG
edge, the choice map records the adjacent edges (parent, sister, left child,
right child) of the best ("top") tree containing that edge, plus which input
tree supplied the choice (tree_source, src/tp_engine.cpp:421-656).  Following
choices rootward and leafward from an edge reconstitutes its top tree.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.bitset import PCSP, Subsplit
from ..core.tree import Topology, Tree
from ..dag.subsplit_dag import LEFT, RIGHT, SubsplitDAG

NO_EDGE = -1


@dataclass
class TPChoiceMap:
    dag: SubsplitDAG
    parent_choice: np.ndarray   # [E] edge id of chosen parent edge
    sister_choice: np.ndarray   # [E] edge id of chosen sister edge
    left_choice: np.ndarray     # [E] chosen left-clade child edge
    right_choice: np.ndarray    # [E] chosen right-clade child edge
    tree_source: np.ndarray     # [E] index of the tree that set this edge

    @classmethod
    def empty(cls, dag: SubsplitDAG) -> "TPChoiceMap":
        E = dag.edge_count()
        mk = lambda: np.full(E, NO_EDGE, dtype=np.int64)
        return cls(dag, mk(), mk(), mk(), mk(),
                   np.full(E, -1, dtype=np.int64))

    # -- initialization from a tree collection ---------------------------
    def initialize_from_trees(self, trees: Sequence[Tree]):
        """Take-first initialization (reference
        TPEngine::InitializeChoiceMapWithTakeFirstTree): the first tree
        containing an edge supplies its adjacent choices.

        Take-first means later trees can never override, so absorbing
        stops as soon as every edge is mapped — the GP-scored NNI loop
        rebuilds this map per acceptance over hundreds of accumulated
        supporting trees whose tail contributes nothing (4.5 s/iteration
        at the 1,077-edge stress scale, round 5).  One shared edge
        indexer replaces the former per-tree O(E) string build."""
        indexer = self.dag.build_edge_indexer()
        for tree_idx, tree in enumerate(trees):
            if not (self.tree_source == -1).any():
                break
            self._absorb_tree(tree.topology, tree_idx, indexer)
        # Fill any still-unset choices greedily (edges only reachable via
        # other edges' subtrees).
        self._complete()

    def _tree_edge_map(self, topo: Topology, indexer=None
                       ) -> Dict[int, int]:
        """tree node -> DAG edge id for the edge above that node, plus the
        rootsplit edge keyed by the root.  Pass `indexer` when calling in
        a loop (build_edge_indexer is O(E) string building)."""
        dag = self.dag
        n = topo.num_taxa
        cl = topo.clades()
        ch = topo.children()
        ss: Dict[int, Subsplit] = {
            v: Subsplit.leaf(v, n) for v in range(n)
        }
        for v in range(n, topo.num_nodes):
            kids = ch[v]
            ss[v] = Subsplit.of_pair(cl[kids[0]], cl[kids[1]], n)
        if indexer is None:
            indexer = dag.build_edge_indexer()
        out: Dict[int, int] = {}
        for v in range(topo.num_nodes - 1):
            p = int(topo.parents[v])
            key = PCSP.of_parent_child(ss[p], ss[v]).to_string()
            if key in indexer:
                out[v] = indexer[key]
        root_key = PCSP.of_parent_child(
            Subsplit.uca(n), ss[topo.root]
        ).to_string()
        if root_key in indexer:
            out[topo.root] = indexer[root_key]
        return out

    def _absorb_tree(self, topo: Topology, tree_idx: int, indexer=None):
        edge_of = self._tree_edge_map(topo, indexer)
        ch = topo.children()
        dag = self.dag
        for v, e in edge_of.items():
            if self.tree_source[e] != -1:
                continue
            # children choices
            if v >= topo.num_taxa:
                kids = ch[v]
                e_kids = [edge_of.get(k, NO_EDGE) for k in kids]
                sides = []
                child_node = dag.edge_child[e]
                for k, ek in zip(kids, e_kids):
                    if ek == NO_EDGE:
                        sides.append(None)
                        continue
                    side = bool(dag.edge_side[ek])
                    sides.append(side)
                for k, ek, side in zip(kids, e_kids, sides):
                    if ek == NO_EDGE:
                        continue
                    if side == LEFT:
                        self.left_choice[e] = ek
                    else:
                        self.right_choice[e] = ek
            # parent + sister choices
            if v != topo.root:
                p = int(topo.parents[v])
                self.parent_choice[e] = edge_of.get(p, NO_EDGE)
                sibs = [w for w in ch[p] if w != v]
                if sibs:
                    self.sister_choice[e] = edge_of.get(sibs[0], NO_EDGE)
            else:
                self.parent_choice[e] = NO_EDGE  # rootsplit edge: UCA above
                self.sister_choice[e] = NO_EDGE
            self.tree_source[e] = tree_idx

    def _complete(self):
        """Assign choices for edges no tree covered: pick the first
        available adjacent edge in edge-id order (reference falls back to
        highest-priority assignment)."""
        dag = self.dag
        changed = True
        while changed:
            changed = False
            for e in range(dag.edge_count()):
                child = int(dag.edge_child[e])
                parent = int(dag.edge_parent[e])
                if child >= dag.taxon_count:
                    for side, arr in ((LEFT, self.left_choice),
                                      (RIGHT, self.right_choice)):
                        if arr[e] == NO_EDGE and dag.leafward[child][side]:
                            arr[e] = dag.leafward[child][side][0][1]
                            changed = True
                if parent != dag.root_id:
                    if self.parent_choice[e] == NO_EDGE:
                        for side in (RIGHT, LEFT):
                            if dag.rootward[parent][side]:
                                self.parent_choice[e] = (
                                    dag.rootward[parent][side][0][1]
                                )
                                changed = True
                                break
                    if self.sister_choice[e] == NO_EDGE:
                        my_side = bool(dag.edge_side[e])
                        sis_side = not my_side
                        options = [
                            (c, ee) for c, ee in dag.leafward[parent][sis_side]
                        ]
                        if options:
                            self.sister_choice[e] = options[0][1]
                            changed = True

    # -- top-tree extraction ---------------------------------------------
    def top_tree_topology(self, edge_id: int,
                          branch_lengths: Optional[np.ndarray] = None
                          ) -> Tree:
        """Reconstruct the top tree containing `edge_id` (reference
        TPChoiceMap::ExtractTopology)."""
        dag = self.dag
        n = dag.taxon_count

        children_lists: Dict[int, List[int]] = {i: [] for i in range(n)}
        lengths: Dict[int, float] = {}
        counter = [n]

        def grow_down(e: int) -> int:
            """Build the subtree below edge e; return its node id."""
            child = int(dag.edge_child[e])
            if child < n:
                node = child
            else:
                le = int(self.left_choice[e])
                re = int(self.right_choice[e])
                assert le != NO_EDGE and re != NO_EDGE, (
                    f"Incomplete choice map at edge {e}"
                )
                l_node = grow_down(le)
                r_node = grow_down(re)
                node = counter[0]
                counter[0] += 1
                children_lists[node] = [l_node, r_node]
            if branch_lengths is not None:
                lengths[node] = float(branch_lengths[e])
            return node

        # Walk rootward from edge_id collecting (edge, sister-subtree).
        path = []
        e = edge_id
        while e != NO_EDGE:
            path.append(e)
            e = int(self.parent_choice[e])
        # Build: start from the deepest (the rootsplit edge is last in path).
        # The subtree below edge_id:
        node = grow_down(edge_id)
        for i in range(len(path) - 1):
            e_cur = path[i]
            sis_e = int(self.sister_choice[e_cur])
            assert sis_e != NO_EDGE, f"No sister choice at edge {e_cur}"
            sis_node = grow_down(sis_e)
            parent_node = counter[0]
            counter[0] += 1
            children_lists[parent_node] = [node, sis_node]
            if branch_lengths is not None:
                lengths[parent_node] = float(
                    branch_lengths[path[i + 1]]
                )
            node = parent_node
        root = node
        from ..core.tree import _renumber

        maxid = max(children_lists.keys())
        ch_list = [children_lists.get(i, []) for i in range(maxid + 1)]
        # Build mapping old->new to carry branch lengths across renumber.
        topo = _renumber(ch_list, n, root)
        if branch_lengths is None:
            return Tree(topo, np.zeros(topo.num_nodes))
        # Recompute branch lengths on the renumbered topology by matching
        # clades to DAG edges via the top-tree edge map.
        tree = Tree(topo, np.zeros(topo.num_nodes))
        edge_map = self._tree_edge_map(topo)
        for v, e in edge_map.items():
            if v != topo.root:
                tree.branch_lengths[v] = branch_lengths[e]
        return tree
