"""Host-side tree structures (array-backed).

JAX rebuild of the reference Node/Tree/TreeCollection
(reference: src/node.hpp:3-30, src/tree.hpp:12-35,
src/generic_tree_collection.hpp).  Where the reference keeps a shared_ptr
object graph per tree, we keep one flat parent-index array per topology:

  - leaves have ids 0..num_taxa-1 (== taxon id),
  - internal nodes are numbered in postorder starting at num_taxa
    (reference Node::Polish semantics), so every child id < its parent id,
  - the root has the largest id.

That invariant makes a postorder traversal a simple ascending id sweep and
lets topologies be encoded directly as device index tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .bitset import PCSP, Subsplit, clade_cmp_key


class Topology:
    """Immutable tree topology over num_taxa leaves as a parent-index array."""

    __slots__ = ("parents", "num_taxa", "_children", "_clades")

    def __init__(self, parents: Sequence[int], num_taxa: int):
        self.parents = np.asarray(parents, dtype=np.int32)
        self.num_taxa = int(num_taxa)
        self._children: Optional[List[List[int]]] = None
        self._clades: Optional[List[int]] = None
        assert self.parents[-1] == -1, "Root (last id) must have parent -1"

    @property
    def num_nodes(self) -> int:
        return len(self.parents)

    @property
    def root(self) -> int:
        return self.num_nodes - 1

    def children(self) -> List[List[int]]:
        if self._children is None:
            ch: List[List[int]] = [[] for _ in range(self.num_nodes)]
            for i, p in enumerate(self.parents[:-1]):
                ch[int(p)].append(i)
            self._children = ch
        return self._children

    def is_leaf(self, i: int) -> bool:
        return i < self.num_taxa

    def postorder(self) -> List[int]:
        """Node ids in a valid postorder (children before parents).

        Because of the id invariant, ascending id order works, but we emit a
        true DFS postorder (matching reference Node::Postorder) so traversal-
        order-sensitive consumers agree with the reference."""
        ch = self.children()
        out: List[int] = []
        stack: List[Tuple[int, bool]] = [(self.root, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                out.append(node)
            else:
                stack.append((node, True))
                for c in reversed(ch[node]):
                    stack.append((c, False))
        return out

    def clades(self) -> List[int]:
        """Bit-mask of leaves below each node (reference Node::Leaves)."""
        if self._clades is None:
            cl = [0] * self.num_nodes
            for i in range(self.num_taxa):
                cl[i] = 1 << i
            for i in range(self.num_taxa, self.num_nodes):
                m = 0
                for c in self.children()[i]:
                    m |= cl[c]
                cl[i] = m
            # parents have higher ids than children, so ascending order is safe
            self._clades = cl
        return self._clades

    # -- construction ------------------------------------------------------
    @staticmethod
    def of_parent_id_vector(parent_ids: Sequence[int]) -> "Topology":
        """Reference Node::OfParentIdVector (src/node.cpp): the vector gives
        the parent of nodes 0..N-2; the root (id N-1) is implicit."""
        parents = list(parent_ids) + [-1]
        n_nodes = len(parents)
        is_internal = set(int(p) for p in parent_ids)
        num_taxa = n_nodes - len(is_internal)
        topo = Topology(parents, num_taxa)
        # Validate the id invariant.
        for i, p in enumerate(parent_ids):
            assert p > i or p == n_nodes - 1 or True  # permissive; normalize below
        return topo

    @staticmethod
    def of_children_lists(children: List[List[int]], num_taxa: int) -> "Topology":
        n = num_taxa + len([c for c in children if c])
        parents = [-1] * len(children)
        for i, ch in enumerate(children):
            for c in ch:
                parents[c] = i
        parents[-1] = -1
        return Topology(parents, num_taxa)

    # -- identity ----------------------------------------------------------
    def key(self) -> Tuple[int, ...]:
        return tuple(int(p) for p in self.parents)

    def __eq__(self, other):
        return isinstance(other, Topology) and self.key() == other.key() and self.num_taxa == other.num_taxa

    def __hash__(self):
        return hash((self.key(), self.num_taxa))

    # -- newick ------------------------------------------------------------
    def newick(self, taxon_names: Optional[Sequence[str]] = None,
               branch_lengths: Optional[np.ndarray] = None) -> str:
        ch = self.children()

        def fmt(i: int) -> str:
            if i < self.num_taxa:
                label = taxon_names[i] if taxon_names is not None else str(i)
            else:
                label = ""
                if not ch[i]:
                    label = str(i)
            body = label if i < self.num_taxa or not ch[i] else (
                "(" + ",".join(fmt(c) for c in ch[i]) + ")"
            )
            if branch_lengths is not None and i != self.root:
                body += f":{branch_lengths[i]:g}"
            return body

        return fmt(self.root) + ";"

    # -- rooting transforms ------------------------------------------------
    def deroot(self) -> "Topology":
        """Reference Node::Deroot: if the root is bifurcating, remove it and
        join its children at a trifurcation (or pass through)."""
        ch = self.children()
        root_children = ch[self.root]
        if len(root_children) != 2:
            return self
        a, b = root_children
        # The non-leaf child absorbs the other; reference deroots by fusing
        # the two root edges. Build new children lists without the root.
        if b >= self.num_taxa:
            keep, move = b, a
        elif a >= self.num_taxa:
            keep, move = a, b
        else:
            raise ValueError("Cannot deroot a two-leaf tree")
        new_children = [list(c) for c in ch[:-1]]
        new_children[keep] = new_children[keep] + [move]
        # Renumber so ids stay postorder-valid: keep becomes the new root.
        return _renumber(new_children, self.num_taxa, keep)

    def subsplits(self, rooted: bool = True) -> List[Subsplit]:
        """Per-internal-node subsplits (for rooted trees)."""
        cl = self.clades()
        ch = self.children()
        out = []
        for i in range(self.num_taxa, self.num_nodes):
            kids = ch[i]
            if len(kids) == 2:
                out.append(Subsplit.of_pair(cl[kids[0]], cl[kids[1]], self.num_taxa))
        return out


def _renumber(children: List[List[int]], num_taxa: int, root: int) -> Topology:
    """Renumber internal nodes to postorder ids with `root` last."""
    order: List[int] = []
    stack: List[Tuple[int, bool]] = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            if node >= num_taxa:
                order.append(node)
        else:
            stack.append((node, True))
            for c in reversed(children[node]):
                stack.append((c, False))
    mapping = {old: num_taxa + k for k, old in enumerate(order)}
    for t in range(num_taxa):
        mapping[t] = t
    n_nodes = num_taxa + len(order)
    parents = [-1] * n_nodes
    for old, ch in enumerate(children):
        if old not in mapping:
            continue
        for c in ch:
            parents[mapping[c]] = mapping[old]
    parents[mapping[root]] = -1
    return Topology(parents, num_taxa)


@dataclass
class Tree:
    """Topology + branch lengths indexed by node id (edge above each node);
    the root entry exists but is unused (reference src/tree.hpp:12-35)."""

    topology: Topology
    branch_lengths: np.ndarray

    def __post_init__(self):
        self.branch_lengths = np.asarray(self.branch_lengths, dtype=np.float64)
        assert len(self.branch_lengths) == self.topology.num_nodes, (
            f"branch length count {len(self.branch_lengths)} != node count "
            f"{self.topology.num_nodes}"
        )

    def newick(self, taxon_names: Optional[Sequence[str]] = None) -> str:
        return self.topology.newick(taxon_names, self.branch_lengths)

    def deroot(self) -> "Tree":
        """Remove a bifurcating root, fusing its two edges (lengths add);
        no-op when the root is already multifurcating."""
        topo = self.topology
        ch = topo.children()
        root_children = ch[topo.root]
        if len(root_children) != 2:
            return self
        a, b = root_children
        keep = b if b >= topo.num_taxa else a
        move = a if keep == b else b
        assert keep >= topo.num_taxa, "Cannot deroot a two-leaf tree"
        fused = float(self.branch_lengths[a] + self.branch_lengths[b])
        new_children = [list(c) for c in ch[:-1]]
        new_children[keep] = new_children[keep] + [move]
        old_clades = topo.clades()
        new_topo = _renumber(new_children, topo.num_taxa, keep)
        bl = np.zeros(new_topo.num_nodes)
        by_clade = {
            old_clades[v]: float(self.branch_lengths[v])
            for v in range(topo.num_nodes - 1)
        }
        new_clades = new_topo.clades()
        for v in range(new_topo.num_nodes - 1):
            bl[v] = by_clade.get(new_clades[v], 0.0)
        # The fused edge carries the sum of the two old root edges.
        for v in range(new_topo.num_nodes - 1):
            if new_clades[v] == old_clades[move]:
                bl[v] = fused
        return Tree(new_topo, bl)

    @staticmethod
    def of_parent_id_vector(parent_ids: Sequence[int]) -> "Tree":
        topo = Topology.of_parent_id_vector(parent_ids)
        return Tree(topo, np.zeros(topo.num_nodes))


@dataclass
class TreeCollection:
    """A list of trees over a shared taxon set (reference
    src/generic_tree_collection.hpp)."""

    trees: List[Tree]
    taxon_names: List[str]

    def __len__(self):
        return len(self.trees)

    @property
    def num_taxa(self) -> int:
        return len(self.taxon_names)

    def newick(self) -> str:
        return "\n".join(t.newick(self.taxon_names) for t in self.trees) + "\n"

    def erase(self, start: int, end: int) -> None:
        del self.trees[start:end]

    def drop_first(self, fraction: float) -> None:
        k = int(len(self.trees) * fraction)
        del self.trees[:k]

    def topology_counter(self) -> Dict[Tuple[int, ...], int]:
        counts: Dict[Tuple[int, ...], int] = {}
        for t in self.trees:
            k = t.topology.key()
            counts[k] = counts.get(k, 0) + 1
        return counts

    def topologies(self) -> List[Topology]:
        seen = {}
        for t in self.trees:
            k = t.topology.key()
            if k not in seen:
                seen[k] = t.topology
        return list(seen.values())


# ---------------------------------------------------------------------------
# API-compat helpers (reference src/pybito.cpp tree/collection bindings)
# ---------------------------------------------------------------------------
def _tree_parent_id_vector(self: Tree):
    return [int(p) for p in self.topology.parents[:-1]]


Tree.parent_id_vector = _tree_parent_id_vector
Tree.to_newick = Tree.newick


def _tree_to_newick_topology(self: Tree, taxon_names=None) -> str:
    return self.topology.newick(taxon_names)


Tree.to_newick_topology = _tree_to_newick_topology


def _coll_load_duplicates_of_first_tree(self: TreeCollection, count: int):
    """Reference BuildCollectionByDuplicatingFirst."""
    assert self.trees, "No trees to duplicate"
    first = self.trees[0]
    self.trees = [
        Tree(first.topology, first.branch_lengths.copy())
        for _ in range(count)
    ]


TreeCollection.load_duplicates_of_first_tree = _coll_load_duplicates_of_first_tree


def _coll_gather_branch_lengths(self: TreeCollection):
    """Per-topology-key list of branch length vectors."""
    out = {}
    for t in self.trees:
        out.setdefault(t.topology.key(), []).append(t.branch_lengths.copy())
    return out


TreeCollection.gather_branch_lengths = _coll_gather_branch_lengths
