"""Seeded simulation of nucleotide alignments and posterior tree samples.

Plain numpy and scipy, independent of the likelihood code.  A rooted binary
tree is drawn by random pairwise joins, an alignment is evolved down it under
GTR with median-discretized Gamma rate variation, and a small "posterior"
sample is derived from the true tree by random nearest-neighbour interchanges.
`write_files` writes what the product readers take: FASTA, a Nexus tree file
with a translate table (unrooted, trifurcating root) and rooted Newick.

The default shape is DS1's (27 taxa, 1,949 sites; Lakner et al. 2008), with
the GTR rates, frequencies and Gamma shape the benchmarks use.

Trees are parent arrays over node ids: leaves 0..T-1, internal nodes T..2T-2
in join order (so every parent id exceeds its children's), the root last
with parent -1.  `length[v]` is the branch above node v.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
from scipy.special import gammaincinv

GTR_RATES = (0.1, 0.3, 0.1, 0.2, 0.25, 0.05)    # AC AG AT CG CT GT
FREQUENCIES = (0.3, 0.25, 0.2, 0.25)             # A C G T
GAMMA_SHAPE = 0.5

Tree = Tuple[np.ndarray, np.ndarray]  # (parent, length)


def gtr_gamma_params() -> Dict[str, np.ndarray]:
    """The likelihood engine's parameters for the simulating GTR+Gamma4
    model (`PhyloModelSpecification(substitution="GTR", site="gamma+4")`);
    the engine casts them to its own dtype."""
    return {"substitution_model_rates": np.asarray(GTR_RATES),
            "substitution_model_frequencies": np.asarray(FREQUENCIES),
            "site_model_parameters": np.asarray([GAMMA_SHAPE])}


@dataclass
class Simulation:
    names: List[str]
    alignment: Dict[str, str]
    trees: List[Tree]          # trees[0] generated the alignment


def random_tree(num_taxa: int, rng: np.random.Generator,
                mean_branch_length: float) -> Tree:
    n = 2 * num_taxa - 1
    parent = np.full(n, -1, dtype=np.int64)
    roots = list(range(num_taxa))
    for node in range(num_taxa, n):
        i, j = sorted(rng.choice(len(roots), size=2, replace=False))
        parent[roots[i]] = parent[roots[j]] = node
        roots = [r for k, r in enumerate(roots) if k not in (i, j)] + [node]
    length = rng.exponential(mean_branch_length, n)
    length[-1] = 0.0
    return parent, length


def _children(parent: np.ndarray) -> List[List[int]]:
    ch: List[List[int]] = [[] for _ in parent]
    for v, p in enumerate(parent):
        if p >= 0:
            ch[p].append(v)
    return ch


def nni(tree: Tree, rng: np.random.Generator) -> Tree:
    """Swap a child of a random non-root internal node v with v's sibling.
    Branch lengths stay with their nodes."""
    parent, length = tree[0].copy(), tree[1]
    num_taxa = (len(parent) + 1) // 2
    ch = _children(parent)
    v = int(rng.integers(num_taxa, len(parent) - 1))
    p = parent[v]
    sibling = next(c for c in ch[p] if c != v)
    child = ch[v][int(rng.integers(2))]
    parent[child], parent[sibling] = p, v
    return _relabel(parent, length)


def _relabel(parent: np.ndarray, length: np.ndarray) -> Tree:
    """Renumber internal nodes in postorder, so parents exceed children."""
    num_taxa = (len(parent) + 1) // 2
    ch = _children(parent)
    new_id = np.arange(len(parent))
    nxt = num_taxa
    stack = [(len(parent) - 1, False)]
    while stack:
        v, done = stack.pop()
        if done:
            new_id[v], nxt = nxt, nxt + 1
        elif v >= num_taxa:
            stack.append((v, True))
            stack.extend((c, False) for c in ch[v])
    new_parent = np.full_like(parent, -1)
    new_length = np.zeros_like(length)
    for v, p in enumerate(parent):
        new_length[new_id[v]] = length[v]
        if p >= 0:
            new_parent[new_id[v]] = new_id[p]
    return new_parent, new_length


def gamma_rates(shape: float, count: int = 4) -> np.ndarray:
    q = (2.0 * np.arange(count) + 1.0) / (2.0 * count)
    x = gammaincinv(shape, q) / shape
    return x / x.mean()


def gtr_transition(rates, freqs, t: float) -> np.ndarray:
    """P(t) of the GTR model normalised to one substitution per unit time."""
    a, b, c, d, e, f = rates
    pi = np.asarray(freqs, dtype=np.float64)
    R = np.array([[0, a, b, c], [a, 0, d, e], [b, d, 0, f], [c, e, f, 0]],
                 dtype=np.float64)
    Q = R * pi[None, :]
    Q[np.diag_indices(4)] = -Q.sum(axis=1)
    Q /= -(np.diag(Q) * pi).sum()
    s = np.sqrt(pi)
    w, V = np.linalg.eigh(s[:, None] * Q / s[None, :])
    P = (V / s[:, None]) @ np.diag(np.exp(w * t)) @ (V.T * s[None, :])
    return np.clip(P, 0.0, None)


def simulate_alignment(tree: Tree, num_sites: int, rng: np.random.Generator,
                       rates=GTR_RATES, freqs=FREQUENCIES,
                       gamma_shape: float = GAMMA_SHAPE) -> np.ndarray:
    """[num_taxa, num_sites] states 0..3 evolved down `tree`."""
    parent, length = tree
    num_taxa = (len(parent) + 1) // 2
    cat_rates = gamma_rates(gamma_shape)
    category = rng.integers(len(cat_rates), size=num_sites)
    states = np.zeros((len(parent), num_sites), dtype=np.int64)
    states[-1] = rng.choice(4, size=num_sites, p=np.asarray(freqs))
    for v in range(len(parent) - 2, -1, -1):  # parents before children
        P = np.stack([gtr_transition(rates, freqs, length[v] * r)
                      for r in cat_rates])                       # [C, 4, 4]
        cdf = np.cumsum(P[category, states[parent[v]]], axis=1)  # [S, 4]
        u = rng.random(num_sites)[:, None] * cdf[:, -1:]
        states[v] = np.minimum((u > cdf).sum(axis=1), 3)
    return states[:num_taxa]


def simulate(seed: int = 0, num_taxa: int = 27, num_sites: int = 1949,
             tree_count: int = 10, mean_branch_length: float = 0.05
             ) -> Simulation:
    """The true tree, an alignment evolved on it, and `tree_count` trees:
    the true one and copies of it after 1-3 random NNIs each."""
    rng = np.random.default_rng(seed)
    true_tree = random_tree(num_taxa, rng, mean_branch_length)
    states = simulate_alignment(true_tree, num_sites, rng)
    names = [f"t{i + 1:02d}" for i in range(num_taxa)]
    alignment = {n: "".join("ACGT"[s] for s in row)
                 for n, row in zip(names, states)}
    trees = [true_tree]
    for _ in range(tree_count - 1):
        t = true_tree
        for _ in range(int(rng.integers(1, 4))):
            t = nni(t, rng)
        trees.append(t)
    return Simulation(names, alignment, trees)


def newick(tree: Tree, labels: List[str], rooted: bool = True) -> str:
    """Newick text; unrooted output fuses the root's two edges into a
    trifurcation, as MCMC samplers write unrooted trees."""
    parent, length = tree
    ch = _children(parent)
    num_taxa = len(labels)

    def fmt(v: int, extra: float = 0.0) -> str:
        body = (labels[v] if v < num_taxa
                else "(" + ",".join(fmt(c) for c in ch[v]) + ")")
        return f"{body}:{length[v] + extra:.10g}"

    root = len(parent) - 1
    left, right = ch[root]
    if rooted:
        return f"({fmt(left)},{fmt(right)});"
    if right < num_taxa:
        left, right = right, left
    inner = [fmt(c) for c in ch[right]]
    return "(" + ",".join([fmt(left, length[right])] + inner) + ");"


def write_files(sim: Simulation, directory: str) -> Dict[str, str]:
    """Write sim.fasta, sim.t (Nexus, unrooted) and sim_rooted.nwk."""
    os.makedirs(directory, exist_ok=True)
    paths = {k: os.path.join(directory, f)
             for k, f in (("fasta", "sim.fasta"), ("nexus", "sim.t"),
                          ("rooted_newick", "sim_rooted.nwk"))}
    with open(paths["fasta"], "w") as f:
        for name in sim.names:
            f.write(f">{name}\n{sim.alignment[name]}\n")
    keys = [str(i + 1) for i in range(len(sim.names))]
    with open(paths["nexus"], "w") as f:
        f.write("#NEXUS\nbegin trees;\n  translate\n")
        f.write(",\n".join(f"    {k} {n}" for k, n in zip(keys, sim.names)))
        f.write(";\n")
        for i, t in enumerate(sim.trees):
            f.write(f"  tree sample.{i + 1} = {newick(t, keys, False)}\n")
        f.write("end;\n")
    with open(paths["rooted_newick"], "w") as f:
        for t in sim.trees:
            f.write(newick(t, sim.names) + "\n")
    return paths
