"""Measured CPU baseline: a faithful single-thread f64 reimplementation of
the reference's DS1 GTR+Gamma4 LL + branch-gradient path.  It is also the
plain f64 reference the GPU path is checked against (chip_smoke.py,
tests/test_simulated.py).

The reference (phylovi/bito) cannot be built here (BEAGLE is an external
git fetch; no egress), so this script reproduces FatBeagle::Gradient's
algorithmic structure (reference src/fat_beagle.cpp:113-169) per tree,
serially, in float64 numpy — the same work BEAGLE's CPU backend performs:

  1. postorder partials:  p[v] = prod_children P_c(t_child) @ p[child]
     (beagleUpdatePartials; one 4x4 @ 4xS GEMM per child per category)
  2. preorder pre-partials (beagleUpdatePrePartials)
  3. per-edge derivatives d LL / d t via dP matrices
     (beagleCalculateEdgeDerivatives)
  4. root log likelihood (beagleCalculateRootLogLikelihoods)

numpy's BLAS-backed small GEMMs stand in for BEAGLE's SSE kernels; both
stream 4xS pattern blocks through 4x4 matrices, so per-pattern work is
equivalent.  The reference's Engine defaults to a thread pool over trees;
the recorded number is single-thread (per-chip comparisons multiply by the
host's core count if desired — the bito Engine scales linearly over trees).

Times the DS1-shaped simulated data of bito_tpu/utils/simulate.py (27
taxa, 1,949 sites, seed 0) and writes scripts/cpu_baseline.json
{"evals_per_sec": N, ...}.

Usage: python scripts/cpu_baseline.py [--trees N] [--reps N]
"""
import argparse
import json
import os
import sys
import time

import numpy as np
from scipy.stats import gamma as gamma_dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bito_tpu.core.newick import parse_nexus_file  # noqa: E402
from bito_tpu.core.site_pattern import SitePattern  # noqa: E402


def gtr_eigen(rates, pi):
    """pi-symmetrized GTR eigendecomposition (reference
    src/substitution_model.cpp GTR; BEAGLE-style V, V^-1, lambda)."""
    a, b, c, d, e, f = rates  # AC AG AT CG CT GT
    Q = np.array([
        [0, a * pi[1], b * pi[2], c * pi[3]],
        [a * pi[0], 0, d * pi[2], e * pi[3]],
        [b * pi[0], d * pi[1], 0, f * pi[3]],
        [c * pi[0], e * pi[1], f * pi[2], 0],
    ])
    Q[np.diag_indices(4)] = -Q.sum(axis=1)
    # normalize to one expected substitution per unit time
    Q /= -(np.diag(Q) * pi).sum()
    sp = np.sqrt(pi)
    S = sp[:, None] * Q / sp[None, :]   # diag(sqrt pi) Q diag(1/sqrt pi)
    S = 0.5 * (S + S.T)
    w, V = np.linalg.eigh(S)
    U = V / sp[:, None]
    Uinv = V.T * sp[None, :]
    return U, w, Uinv


def gamma4_rates(shape, k=4):
    q = (2.0 * np.arange(k) + 1.0) / (2.0 * k)
    x = gamma_dist.ppf(q, shape, scale=1.0 / shape)
    return x / x.mean()


def transition(V, w, Vinv, t):
    return (V * np.exp(w * t)[None, :]) @ Vinv


def transition_deriv(V, w, Vinv, t):
    return (V * (w * np.exp(w * t))[None, :]) @ Vinv


def ll_and_gradient(tree, tips, weights, V, w, Vinv, cat_rates, pi):
    """One tree's LL + all branch gradients, serial f64 (the FatBeagle unit
    of work)."""
    topo = tree.topology
    n_nodes = topo.num_nodes
    n_taxa = tips.shape[0]
    S = tips.shape[1]
    C = len(cat_rates)
    prop = 1.0 / C

    parents = topo.parents
    # children lists
    children = [[] for _ in range(n_nodes)]
    root = -1
    for v in range(n_nodes):
        p = int(parents[v])
        if p == -1:
            root = v
        else:
            children[p].append(v)

    # per-(node, category) transition matrices for the node's parent edge
    P = np.zeros((n_nodes, C, 4, 4))
    dP = np.zeros((n_nodes, C, 4, 4))
    for v in range(n_nodes):
        if int(parents[v]) == -1:
            continue
        t = tree.branch_lengths[v]
        for c in range(C):
            P[v, c] = transition(V, w, Vinv, t * cat_rates[c])
            dP[v, c] = transition_deriv(V, w, Vinv, t * cat_rates[c]) \
                * cat_rates[c]

    # postorder partials (beagleUpdatePartials)
    post = np.zeros((n_nodes, C, 4, S))
    order = []
    stack = [(root, False)]
    while stack:
        v, done = stack.pop()
        if done:
            order.append(v)
            continue
        stack.append((v, True))
        for ch in children[v]:
            stack.append((ch, False))
    for v in order:
        if v < n_taxa:
            post[v] = np.broadcast_to(tips[v].T[None], (C, 4, S))
            continue
        acc = np.ones((C, 4, S))
        for ch in children[v]:
            evolved = np.einsum("cab,cbs->cas", P[ch], post[ch])
            acc = acc * evolved
        post[v] = acc

    # site likelihoods at root
    site_like = np.einsum("a,cas->s", pi, post[root]) * prop  # [S]
    ll = float(np.log(site_like) @ weights)

    # preorder pre-partials (beagleUpdatePrePartials)
    pre = np.zeros((n_nodes, C, 4, S))
    pre[root] = np.broadcast_to(pi[None, :, None], (C, 4, S))
    for v in reversed(order):
        # pre[v] is the outside vector ABOVE v's own edge; evolving it
        # through P[v] (transposed) gives the outside at v itself.
        if int(parents[v]) == -1:
            at_v = pre[v]
        else:
            at_v = np.einsum("cab,cas->cbs", P[v], pre[v])
        for ch in children[v]:
            acc = at_v.copy()
            for sib in children[v]:
                if sib == ch:
                    continue
                acc = acc * np.einsum("cab,cbs->cas", P[sib], post[sib])
            pre[ch] = acc  # not yet evolved through ch's own edge

    # edge derivatives (beagleCalculateEdgeDerivatives)
    grads = np.zeros(n_nodes)
    for v in range(n_nodes):
        if int(parents[v]) == -1:
            continue
        dsite = np.einsum("cas,cab,cbs->s", pre[v], dP[v], post[v]) * prop
        grads[v] = float((dsite / site_like) @ weights)
    return ll, grads


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", type=int, default=20,
                    help="evaluations to time (cycling the 10-tree sample)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import tempfile

    from bito_tpu.utils import simulate

    sim = simulate.simulate(0)
    with tempfile.TemporaryDirectory() as tmp:
        coll = parse_nexus_file(simulate.write_files(sim, tmp)["nexus"])
    sp = SitePattern(sim.alignment, coll.taxon_names)
    tips = sp.tip_partials()          # [T, S, 4]
    weights = np.asarray(sp.weights, dtype=np.float64)

    rates = np.array([0.1, 0.3, 0.1, 0.2, 0.25, 0.05])
    pi = np.array([0.3, 0.25, 0.2, 0.25])
    V, w, Vinv = gtr_eigen(rates, pi)
    cat_rates = gamma4_rates(0.5)

    trees = [coll.trees[i % len(coll.trees)] for i in range(args.trees)]

    # warm once (BLAS init, caches)
    ll0, g0 = ll_and_gradient(trees[0], tips, weights, V, w, Vinv,
                              cat_rates, pi)
    print(f"# warm LL={ll0:.4f} grad[3]={g0[3]:.4f}", file=sys.stderr)

    best = float("inf")
    for _ in range(args.reps):
        start = time.perf_counter()
        for t in trees:
            ll_and_gradient(t, tips, weights, V, w, Vinv, cat_rates, pi)
        best = min(best, time.perf_counter() - start)
    evals_per_sec = args.trees / best

    out = {
        "evals_per_sec": round(evals_per_sec, 2),
        "metric": "DS1-shape GTR+Gamma4 LL+branch-gradient evals/sec, "
                  "single CPU thread, f64 (simulated data, seed 0)",
        "method": "faithful numpy reimplementation of "
                  "FatBeagle::Gradient (src/fat_beagle.cpp:113-169)",
        "trees_timed": args.trees,
        "seconds": round(best, 3),
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "cpu_baseline.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
