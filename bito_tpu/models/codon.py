"""Codon-state substitution models (the north star's "codon-sized matrix
exponentials"): MG94-style 61-state models evaluated on the SAME batched
scan tape as the 4-state models, padded to A=64 so every per-state
dimension is a power of two.

The reference's engine is hard-wired to BEAGLE's 4-state kernels for its
shipped models (src/fat_beagle.cpp); here the pruning tape
(treelike/pruning.py) is state-generic — A flows from the tip-partial and
eigenvector shapes — so codon support is a model, not an engine fork.
At A=64 the per-op evolve is a [64C, 64C]-block against [64C, S]: a real
matrix product, unlike the 4x4 blocks of the 4-state case.

Padding contract (states 61..63):
  - pi is zero on pad states, so the root contraction ignores them;
  - the eigensystem is embedded with an identity block on the pad states
    (eigenvalue 0 -> P(t) acts as the identity there), so pad lanes carry
    harmless constants through the recursion;
  - tip partials are zero on pad states (gap columns are all-ones over
    the 61 sense states only).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# Universal genetic code: codon -> amino acid (stop codons excluded below).
_BASES = "TCAG"
_CODE = (
    "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
)


def sense_codons():
    """The 61 sense codons of the universal code, in TCAG order (the
    conventional codon-model state order)."""
    out = []
    for i, b1 in enumerate(_BASES):
        for j, b2 in enumerate(_BASES):
            for k, b3 in enumerate(_BASES):
                if _CODE[16 * i + 4 * j + k] != "*":
                    out.append(b1 + b2 + b3)
    return out


SENSE_CODONS = sense_codons()
CODON_INDEX = {c: i for i, c in enumerate(SENSE_CODONS)}
NUM_CODONS = len(SENSE_CODONS)  # 61
PADDED_STATES = 64


def _aa(codon: str) -> str:
    i = _BASES.index(codon[0])
    j = _BASES.index(codon[1])
    k = _BASES.index(codon[2])
    return _CODE[16 * i + 4 * j + k]


def _is_transition(a: str, b: str) -> bool:
    purines = {"A", "G"}
    return (a in purines) == (b in purines)


def mg94_rate_matrix(kappa: float, omega: float,
                     pi: np.ndarray) -> np.ndarray:
    """Muse-Gaut (1994)-style codon rate matrix [61, 61]: single-nucleotide
    changes only, x kappa for transitions, x omega for nonsynonymous
    changes, x target-codon frequency; rows sum to zero and the matrix is
    scaled to one expected substitution per unit time."""
    n = NUM_CODONS
    Q = np.zeros((n, n))
    for i, ci in enumerate(SENSE_CODONS):
        for j, cj in enumerate(SENSE_CODONS):
            if i == j:
                continue
            diffs = [(a, b) for a, b in zip(ci, cj) if a != b]
            if len(diffs) != 1:
                continue
            a, b = diffs[0]
            rate = pi[j]
            if _is_transition(a, b):
                rate *= kappa
            if _aa(ci) != _aa(cj):
                rate *= omega
            Q[i, j] = rate
    Q[np.diag_indices(n)] = -Q.sum(axis=1)
    scale = -np.dot(pi, np.diag(Q))
    return Q / scale


def codon_frequencies_f1x4(nuc_freqs) -> np.ndarray:
    """F1x4 codon frequencies from nucleotide frequencies (TCAG order),
    renormalized over the 61 sense codons."""
    f = {b: float(p) for b, p in zip(_BASES, nuc_freqs)}
    pi = np.array([f[c[0]] * f[c[1]] * f[c[2]] for c in SENSE_CODONS])
    return pi / pi.sum()


def padded_eigen(Q: np.ndarray, pi: np.ndarray):
    """Eigendecomposition of a reversible Q via pi-symmetrization, embedded
    into the 64-state padded system (identity on the pad block).  Returns
    (U, values, U_inv, pi_pad) as float64 [64,...] arrays satisfying
    U diag(values) U_inv == Q_pad and expm(Q_pad t) == identity on pads."""
    n = Q.shape[0]
    s = np.sqrt(pi)
    Sym = (s[:, None] * Q) / s[None, :]
    Sym = (Sym + Sym.T) / 2.0
    lam, V = np.linalg.eigh(Sym)
    U = V / s[:, None]
    U_inv = V.T * s[None, :]
    A = PADDED_STATES
    Up = np.eye(A)
    Up[:n, :n] = U
    Uip = np.eye(A)
    Uip[:n, :n] = U_inv
    vals = np.zeros(A)
    vals[:n] = lam
    pip = np.zeros(A)
    pip[:n] = pi
    return Up, vals, Uip, pip


def codon_tip_partials(sequences: Dict[str, str], taxon_order) -> np.ndarray:
    """[T, sites/3, 64] one-hot codon tip partials; codons containing
    ambiguity (or stop codons, treated as missing data) get all-ones over
    the 61 sense states and zeros on pads."""
    T = len(taxon_order)
    L = len(next(iter(sequences.values())))
    assert L % 3 == 0, "codon data length must be a multiple of 3"
    S = L // 3
    out = np.zeros((T, S, PADDED_STATES))
    for t, name in enumerate(taxon_order):
        seq = sequences[name].upper().replace("U", "T")
        for s in range(S):
            codon = seq[3 * s:3 * s + 3]
            idx = CODON_INDEX.get(codon)
            if idx is None:
                out[t, s, :NUM_CODONS] = 1.0
            else:
                out[t, s, idx] = 1.0
    return out


# -- structural masks for a traceable MG94 Q build -------------------------
# Precomputed once (host, bool): which codon pairs differ by exactly one
# nucleotide, whether that change is a transition, and whether it is
# nonsynonymous — so Q(kappa, omega, pi) is pure elementwise jnp math.
def _structure_masks():
    n = NUM_CODONS
    single = np.zeros((n, n), bool)
    ti = np.zeros((n, n), bool)
    nonsyn = np.zeros((n, n), bool)
    for i, ci in enumerate(SENSE_CODONS):
        for j, cj in enumerate(SENSE_CODONS):
            if i == j:
                continue
            diffs = [(a, b) for a, b in zip(ci, cj) if a != b]
            if len(diffs) != 1:
                continue
            single[i, j] = True
            a, b = diffs[0]
            ti[i, j] = _is_transition(a, b)
            nonsyn[i, j] = _aa(ci) != _aa(cj)
    return single, ti, nonsyn


SINGLE_MASK, TI_MASK, NONSYN_MASK = _structure_masks()
# Nucleotide index (TCAG order) of each codon position, for F1x4.
CODON_NT_IDX = np.array(
    [[_BASES.index(c[k]) for k in range(3)] for c in SENSE_CODONS])


def mg94_q_padded(kappa, omega, nuc_freqs):
    """Traceable padded [64, 64] MG94 rate matrix (zero rows/cols on the
    3 pad states).  Every off-diagonal entry is a PRODUCT of positive
    factors (pi_j, kappa^ti, omega^nonsyn) — no cancellation — so the
    f32 build is accurate to rounding even for tiny entries; feeds the
    uniformized transition-matrix series (models/substitution.py
    uniformized_stack), the f32-viable route for codon likelihoods."""
    import jax.numpy as jnp

    f = jnp.asarray(nuc_freqs)
    pi61 = jnp.prod(f[jnp.asarray(CODON_NT_IDX)], axis=1)
    pi61 = pi61 / pi61.sum()
    single = jnp.asarray(SINGLE_MASK)
    rate = jnp.where(jnp.asarray(TI_MASK), kappa, 1.0) * jnp.where(
        jnp.asarray(NONSYN_MASK), omega, 1.0)
    Q = jnp.where(single, rate * pi61[None, :], 0.0)
    Q = Q - jnp.diag(Q.sum(axis=1))
    Q = Q / (-jnp.sum(pi61 * jnp.diag(Q)))
    A = PADDED_STATES
    n = NUM_CODONS
    Qp = jnp.zeros((A, A), Q.dtype).at[:n, :n].set(Q)
    return Qp


def mg94_eigen(kappa, omega, nuc_freqs):
    """MG94 padded-64 eigensystem as an EigenDecomp, from (kappa, omega,
    nucleotide frequencies in TCAG order).

    Concrete inputs take a float64 numpy path (the 61-state `eigh` wants
    f64; under the engine's eager ingredient prep — branch_eval_fn /
    ll_eval_fn compute model ingredients outside the jitted sweep — this
    is the path that runs, so kernel parity is set by f64 eigenvectors).
    Traced inputs (model-parameter gradients, vmapped per-tree params)
    fall back to a fully traceable jnp build from the precomputed
    structural masks."""
    import jax
    import jax.numpy as jnp

    from .substitution import EigenDecomp

    concrete = not any(
        isinstance(x, jax.core.Tracer) for x in (kappa, omega, nuc_freqs))
    if concrete:
        pi61 = codon_frequencies_f1x4(np.asarray(nuc_freqs, np.float64))
        Q61 = mg94_rate_matrix(float(kappa), float(omega), pi61)
        U, vals, U_inv, pip = padded_eigen(Q61, pi61)
        return EigenDecomp(U=jnp.asarray(U), values=jnp.asarray(vals),
                           U_inv=jnp.asarray(U_inv), pi=jnp.asarray(pip))

    f = jnp.asarray(nuc_freqs)
    pi61 = jnp.prod(f[jnp.asarray(CODON_NT_IDX)], axis=1)
    pi61 = pi61 / pi61.sum()
    single = jnp.asarray(SINGLE_MASK)
    rate = jnp.where(jnp.asarray(TI_MASK), kappa, 1.0) * jnp.where(
        jnp.asarray(NONSYN_MASK), omega, 1.0)
    Q = jnp.where(single, rate * pi61[None, :], 0.0)
    Q = Q - jnp.diag(Q.sum(axis=1))
    Q = Q / (-jnp.sum(pi61 * jnp.diag(Q)))
    s = jnp.sqrt(pi61)
    Sym = (s[:, None] * Q) / s[None, :]
    Sym = 0.5 * (Sym + Sym.T)
    lam, V = jnp.linalg.eigh(Sym)
    U = V / s[:, None]
    U_inv = V.T * s[None, :]
    A = PADDED_STATES
    n = NUM_CODONS
    Up = jnp.eye(A, dtype=U.dtype).at[:n, :n].set(U)
    Uip = jnp.eye(A, dtype=U.dtype).at[:n, :n].set(U_inv)
    vals = jnp.zeros((A,), U.dtype).at[:n].set(lam)
    pip = jnp.zeros((A,), U.dtype).at[:n].set(pi61)
    return EigenDecomp(U=Up, values=vals, U_inv=Uip, pi=pip)


class CodonModel:
    """MG94 codon model facade: eigen ingredients shaped like the 4-state
    models' EigenDecomp so the scan tape (treelike/pruning.py) runs
    unchanged at A=64."""

    def __init__(self, kappa: float = 2.0, omega: float = 0.2,
                 nuc_freqs=(0.25, 0.25, 0.25, 0.25),
                 codon_freqs: Optional[np.ndarray] = None):
        self.pi61 = (np.asarray(codon_freqs) if codon_freqs is not None
                     else codon_frequencies_f1x4(nuc_freqs))
        self.Q61 = mg94_rate_matrix(kappa, omega, self.pi61)
        self.U, self.values, self.U_inv, self.pi = padded_eigen(
            self.Q61, self.pi61)

    def eigen_decomp(self):
        from .substitution import EigenDecomp
        import jax.numpy as jnp

        return EigenDecomp(
            U=jnp.asarray(self.U), values=jnp.asarray(self.values),
            U_inv=jnp.asarray(self.U_inv), pi=jnp.asarray(self.pi))


def codon_log_likelihoods(topologies, branch_lengths, tip_partials,
                          weights, model: CodonModel,
                          category_rates=None,
                          category_proportions=None):
    """Batched codon log likelihoods on the standard scan tape.

    topologies: list of core.tree.Topology; branch_lengths [B, N];
    tip_partials [T, S0, 64] (codon_tip_partials); weights [S0]."""
    import jax.numpy as jnp

    from ..treelike import pruning
    from ..treelike.encode import encode_trees

    B = len(topologies)
    enc = encode_trees(topologies)
    eig1 = model.eigen_decomp()
    bcast = lambda x: jnp.broadcast_to(x, (B,) + x.shape)
    eig = type(eig1)(*(bcast(x) for x in eig1))
    C = 1 if category_rates is None else len(category_rates)
    rates = (jnp.ones((B, 1)) if category_rates is None
             else jnp.broadcast_to(jnp.asarray(category_rates), (B, C)))
    props = (jnp.ones((B, 1)) if category_proportions is None
             else jnp.broadcast_to(jnp.asarray(category_proportions),
                                   (B, C)))
    clock = jnp.ones((B,))
    S0 = tip_partials.shape[1]
    pad = pruning.pad_patterns(S0)
    w = jnp.zeros((pad,)).at[:S0].set(jnp.asarray(weights))
    bl = jnp.asarray(branch_lengths)
    return pruning.log_likelihoods_impl(
        jnp.asarray(enc.post_ops), jnp.asarray(enc.root),
        jnp.asarray(tip_partials), w, bl, eig, rates, props, clock,
        num_slots=enc.num_slots, pattern_pad=pad, category_count=C)


def codon_ll_and_gradients(topologies, branch_lengths, tip_partials,
                           weights, model: CodonModel,
                           category_rates=None,
                           category_proportions=None):
    """Batched codon (LL, linear-time branch gradients) on the standard
    scan tape — the A=64 evolves are [64C, 64C] blocks against [64C, S],
    real matrix products where the 4-state case has 4x4 ones."""
    import jax.numpy as jnp

    from ..treelike import pruning
    from ..treelike.encode import encode_trees

    B = len(topologies)
    enc = encode_trees(topologies)
    eig1 = model.eigen_decomp()
    bcast = lambda x: jnp.broadcast_to(x, (B,) + x.shape)
    eig = type(eig1)(*(bcast(x) for x in eig1))
    C = 1 if category_rates is None else len(category_rates)
    rates = (jnp.ones((B, 1)) if category_rates is None
             else jnp.broadcast_to(jnp.asarray(category_rates), (B, C)))
    props = (jnp.ones((B, 1)) if category_proportions is None
             else jnp.broadcast_to(jnp.asarray(category_proportions),
                                   (B, C)))
    clock = jnp.ones((B,))
    S0 = tip_partials.shape[1]
    pad = pruning.pad_patterns(S0)
    w = jnp.zeros((pad,)).at[:S0].set(jnp.asarray(weights))
    bl = jnp.asarray(branch_lengths)
    return pruning.ll_and_branch_gradients_impl(
        jnp.asarray(enc.post_ops), jnp.asarray(enc.pre_ops),
        jnp.asarray(enc.root), jnp.asarray(enc.edge_mask, bl.dtype),
        jnp.asarray(tip_partials), w, bl, eig, rates, props, clock,
        num_slots=enc.num_slots, pattern_pad=pad, category_count=C)
