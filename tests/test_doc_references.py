"""Docstring honesty: code references in docstrings must resolve.

Round-2 review found a module docstring advertising a function
(`score_proposed_nnis_batched`) that did not exist anywhere in the repo —
the second doc-vs-code misstatement in two rounds.  This test makes that
class of claim falsifiable by CI: every backticked repo file path and every
backticked snake_case symbol mentioned in a bito_tpu docstring must exist
in the source tree.
"""
import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "bito_tpu"

FILE_RE = re.compile(r"`([\w/.-]+\.py)`")
SYM_RE = re.compile(r"`([a-z_][a-z0-9_]*[a-z0-9])`")
# Backticked lowercase tokens that are prose/config vocabulary, not symbols.
PROSE = {
    "auto", "scan", "top_k", "drop",
    "tp_likelihood", "tp_parsimony", "gp_likelihood", "numpy", "orbax",
    "optax", "jax", "click", "gzip", "nni", "gp", "tp", "vip", "bito",
    "pybito", "physher", "zcrabbit", "hello", "fasta", "newick", "nexus",
}


def _docstrings(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            doc = ast.get_docstring(node)
            if doc:
                yield doc


@pytest.fixture(scope="module")
def source_blob():
    """All repo python/C++ source concatenated (symbol existence oracle)."""
    parts = []
    for p in list(REPO.glob("*.py")) + list(PKG.rglob("*.py")) + list(
            (REPO / "scripts").glob("*.py")) + list(
            (REPO / "tests").glob("*.py")) + list(
            PKG.rglob("*.cpp")):
        parts.append(p.read_text())
    return "\n".join(parts)


def test_docstring_file_references_exist():
    missing = []
    for path in PKG.rglob("*.py"):
        for doc in _docstrings(path):
            for ref in FILE_RE.findall(doc):
                if ref in ("script.py",):  # usage-example placeholder
                    continue
                if ref.startswith(("src/", "test/", "vip/", "data/")):
                    target = pathlib.Path("/root/reference") / ref
                else:
                    rel = ref.lstrip("./")
                    target = REPO / rel
                    if not target.exists():
                        target = PKG / rel
                if not target.exists():
                    missing.append((str(path), ref))
    assert not missing, f"docstrings reference nonexistent files: {missing}"


def test_docstring_symbol_references_exist(source_blob):
    missing = []
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        for doc in _docstrings(path):
            for sym in SYM_RE.findall(doc):
                if "_" not in sym or sym in PROSE:
                    continue
                # The symbol must appear somewhere outside this docstring —
                # as a definition, assignment, attribute, or key.
                if source_blob.count(sym) <= doc.count(sym):
                    missing.append((str(path), sym))
    assert not missing, (
        f"docstrings claim symbols absent from the source tree: {missing}")


def _smoke_tolerances():
    """{check name: tolerance} of every check() call in chip_smoke.py."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "check" and len(node.args) == 3):
            name, _, tol = node.args
            out[ast.unparse(name)] = ast.literal_eval(tol)
    return out


def test_notes_parity_claims_not_better_than_bench():
    """The docs may not quote a parity better than what chip_smoke.py
    asserts on the GPU: an 'Ne-M rel' claim in IMPLEMENTATION_NOTES.md or
    README.md must be no smaller than half the tightest tolerance asserted
    for that precision (f64 claims against the f64 checks, every other
    claim against the f32 ones)."""
    tols = _smoke_tolerances()
    f32 = [t for name, t in tols.items() if "f64" not in name]
    f64 = [t for name, t in tols.items() if "f64" in name]
    assert f32 and f64, f"chip_smoke.py checks not found: {tols}"
    offenders = []
    for doc in ("IMPLEMENTATION_NOTES.md", "README.md"):
        for line in (REPO / doc).read_text().splitlines():
            floor = min(f64 if "f64" in line else f32) / 2
            for claim in re.finditer(r"([0-9.]+e-[0-9]+)\s+rel", line):
                if float(claim.group(1)) < floor:
                    offenders.append((doc, claim.group(0)))
    assert not offenders, (
        f"docs claim parity better than chip_smoke.py asserts: {offenders}")
