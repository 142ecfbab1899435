"""bito_tpu: a JAX phylogenetic likelihood + variational-inference
framework with the capabilities of phylovi/bito.

Public surface mirrors the reference pybind module `bito`
(reference: src/pybito.cpp:91-1288): instances, tree collections, model
specifications, and bitset factories, with the compute path rebuilt on
JAX/XLA (batched Felsenstein pruning, levelized subsplit-DAG wavefronts,
pjit site-pattern sharding) instead of BEAGLE/Eigen.
"""

import os as _os


def _maybe_init_distributed():
    """Join a multi-process job before anything can initialize the XLA
    backend (jax.distributed.initialize must run first).  Activated by the
    BITO_COORDINATOR env var, which bito_tpu.dist.launch sets; explicit
    callers can instead run bito_tpu.dist.multihost.initialize(...) before
    importing the package."""
    if not _os.environ.get("BITO_COORDINATOR"):
        return
    import jax

    if _os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", _os.environ["JAX_PLATFORMS"])
    jax.distributed.initialize(
        coordinator_address=_os.environ["BITO_COORDINATOR"],
        num_processes=int(_os.environ["BITO_NUM_PROCESSES"]),
        process_id=int(_os.environ["BITO_PROCESS_ID"]),
    )


_maybe_init_distributed()


def _default_compilation_cache():
    """Persistent XLA compilation cache, on by default (the NNI search and
    GP workflows recompile per DAG-growth epoch; a warm cache turns
    multi-second epoch compiles into millisecond lookups across runs).
    A set JAX_COMPILATION_CACHE_DIR (or jax config value) wins; otherwise
    the cache lives at the fixed path `.jax_cache` beside the package, so
    every process of one checkout finds the same entries."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    if jax.config.jax_compilation_cache_dir:
        return
    cache = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_default_compilation_cache()

from .api.instances import (
    GenericSBNInstance,
    PhyloGradient,
    RootedSBNInstance,
    UnrootedSBNInstance,
    rooted_instance,
    unrooted_instance,
)
from .core.bitset import PCSP, Subsplit
from .core.newick import (
    parse_newick_file,
    parse_newick_text,
    parse_nexus_file,
    read_fasta,
)
from .core.site_pattern import SitePattern
from .core.tree import Topology, Tree, TreeCollection
from .models.phylo_model import PhyloModel, PhyloModelSpecification

__version__ = "0.1.0"

__all__ = [
    "GenericSBNInstance",
    "PhyloGradient",
    "RootedSBNInstance",
    "UnrootedSBNInstance",
    "rooted_instance",
    "unrooted_instance",
    "PCSP",
    "Subsplit",
    "parse_newick_file",
    "parse_newick_text",
    "parse_nexus_file",
    "read_fasta",
    "SitePattern",
    "Topology",
    "Tree",
    "TreeCollection",
    "PhyloModel",
    "PhyloModelSpecification",
]

# Flag-name constants (mirror of the reference submodule bito.phylo_flags,
# src/pybito.cpp:1269-1287).
from .treelike import phylo_flags as phylo_flags  # noqa: E402

# Gradient/model map-key constants (mirror of bito.phylo_gradient_mapkeys /
# bito.phylo_model_mapkeys).
class phylo_gradient_mapkeys:
    BRANCH_LENGTHS = "branch_lengths"
    RATIOS_ROOT_HEIGHT = "ratios_root_height"
    SUBSTITUTION_MODEL = "substitution_model"
    SITE_MODEL = "site_model"
    CLOCK_MODEL = "clock_model"


class phylo_model_mapkeys:
    SUBSTITUTION_MODEL_RATES = "substitution_model_rates"
    SUBSTITUTION_MODEL_FREQUENCIES = "substitution_model_frequencies"
    SITE_MODEL_PARAMETERS = "site_model_parameters"
    CLOCK_MODEL_RATES = "clock_model_rates"


def _git_info(kind: str) -> str:
    import subprocess, os

    try:
        out = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.abspath(__file__)),
             {"commit": "rev-parse", "branch": "rev-parse",
              "tags": "describe"}[kind],
             *({"commit": ["HEAD"], "branch": ["--abbrev-ref", "HEAD"],
                "tags": ["--tags", "--always"]}[kind])],
            capture_output=True, text=True, timeout=10,
        )
        return out.stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def git_commit() -> str:
    """Reference bito.git_commit."""
    return _git_info("commit")


def git_branch() -> str:
    return _git_info("branch")


def git_tags() -> str:
    return _git_info("tags")


from .core.bitset import (  # noqa: E402
    subsplit,
    pcsp,
    subsplit_to_string,
    subsplit_get_clade,
    subsplit_is_leaf,
    subsplit_is_rootsplit,
    subsplit_is_uca,
    pcsp_to_string,
    pcsp_get_parent_subsplit,
    pcsp_get_child_subsplit,
    clade_get_count,
    to_hash_string,
)
from .api.gp import gp_instance, GPInstance  # noqa: E402
