"""PhyloModel: bundle of substitution + site + clock models with a
block-specified flat parameter vector.

JAX rebuild of the reference PhyloModel / BlockSpecification
(reference: src/phylo_model.hpp:13-63, src/block_specification.hpp:17-74).
Parameters live in a flat per-tree vector carved into named segments; the
block map keys match the reference's Python-exposed names
(src/phylo_model.hpp:44-63) so `phylo_model_param_block_map` round-trips.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import jax.numpy as jnp

from .clock import ClockModelSpec
from .site import SiteModelSpec
from .substitution import SubstitutionModelSpec, EigenDecomp


@dataclass(frozen=True)
class PhyloModelSpecification:
    """Mirror of bito.PhyloModelSpecification (src/phylo_model.hpp:13-17)."""

    substitution: str = "JC69"
    site: str = "constant"
    clock: str = "none"


class PhyloModel:
    ENTIRE_KEY = "entire"

    def __init__(self, spec: PhyloModelSpecification):
        self.spec = spec
        self.substitution = SubstitutionModelSpec(spec.substitution)
        self.site = SiteModelSpec(spec.site)
        self.clock = ClockModelSpec(spec.clock)
        # Build the block specification: (start, length) per key, in
        # substitution, site, clock order (reference PhyloModel ctor).
        blocks: Dict[str, Tuple[int, int]] = {}
        offset = 0
        for sub in (self.substitution, self.site, self.clock):
            for key, count in sub.param_counts.items():
                blocks[key] = (offset, count)
                offset += count
        self.blocks = blocks
        self.param_count = offset

    def block_keys(self):
        return list(self.blocks.keys())

    def default_param_vector(self) -> np.ndarray:
        v = np.zeros(self.param_count)
        for sub in (self.substitution, self.site, self.clock):
            defaults = sub.default_params()
            for key, val in defaults.items():
                start, length = self.blocks[key]
                v[start:start + length] = np.asarray(val)
        return v

    def split_param_vector(self, vec: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        """Carve a flat vector (possibly batched on leading axes) into the
        named segments (reference BlockSpecification::ParameterSegmentMapOf)."""
        out = {}
        for key, (start, length) in self.blocks.items():
            out[key] = vec[..., start:start + length]
        return out

    # Device-side model ingredients -------------------------------------
    def eigen(self, params: Dict[str, jnp.ndarray]) -> EigenDecomp:
        return self.substitution.eigen(params)

    def category_rates(self, params: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        return self.site.category_rates(params)

    def category_proportions(self, params: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        return self.site.category_proportions(params)

    def clock_rate(self, params: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        return self.clock.rate(params)

    def rate_matrix(self, params: Dict[str, jnp.ndarray]):
        """Padded Q for uniformized transition matrices (codon models);
        None for models served by the eigen route."""
        return self.substitution.rate_matrix(params)

    @property
    def category_count(self) -> int:
        return self.site.category_count

    @property
    def num_states(self) -> int:
        """Per-state dimension A (4 for nucleotide models, 64 for the
        padded codon models); flows into every engine buffer shape."""
        return self.substitution.num_states
