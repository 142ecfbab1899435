"""Measure A=64 codon-model LL+gradient throughput on the attached device:
the [64C, 64C] evolves are real matrix products, unlike the 4x4 blocks of
the 4-state case.  27-taxon simulated DS1-shape topologies, 300 random
codon patterns, batch 50, calling models/codon.py directly."""
import os, sys, tempfile, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax, jax.numpy as jnp
from bito_tpu.core.newick import parse_nexus_file
from bito_tpu.models import codon as cd
from bito_tpu.utils import simulate

with tempfile.TemporaryDirectory() as tmp:
    coll = parse_nexus_file(
        simulate.write_files(simulate.simulate(0), tmp)["nexus"])
B, S = 50, 300
topos = [coll.trees[i % len(coll.trees)].topology for i in range(B)]
rng = np.random.default_rng(0)
N = max(t.num_nodes for t in topos)
bl = rng.uniform(0.02, 0.5, (B, N)).astype(np.float32)
T = topos[0].num_taxa
states = rng.integers(0, 61, (T, S))
tips = np.zeros((T, S, 64), np.float32)
tips[np.arange(T)[:, None], np.arange(S)[None, :], states] = 1.0
w = np.ones(S, np.float32)
model = cd.CodonModel()
iters = 10

@jax.jit
def sweep(b):
    def body(carry, k):
        ll, g = cd.codon_ll_and_gradients(topos, b * (1 + 1e-3 * k),
                                          tips, w, model)
        return carry + ll.sum() + g.sum(), 0.0
    tot, _ = jax.lax.scan(body, jnp.zeros(()),
                          jnp.arange(iters, dtype=jnp.float32))
    return tot

blj = jnp.asarray(bl)
t0 = time.perf_counter()
v0 = sweep(blj)
v0.block_until_ready()
print(f"compile {time.perf_counter()-t0:.1f}s tot={float(v0):.4f}",
      flush=True)
times = []
for r in range(4):
    arg = (blj * (1 + 1e-4 * (r + 1))).block_until_ready()
    t0 = time.perf_counter()
    v = sweep(arg)
    v.block_until_ready()
    times.append(time.perf_counter() - t0)
    print(f"rep {r}: {times[-1]:.4f}s tot={float(v):.4f}", flush=True)
med = float(np.median(times))
rate = B * iters / med
print(f"A=64 MG94 LL+gradient on {jax.devices()[0].device_kind}: "
      f"{rate:.0f} evals/s ({med/iters*1e3:.1f} ms/batch-eval, "
      f"B={B}, S={S})", flush=True)
