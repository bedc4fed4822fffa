#!/usr/bin/env python3
"""The boxed solver's fully periodic float32 solve in both packages, on
the CPU.

    JAX_PLATFORMS=cpu python experiments/boxed_float32_drift.py [SEED ...]

On the sparse periodic tree (``chip_smoke.forest_tree`` kind
"sparse_periodic", base 16, box 4) each seed's right-hand side (normal,
on every box of every level, zero phi: the state of
``tests/test_torch_boxed.py``'s ``seeded``) goes through eight FMGs of
the JAX package's ``MGSolver`` and of the PyTorch package's, in
float32.  Prints one JSON line per seed: both residual histories divided
by their first entry, and the PyTorch solver's coarse-loop host reads
(a coarse solve at its cap of 1000 iterations reads 1001).  Default
seeds: 9 (the test's), 1, 2, 3.  About a minute a seed.
"""
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import octree_mg_tpu as ref  # noqa: E402
from octree_mg_tpu.core import tree as rtm  # noqa: E402
import octree_mg_tpu_torch as port  # noqa: E402
from octree_mg_tpu_torch.core import tree as ptm  # noqa: E402
from octree_mg_tpu_torch.core.constants import IRHS  # noqa: E402
from chip_smoke import forest_tree  # noqa: E402


def run(seed, base=16, box=4, n_fmg=8):
    rs = ref.MGSolver(forest_tree(ref, rtm, "sparse_periodic", base, box),
                      ref.MGConfig(dtype=jnp.float32))
    ps = port.MGSolver(forest_tree(port, ptm, "sparse_periodic", base, box),
                       port.MGConfig(device="cpu", dtype=torch.float32))
    rst, pst = rs.allocate(), ps.allocate()
    rng = np.random.default_rng(seed)
    isl = (slice(None),) + (slice(1, -1),) * 3
    for lvl in rs.levels:
        a = np.zeros(np.asarray(rst["cc"][lvl]).shape)
        a[IRHS][isl] = rng.normal(size=a[IRHS][isl].shape)
        rst["cc"][lvl] = jnp.asarray(a, jnp.float32)
        pst["cc"][lvl].copy_(torch.as_tensor(a, dtype=torch.float32))
    hr, hp = [], []
    for k in range(n_fmg):
        rst, r = rs.fas_fmg(rst, have_guess=k > 0)
        hr.append(float(r))
        pst, r = ps.fas_fmg(pst, have_guess=k > 0)
        hp.append(float(r))
    return {"seed": seed, "jax": [x / hr[0] for x in hr],
            "torch": [x / hp[0] for x in hp],
            "torch_coarse_host_reads": ps.coarse_host_reads}


if __name__ == "__main__":
    torch.set_num_threads(1)
    for s in [int(a) for a in sys.argv[1:]] or [9, 1, 2, 3]:
        print(json.dumps(run(s)), flush=True)
