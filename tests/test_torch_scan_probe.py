"""The prof_scan probe's plain version against the TPU probe itself.

scripts/prof_scan.py runs its timing loop when imported, so its `make`
function is taken out of the source with `ast` and executed in a namespace
of its own: `pl.pallas_call` in interpret mode, and a small block (P = 16
rows of C = 128 lanes, STEPS = 4) in place of the script's constants.
Each kind's result (matmul, cumsum, roll) on the script's input (0.001
everywhere) and on a seeded normal block is held to
`ops.scan_probe.scan_probe_plain` within 1e-5 of the block's max |value|
(float32 sums in another order). The kernel itself is held to the plain
version on the card (tests/test_torch_kernels.py).
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from wheat3dgs_tpu_torch.ops import scan_probe as SP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, C, STEPS = 16, 128, 4


def _jax_make():
    path = os.path.join(ROOT, "scripts", "prof_scan.py")
    tree = ast.parse(open(path).read(), filename=path)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "make")
    interp = type("pl", (), {
        "pallas_call": staticmethod(functools.partial(pl.pallas_call,
                                                      interpret=True))})
    ns = {"jax": jax, "jnp": jnp, "pl": interp, "pltpu": pltpu,
          "P": P, "C": C, "STEPS": STEPS}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns["make"]


@pytest.mark.parametrize("start", ["ones", "normal"])
def test_scan_probe_plain_matches_jax_probe(start):
    make = _jax_make()
    if start == "ones":
        x = np.full((P, C), 0.001, np.float32)
    else:
        x = np.random.default_rng(4).normal(size=(P, C)).astype(np.float32)
    for kind in SP.KINDS:
        want = np.asarray(make(kind)(jnp.asarray(x)))
        got = SP.scan_probe_plain(torch.from_numpy(x), kind, STEPS).numpy()
        scale = np.abs(want).max()
        assert scale > 0, kind
        assert np.abs(got - want).max() <= 1e-5 * scale, kind
        # On a CPU tensor the wrapper is the plain version.
        np.testing.assert_array_equal(
            SP.scan_probe(torch.from_numpy(x), kind, STEPS).numpy(), got)


def test_scan_probe_rejects_bad_arguments():
    x = torch.zeros((8, C))
    with pytest.raises(ValueError, match="unknown scan kind"):
        SP.scan_probe(x, "sort", 1)
    with pytest.raises(ValueError, match="steps"):
        SP.scan_probe(x, "cumsum", -1)
