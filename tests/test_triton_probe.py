"""The SELL Triton probe (probes/triton_sell.py) in interpret mode: the
same result as the plain-XLA SELL product and the serial oracle, so the
measurement it exists for stays runnable."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from hspmv.bench.matrices import laplacian_2d, power_law, random_banded
from hspmv.formats.sell import SellSlabs
from hspmv.kernels.sell import spmv_sell

_PATH = pathlib.Path(__file__).resolve().parents[1] / "probes" / "triton_sell.py"
_spec = importlib.util.spec_from_file_location("triton_sell_probe", _PATH)
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

MATS = {
    "lap2d_20": lambda: laplacian_2d(20),
    "banded_700": lambda: random_banded(700, 30, 6, seed=1),
    "powerlaw_600": lambda: power_law(600, 5, seed=2),
}


@pytest.mark.parametrize("name", list(MATS))
def test_triton_probe_matches_xla_and_oracle(name):
    mat = MATS[name]()
    lay = SellSlabs.from_csr(mat)
    x = np.random.default_rng(0).standard_normal(mat.n).astype(np.float32)
    y = np.asarray(
        probe.spmv_sell_triton(lay, probe.chunk_starts(lay), jnp.asarray(x))
    )
    assert y.shape == (mat.m,)
    np.testing.assert_allclose(
        y, np.asarray(spmv_sell(lay, jnp.asarray(x))), rtol=1e-6, atol=1e-6
    )
    ref = mat.matvec(x)
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-6


def test_triton_probe_refuses_without_gpu():
    assert probe.main(["lap2d_32"]) == 2
