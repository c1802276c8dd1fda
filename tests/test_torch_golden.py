"""Golden regression of the port: per-method paper-CNN attributions against
the port's checked-in fixtures (tests/golden_torch/cnn_<method>.npz,
produced by ``python -m repro_torch.tools.make_golden --device cpu``).

Replay: the port on the CPU runs ``make_golden``'s pipeline again (its
numpy-drawn weights and batch, the CPU draws of the ensembles and masks)
and must match each fixture within ``repro``'s bands (``tests/test_golden.py``):
attributions at rtol 1e-3 with an atol of 1e-5 plus 1e-3 of the largest
|attribution|, f(x) and f(x′) at rtol 1e-4 / atol 1e-5, δ at 1e-2 / 1e-4.

Anchor: for ``ig``, ``idgi`` and ``occlusion`` (no draws) live ``repro``
gets the same numpy weights and batch, through ``repro``'s own
``tools/make_golden.py`` explainer and perturbation pipeline, and must match
the fixture at ``tests/test_torch_zoo.py``'s tolerances: 1e-4 of the
largest |attribution| and 1e-6 absolute on f(x), f(x′) and δ. So a change
that moves a kernel and its plain version together, or the port and its
fixtures together, still meets the reference here.
"""
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CONFIG as J_CONFIG
from repro.models import cnn as jcnn
from repro_torch.core.methods import METHODS
from repro_torch.tools import make_golden as mg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_golden as jmg  # noqa: E402  (repro's tool: its explainer and perturbation pipeline)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden_torch")
RTOL = 1e-3
ATOL = 1e-5


def _fixture(method: str):
    path = os.path.join(GOLDEN_DIR, f"cnn_{method}.npz")
    assert os.path.exists(path), (
        f"missing golden fixture {path} — run PYTHONPATH=src python -m "
        "repro_torch.tools.make_golden --device cpu and commit the result"
    )
    return np.load(path)


@functools.cache
def _port_result(method: str):
    torch.set_num_threads(1)
    f, x, bl, t = mg.golden_inputs("cpu")
    return mg.golden_result(f, x, bl, t, method, "cpu")


def test_seven_fixtures_one_per_method():
    assert sorted(os.listdir(GOLDEN_DIR)) == sorted(f"cnn_{m}.npz" for m in METHODS)
    assert len(METHODS) == 7
    for m in METHODS:
        assert _fixture(m)["meta"].tolist() == [mg.SEED, mg.BATCH, mg.M, mg.N_INT, mg.N_SAMPLES]


@pytest.mark.parametrize("method", sorted(METHODS))
def test_golden_attributions(method):
    want = _fixture(method)
    res = _port_result(method)
    got = res.attributions.numpy()
    assert got.shape == want["attributions"].shape and got.dtype == np.float32
    atol = ATOL + RTOL * float(np.abs(want["attributions"]).max())
    np.testing.assert_allclose(got, want["attributions"], rtol=RTOL, atol=atol,
                               err_msg=f"{method} attributions drifted beyond the golden band")
    np.testing.assert_allclose(res.f_x.numpy(), want["f_x"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.f_baseline.numpy(), want["f_baseline"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.delta.numpy(), want["delta"], rtol=1e-2, atol=1e-4)


@functools.cache
def _jax_inputs():
    tree, x, t = mg.golden_arrays()
    f = lambda xs, tt: jcnn.prob_fn(J_CONFIG, tree, xs, tt)
    x = jnp.asarray(x)
    return f, x, jnp.zeros_like(x), jnp.asarray(t)


@pytest.mark.parametrize("method", ["ig", "idgi", "occlusion"])
def test_fixture_matches_live_repro(method):
    f, x, bl, t = _jax_inputs()
    if METHODS[method].forward_only:
        ref = jmg.golden_perturb_result(f, x, bl, t, method)
    else:
        ref = jmg.golden_explainer(f, method).attribute(x, bl, t)
    want = _fixture(method)
    attr = np.asarray(ref.attributions)
    assert attr.shape == want["attributions"].shape
    np.testing.assert_allclose(want["attributions"], attr, rtol=0, atol=1e-4 * np.abs(attr).max())
    for key, got in (("f_x", ref.f_x), ("f_baseline", ref.f_baseline), ("delta", ref.delta)):
        np.testing.assert_allclose(want[key], np.asarray(got), rtol=0, atol=1e-6, err_msg=key)
