"""Parity of ``repro_torch.core.paths`` with ``repro.core.paths`` on the CPU.

Inputs are drawn with numpy from a fixed seed and fed to both packages.
Tolerances: f32 results agree to 1e-6 absolute (values in [-2, 2], a few
roundings apart at most); bf16 results to one bf16 ulp at that magnitude
(2**-6 = 0.015625), since XLA may keep excess f32 precision between bf16
operations where PyTorch rounds after each.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paths as jpaths
from repro_torch.core import paths as tpaths

torch.set_num_threads(1)

TOL = {"float32": 1e-6, "bfloat16": 2.0**-6}


def _inputs(seed, B=3, feat=(5, 7), K=6, per_row=True, masked=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B,) + feat).astype(np.float32)
    b = rng.uniform(-1, 1, (B,) + feat).astype(np.float32)
    a = rng.uniform(0, 1, (B, K) if per_row else (K,)).astype(np.float32)
    mask = (rng.uniform(size=(B, feat[0])) > 0.3) if masked else None
    return x, b, a, mask


def _pair(arr, dtype):
    """The same numbers as a jax array and a torch tensor of ``dtype``."""
    if arr is None:
        return None, None
    return jnp.asarray(arr).astype(dtype), torch.from_numpy(np.array(arr)).to(getattr(torch, dtype))


def _close(j, t, dtype):
    jn = np.asarray(jnp.asarray(j).astype(jnp.float32))
    tn = t.float().numpy()
    assert jn.shape == tn.shape
    np.testing.assert_allclose(tn, jn, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_interpolate_matches_jax(dtype, per_row, masked):
    x, b, a, mask = _inputs(0, per_row=per_row, masked=masked)
    (xj, xt), (bj, bt) = _pair(x, dtype), _pair(b, dtype)
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else torch.from_numpy(mask)
    out_t = tpaths.interpolate(xt, bt, at, mask=mt)
    assert out_t.dtype == getattr(torch, dtype)
    _close(jpaths.interpolate(xj, bj, aj, mask=mj), out_t, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step_carry", [False, True])
def test_interp_add_matches_jax(dtype, step_carry):
    x, b, a, mask = _inputs(1, masked=True)
    rng = np.random.default_rng(2)
    shape = (3, 6, 5, 7) if step_carry else (3, 5, 7)
    carry = rng.normal(0, 0.1, shape).astype(np.float32)
    (xj, xt), (bj, bt) = _pair(x, dtype), _pair(b, dtype)
    out_t = tpaths.interp_add(xt, bt, torch.from_numpy(a), torch.from_numpy(carry),
                              mask=torch.from_numpy(mask))
    out_j = jpaths.interp_add(xj, bj, jnp.asarray(a), jnp.asarray(carry), mask=jnp.asarray(mask))
    _close(out_j, out_t, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interp_add_at_zero_carry_equals_interpolate(dtype):
    """The dtype contract: at carry 0 the fused unit gives the unfused nodes."""
    x, b, a, _ = _inputs(3)
    (_, xt), (_, bt) = _pair(x, dtype), _pair(b, dtype)
    at = torch.from_numpy(a)
    zero = torch.zeros(xt.shape, dtype=torch.float32)
    assert torch.equal(tpaths.interp_add(xt, bt, at, zero), tpaths.interpolate(xt, bt, at))


@pytest.mark.parametrize("scalar", [True, False])
def test_at_alpha_matches_jax(scalar):
    x, b, _, _ = _inputs(4)
    alpha = np.float32(0.3) if scalar else np.array([0.1, 0.5, 0.9], np.float32)
    out_t = tpaths.at_alpha(torch.from_numpy(x), torch.from_numpy(b), torch.as_tensor(alpha))
    out_j = jpaths.at_alpha(jnp.asarray(x), jnp.asarray(b), jnp.asarray(alpha))
    _close(out_j, out_t, "float32")


def test_mask_to_baseline_is_exact():
    x, b, _, mask = _inputs(5, masked=True)
    out_t = tpaths.mask_to_baseline(torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(mask))
    out_j = jpaths.mask_to_baseline(jnp.asarray(x), jnp.asarray(b), jnp.asarray(mask))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    xt = torch.from_numpy(x)
    assert tpaths.mask_to_baseline(xt, torch.from_numpy(b), None) is xt
