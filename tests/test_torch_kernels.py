"""The port's kernel ops against ``repro``'s kernel oracles and Pallas ops.

On the CPU each op takes its plain PyTorch version; it is compared with the
JAX ``ref.py`` oracle and with the JAX ``ops.py`` wrapper run with
``interpret=True`` (the Pallas kernel body executed on the CPU), on odd
shapes with masks. Inputs come from numpy with a fixed seed.
Tolerances: f32 elementwise results 1e-6 absolute (values in [-2, 2]);
f32 sums over K ≤ 9 steps 1e-5 relative; bf16 one bf16 ulp at the
values' magnitude (2**-6), as XLA may keep excess precision between bf16
operations. The Triton kernels themselves run only on a CUDA card, in
``test_torch_cuda.py``.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ig_accum.ops import ig_accum as j_ig_accum
from repro.kernels.ig_accum.ref import ig_accum_ref as j_ig_accum_ref
from repro.kernels.interp_accum.ops import interp_accum as j_interp_accum
from repro.kernels.interp_accum.ref import accum_cot_ref as j_accum_cot_ref
from repro.kernels.interp_accum.ref import interp_add_ref as j_interp_add_ref
from repro.kernels.interpolate.ops import interpolate as j_interpolate
from repro.kernels.interpolate.ref import interpolate_ref as j_interpolate_ref
from repro_torch.kernels import common
from repro_torch.kernels.ig_accum.kernel import ig_accum_triton
from repro_torch.kernels.ig_accum.ops import ig_accum
from repro_torch.kernels.ig_accum.ref import ig_accum_ref
from repro_torch.kernels.interp_accum.kernel import accum_cot_triton, interp_add_triton
from repro_torch.kernels.interp_accum.ops import interp_accum
from repro_torch.kernels.interp_accum.ref import accum_cot_ref, interp_add_ref
from repro_torch.kernels.interpolate.kernel import interpolate_triton
from repro_torch.kernels.interpolate.ops import interpolate
from repro_torch.kernels.interpolate.ref import interpolate_ref

torch.set_num_threads(1)

TOL = {"float32": 1e-6, "bfloat16": 2.0**-6}
SHAPES = [(1, 1, (3,)), (3, 5, (7, 11)), (2, 9, (130,))]  # (B, K, feature shape)


def _data(seed, B, K, feat, masked):
    rng = np.random.default_rng(seed)
    d = {
        "x": rng.uniform(-1, 1, (B,) + feat).astype(np.float32),
        "b": rng.uniform(-1, 1, (B,) + feat).astype(np.float32),
        "a": rng.uniform(0, 1, (B, K)).astype(np.float32),
        "w": rng.uniform(0, 0.2, (B, K)).astype(np.float32),
        "acc": rng.normal(0, 1, (B,) + feat).astype(np.float32),
        "g": rng.normal(0, 1, (B, K) + feat).astype(np.float32),
        "u": rng.normal(0, 0.1, (B,) + feat).astype(np.float32),
        "us": rng.normal(0, 0.1, (B, K) + feat).astype(np.float32),
        "seed": rng.normal(0, 1, (B, K) + feat).astype(np.float32),
    }
    d["mask"] = rng.uniform(size=(B, feat[0])) > 0.3 if masked else None
    return d


def _j(a, dtype="float32"):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _t(a, dtype="float32"):
    return None if a is None else torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def _close(t, j, atol, rtol=0.0):
    jn = np.asarray(jnp.asarray(j).astype(jnp.float32))
    tn = t.detach().float().numpy()
    assert tn.shape == jn.shape
    np.testing.assert_allclose(tn, jn, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,feat", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_interpolate_plain_matches_jax(dtype, B, K, feat, masked):
    d = _data(0, B, K, feat, masked)
    m_t = None if d["mask"] is None else torch.from_numpy(d["mask"])
    out = interpolate(_t(d["x"], dtype), _t(d["b"], dtype), _t(d["a"]), mask=m_t)
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == (B, K) + feat
    ref = j_interpolate(_j(d["x"], dtype), _j(d["b"], dtype), _j(d["a"]),
                        mask=_j(d["mask"], "bool"), interpret=True)
    _close(out, ref, TOL[dtype])
    flat = interpolate_ref(_t(d["x"], dtype).reshape(B, -1), _t(d["b"], dtype).reshape(B, -1), _t(d["a"]))
    _close(flat, j_interpolate_ref(_j(d["x"], dtype).reshape(B, -1), _j(d["b"], dtype).reshape(B, -1),
                                   _j(d["a"])), TOL[dtype])


def test_interpolate_shared_alphas_match_per_row():
    d = _data(1, 3, 5, (7, 11), False)
    x, b, a = _t(d["x"]), _t(d["b"]), _t(d["a"])[0]
    assert torch.equal(interpolate(x, b, a), interpolate(x, b, a.expand(3, -1)))


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,feat", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_ig_accum_plain_matches_jax(gdtype, B, K, feat, masked):
    d = _data(2, B, K, feat, masked)
    m_t = None if d["mask"] is None else torch.from_numpy(d["mask"])
    out = ig_accum(_t(d["acc"]), _t(d["g"], gdtype), _t(d["w"]), mask=m_t)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B,) + feat
    ref = j_ig_accum(_j(d["acc"]), _j(d["g"], gdtype), _j(d["w"]),
                     mask=_j(d["mask"], "bool"), interpret=True)
    _close(out, ref, 1e-5, 1e-5)
    flat = ig_accum_ref(_t(d["acc"]).reshape(B, -1), _t(d["g"], gdtype).reshape(B, K, -1), _t(d["w"]))
    _close(flat, j_ig_accum_ref(_j(d["acc"]).reshape(B, -1), _j(d["g"], gdtype).reshape(B, K, -1),
                                _j(d["w"])), 1e-5, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,feat", SHAPES)
@pytest.mark.parametrize("step_carry", [False, True])
def test_interp_add_plain_matches_jax(dtype, B, K, feat, step_carry):
    d = _data(3, B, K, feat, True)
    u = d["us"] if step_carry else d["u"]
    out = interp_accum(_t(d["x"], dtype), _t(d["b"], dtype), _t(d["a"]), _t(u),
                       mask=torch.from_numpy(d["mask"]))
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == (B, K) + feat
    ref = j_interp_accum(_j(d["x"], dtype), _j(d["b"], dtype), _j(d["a"]), _j(u),
                         mask=_j(d["mask"], "bool"), interpret=True)
    _close(out, ref, TOL[dtype])
    uf = _t(u).reshape((B, K, -1) if step_carry else (B, -1))
    flat = interp_add_ref(_t(d["x"], dtype).reshape(B, -1), _t(d["b"], dtype).reshape(B, -1),
                          _t(d["a"]), uf)
    jf = j_interp_add_ref(_j(d["x"], dtype).reshape(B, -1), _j(d["b"], dtype).reshape(B, -1),
                          _j(d["a"]), jnp.asarray(uf.numpy()))
    _close(flat, jf, TOL[dtype])


@pytest.mark.parametrize("B,K,feat", SHAPES)
@pytest.mark.parametrize("step_carry", [False, True])
def test_interp_accum_backward_matches_jax_grad(B, K, feat, step_carry):
    """The autograd op's carry gradient vs ``jax.grad`` through the JAX
    custom-VJP op (interpreted Pallas forward and backward)."""
    d = _data(4, B, K, feat, True)
    u0 = d["us"] if step_carry else d["u"]
    seed = d["seed"]
    x, b, a, mask = _j(d["x"]), _j(d["b"]), _j(d["a"]), _j(d["mask"], "bool")
    gj = jax.grad(lambda u: jnp.sum(
        j_interp_accum(x, b, a, u, mask=mask, interpret=True) * jnp.asarray(seed)))(jnp.asarray(u0))
    ut = _t(u0).requires_grad_()
    out = interp_accum(_t(d["x"]), _t(d["b"]), _t(d["a"]), ut, mask=torch.from_numpy(d["mask"]))
    (gt,) = torch.autograd.grad((out * _t(seed)).sum(), ut)
    _close(gt, gj, 1e-5, 1e-5)
    flat_seed = _t(seed).reshape(B, K, -1)
    _close(accum_cot_ref(flat_seed), j_accum_cot_ref(jnp.asarray(flat_seed.numpy())), 1e-5, 1e-5)


def test_interp_accum_gives_no_endpoint_gradient():
    d = _data(5, 2, 3, (4,), False)
    x = _t(d["x"]).requires_grad_()
    u = _t(d["u"]).requires_grad_()
    out = interp_accum(x, _t(d["b"]), _t(d["a"]), u)
    gx, gu = torch.autograd.grad(out.sum(), (x, u), allow_unused=True)
    assert gx is None
    assert torch.equal(gu, torch.full_like(gu, 3.0))


def test_cpu_path_launches_no_kernel():
    common.reset_launches()
    d = _data(6, 2, 3, (5,), False)
    interpolate(_t(d["x"]), _t(d["b"]), _t(d["a"]))
    ig_accum(_t(d["acc"]), _t(d["g"]), _t(d["w"]))
    u = _t(d["u"]).requires_grad_()
    torch.autograd.grad(interp_accum(_t(d["x"]), _t(d["b"]), _t(d["a"]), u).sum(), u)
    assert common.LAUNCHES == {name: 0 for name in common.LAUNCHES}


def test_mixed_devices_raise():
    with pytest.raises(ValueError):
        common.on_cuda(torch.zeros(2), torch.zeros(2, device="meta"))


@pytest.mark.parametrize("launch", ["interpolate", "ig_accum", "interp_add", "accum_cot"])
def test_triton_wrappers_refuse_cpu_tensors(launch):
    d = _data(7, 2, 3, (5,), False)
    x, b, a, g = _t(d["x"]), _t(d["b"]), _t(d["a"]), _t(d["g"])
    call = {
        "interpolate": lambda: interpolate_triton(x, b, a),
        "ig_accum": lambda: ig_accum_triton(_t(d["acc"]), g, _t(d["w"])),
        "interp_add": lambda: interp_add_triton(x, b, a, _t(d["u"])),
        "accum_cot": lambda: accum_cot_triton(g),
    }[launch]
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_missing_triton_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path))
    monkeypatch.setitem(sys.modules, "triton", None)
    with pytest.raises(RuntimeError, match="triton"):
        common.import_triton()
