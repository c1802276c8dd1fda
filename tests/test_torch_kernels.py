"""The port's kernel ops against ``repro``'s kernel oracles and Pallas ops.

On the CPU each op takes its plain PyTorch version; it is compared with the
JAX ``ref.py`` oracle and with the JAX ``ops.py`` wrapper run with
``interpret=True`` (the Pallas kernel body executed on the CPU), on odd
shapes with masks. Inputs come from numpy with a fixed seed.
Tolerances: f32 elementwise results 1e-6 absolute (values in [-2, 2]);
f32 sums over K ≤ 9 steps 1e-5 relative; bf16 one bf16 ulp at the
values' magnitude (2**-6), as XLA may keep excess precision between bf16
operations. IDGI (both kernels' plain versions and the op): 1e-5 of the
largest |value| plus 1e-5 relative, the dot products over F summed in
another order (bf16 gradients are widened to f32 on both sides first). The Triton kernels themselves run only on a CUDA card, in
``test_torch_cuda.py``.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ig_accum.ops import ig_accum as j_ig_accum
from repro.kernels.ig_accum.ops import ig_accum_idgi as j_ig_accum_idgi
from repro.kernels.ig_accum.ref import ig_accum_idgi_ref as j_ig_accum_idgi_ref
from repro.kernels.ig_accum.ref import ig_accum_ref as j_ig_accum_ref
from repro.kernels.interp_accum.ops import interp_accum as j_interp_accum
from repro.kernels.interp_accum.ref import accum_cot_ref as j_accum_cot_ref
from repro.kernels.interp_accum.ref import interp_add_ref as j_interp_add_ref
from repro.kernels.interpolate.ops import interpolate as j_interpolate
from repro.kernels.interpolate.ref import interpolate_ref as j_interpolate_ref
from repro_torch.kernels import common
from repro_torch.kernels.ig_accum.kernel import idgi_dots_triton, ig_accum_sq_triton, ig_accum_triton
from repro_torch.kernels.ig_accum.ops import accum_fn_for, ig_accum, ig_accum_idgi
from repro_torch.kernels.ig_accum.ref import (
    idgi_coeff,
    idgi_dots_ref,
    ig_accum_idgi_ref,
    ig_accum_ref,
    ig_accum_sq_ref,
)
from repro_torch.kernels.interp_accum.kernel import (
    INTERP_ADD_VALUES,
    accum_cot_triton,
    interp_add_plan,
    interp_add_triton,
)
from repro_torch.kernels.interp_accum.ops import interp_accum
from repro_torch.kernels.interp_accum.ref import accum_cot_ref, interp_add_ref
from repro_torch.kernels.interpolate.kernel import interpolate_triton
from repro_torch.kernels.interpolate.ops import interpolate
from repro_torch.kernels.interpolate.ref import interpolate_ref

torch.set_num_threads(1)

TOL = {"float32": 1e-6, "bfloat16": 2.0**-6}
SHAPES = [(1, 1, (3,)), (3, 5, (7, 11)), (2, 9, (130,))]  # (B, K, feature shape)
# (B, K, F): the K-sweeps' tile edges on the card (test_torch_cuda.py's
# RAGGED_SWEEPS): K=1, K not a multiple of their UNROLL, F one past a 128-,
# 2048- and, in bf16, a 256- or 4096-column tile
RAGGED_SWEEPS = [(16, 1, 3072), (16, 37, 3073), (16, 63, 2049), (16, 9, 2048 * 37 + 1),
                 (16, 7, 4096 * 19 + 1)]


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


IDGI_SHAPES = SHAPES + [(5, 37, (31, 29, 3))]  # the last: ragged K and F at image width


def _idgi_close(t, j):
    jn = np.asarray(j, np.float32)
    _close(t, jn, 1e-5 * np.abs(jn).max(), 1e-5)


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,feat", IDGI_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_ig_accum_idgi_plain_matches_jax(gdtype, B, K, feat, masked):
    """The op (both kernels' plain versions and the coefficient between
    them) against JAX's op with its Pallas kernels interpreted, on odd
    shapes that exercise its K/F padding, with ragged masks."""
    d = _data(8, B, K, feat, masked)
    m_t = None if d["mask"] is None else torch.from_numpy(d["mask"])
    diff = d["x"] - d["b"]
    out = ig_accum_idgi(_t(d["acc"]), _t(d["g"], gdtype), _t(d["w"]), diff=_t(diff, gdtype), mask=m_t)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B,) + feat
    ref = j_ig_accum_idgi(_j(d["acc"]), _j(d["g"], gdtype), _j(d["w"]), diff=_j(diff, gdtype),
                          mask=_j(d["mask"], "bool"), interpret=True)
    _idgi_close(out, ref)
    # the plain versions on flat operands against JAX's oracle
    gf = _t(d["g"], gdtype).reshape(B, K, -1)
    flat = ig_accum_idgi_ref(_t(d["acc"]).reshape(B, -1), gf, _t(d["w"]), _t(diff, gdtype).reshape(B, -1))
    _idgi_close(flat, j_ig_accum_idgi_ref(_j(d["acc"]).reshape(B, -1), _j(d["g"], gdtype).reshape(B, K, -1),
                                          _j(d["w"]), _j(diff, gdtype).reshape(B, -1)))
    s, p = idgi_dots_ref(gf, _t(diff, gdtype).reshape(B, -1))
    g32 = np.asarray(_j(d["g"], gdtype).astype(jnp.float32)).reshape(B, K, -1)
    d32 = np.asarray(_j(diff, gdtype).astype(jnp.float32)).reshape(B, -1)
    _idgi_close(s, np.einsum("bkf,bkf->bk", g32, g32))
    _idgi_close(p, np.einsum("bkf,bf->bk", g32, d32))
    c = idgi_coeff(_t(d["w"]), s, p)
    _idgi_close(ig_accum_sq_ref(_t(d["acc"]).reshape(B, -1), gf, c), flat)


def test_ig_accum_idgi_zero_gradient_rows():
    """⟨g, g⟩ == 0 steps contribute exactly 0, never NaN, on both sides —
    a whole row of zero gradients and single zero steps of another row."""
    d = _data(9, 3, 6, (7, 5), False)
    g = d["g"].copy()
    g[0] = 0.0
    g[1, ::2] = 0.0
    args = (d["acc"], g, d["w"])
    out = ig_accum_idgi(*map(_t, args), diff=_t(d["x"] - d["b"]))
    ref = j_ig_accum_idgi(*map(_j, args), diff=_j(d["x"] - d["b"]), interpret=True)
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], _t(d["acc"])[0])
    _idgi_close(out, ref)
    s, p = idgi_dots_ref(_t(g).reshape(3, 6, -1), _t(d["x"] - d["b"]).reshape(3, -1))
    c = idgi_coeff(_t(d["w"]), s, p)
    assert not c[0].any() and not c[1, ::2].any() and c[1, 1::2].all()


def test_accum_fn_for_maps_classes_to_ops():
    assert accum_fn_for("riemann") is ig_accum and accum_fn_for("idgi") is ig_accum_idgi
    with pytest.raises(ValueError, match="idgi"):
        accum_fn_for("nope")


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,F", RAGGED_SWEEPS)
@pytest.mark.parametrize("step_carry", [False, True])
def test_interp_add_plain_matches_jax_at_sweep_edges(dtype, B, K, F, step_carry):
    """The kernel's plain version against JAX's at ``common.sweep_tile``'s
    edges, where the card's K-sweep of stores masks its last rows and
    columns, with each carry rank. The JAX side is its plain reference:
    the Pallas op in interpret mode pads F to its 512-column tiles and takes
    tens of seconds at these widths (it is run at small shapes above)."""
    rng = np.random.default_rng(K)
    x, b = (rng.uniform(-1, 1, (B, F)).astype(np.float32) for _ in range(2))
    a = rng.uniform(0, 1, (B, K)).astype(np.float32)
    u = rng.normal(0, 0.1, (B, K, F) if step_carry else (B, F)).astype(np.float32)
    out = interp_add_ref(_t(x, dtype), _t(b, dtype), _t(a), _t(u))
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == (B, K, F)
    _close(out, j_interp_add_ref(_j(x, dtype), _j(b, dtype), _j(a), _j(u)), TOL[dtype])


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
    ig_accum_idgi(_t(d["acc"]), _t(d["g"]), _t(d["w"]), diff=_t(d["x"]))
    u = _t(d["u"]).requires_grad_()
    torch.autograd.grad(interp_accum(_t(d["x"]), _t(d["b"]), _t(d["a"]), u).sum(), u)
    us = _t(d["g"]).requires_grad_()  # the per-step carry
    torch.autograd.grad(interp_accum(_t(d["x"]), _t(d["b"]), _t(d["a"]), us).sum(), us)
    assert common.LAUNCHES == {name: 0 for name in common.LAUNCHES}
    assert common.CARRY_RANKS == {2: 0, 3: 0}


def test_mixed_devices_raise():
    with pytest.raises(ValueError):
        common.on_cuda(torch.zeros(2), torch.zeros(2, device="meta"))


@pytest.mark.parametrize("launch", ["interpolate", "ig_accum", "idgi_dots", "ig_accum_sq",
                                    "interp_add", "interp_add_step", "accum_cot"])
def test_triton_wrappers_refuse_cpu_tensors(launch):
    d = _data(7, 2, 3, (5,), False)
    x, b, a, g = _t(d["x"]), _t(d["b"]), _t(d["a"]), _t(d["g"])
    call = {
        "interpolate": lambda: interpolate_triton(x, b, a),
        "ig_accum": lambda: ig_accum_triton(_t(d["acc"]), g, _t(d["w"])),
        "idgi_dots": lambda: idgi_dots_triton(g, x),
        "ig_accum_sq": lambda: ig_accum_sq_triton(_t(d["acc"]), g, _t(d["w"])),
        "interp_add": lambda: interp_add_triton(x, b, a, _t(d["u"])),
        "interp_add_step": lambda: interp_add_triton(x, b, a, _t(d["us"])),
        "accum_cot": lambda: accum_cot_triton(g),
    }[launch]
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_missing_triton_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path))
    monkeypatch.setitem(sys.modules, "triton", None)
    with pytest.raises(RuntimeError, match="triton"):
        common.import_triton()


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F", [(16, 224 * 224 * 3), (16, 3072), (1, 3), (5, 4099), (3, 100_003),
                                 (64, 3072), (1, 1 << 22)])
def test_sweep_tile_choices(sms, dtype, B, F):
    """The K-sweeps' shared tile chooser (accum_cot, ig_accum, ig_accum_sq),
    a pure function of (B, F, dtype, SMs): 16 bytes a thread a row or more,
    the widest tile of ``SWEEP_ROW_BYTES`` that gives every SM
    ``SWEEP_PROGRAMS_PER_SM`` programs, else the narrowest; and accum_cot's
    choices at both stage-2 shapes as they were."""
    widths = [n // dtype.itemsize for n in common.SWEEP_ROW_BYTES]
    block, warps = common.sweep_tile(B, F, dtype, sms)
    assert block in widths and block * dtype.itemsize // (32 * warps) >= 16
    enough = lambda w: B * -(-F // w) >= common.SWEEP_PROGRAMS_PER_SM * sms
    assert enough(block) or block == widths[-1]
    assert not any(enough(w) for w in widths[: widths.index(block)])  # no wider tile would do
    if dtype == torch.float32 and sms == 132 and (B, F) in ((16, 224 * 224 * 3), (16, 3072)):
        assert (block, warps) == {224 * 224 * 3: (2048, 4), 3072: (128, 1)}[F]


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F", [(16, 224 * 224 * 3), (16, 3072), (1, 3), (5, 4099), (3, 100_003),
                                 (64, 3072), (1, 1 << 22)])
@pytest.mark.parametrize("step_carry", [False, True])
def test_interp_add_plan_choices(sms, dtype, B, F, step_carry):
    """interp_add's plan, a pure function: the K-sweeps' tile (over the f32
    carry rows for the per-step form), and rows a loop step that make 64
    values a thread; the plan it takes at both stage-2 shapes."""
    block, warps, unroll = interp_add_plan(B, F, dtype, step_carry, sms)
    assert (block, warps) == common.sweep_tile(B, F, torch.float32 if step_carry else dtype, sms)
    cols = block // (32 * warps)  # a thread's columns, 16 bytes or more of a row
    assert cols * unroll == INTERP_ADD_VALUES and unroll >= 1 and unroll & (unroll - 1) == 0
    if dtype == torch.float32 and sms == 132 and (B, F) in ((16, 224 * 224 * 3), (16, 3072)):
        assert (block, warps, unroll) == {224 * 224 * 3: (2048, 4, 4), 3072: (128, 1, 16)}[F]


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,F", [(16, 16, 224 * 224 * 3), (16, 64, 3072), (1, 1, 3), (5, 19, 4099),
                                   (3, 13, 100_003), (4, 7, 2049), (2, 13, 4 * 5120 + 1),
                                   (64, 64, 3072), (1, 7, 1 << 22)])
def test_dots_plan_choices(sms, dtype, B, K, F):
    """idgi_dots' plan, a pure function of (B, K, F, dtype, SMs): its step
    blocks cover every step of K exactly once, its F chunks (whole tiles,
    none empty) cover [0, F) exactly once, each thread loads whole 16-byte
    vectors of a row, and F is split only where a chunk keeps
    ``DOTS_MIN_CHUNK_TILES`` tiles, so not at the CNN's stage-2 shape."""
    kb, split, chunk, block, warps = common.dots_plan(B, K, F, dtype, sms)
    assert kb == common.DOTS_KB
    steps = [j * kb + i for j in range(-(-K // kb)) for i in range(kb) if j * kb + i < K]
    assert steps == list(range(K))
    assert block * dtype.itemsize == common.DOTS_ROW_BYTES and chunk % block == 0
    assert block * dtype.itemsize % (16 * 32 * warps) == 0  # whole 16-byte loads a thread a row
    # chunk c takes [c·chunk, min((c + 1)·chunk, F)): back to back, the last one not empty
    assert (split - 1) * chunk < F <= split * chunk
    if split > 1:
        assert chunk // block >= common.DOTS_MIN_CHUNK_TILES
        assert B * -(-K // kb) * (split - 1) < common.DOTS_PROGRAMS_PER_SM * sms  # no more than it needs
    if (B, K, F) == (16, 64, 3072):
        assert split == 1
