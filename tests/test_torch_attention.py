"""The port's flash attention op against ``repro``'s, on the CPU.

The JAX op runs its Pallas kernels in interpret mode, as
``tests/test_attention.py`` runs them; the port's op takes its plain
versions (``kernels/flash_attention/ref.py``) on CPU tensors. Inputs come
from numpy with a fixed seed. Shapes are ``tests/test_attention.py``'s:
odd sequence lengths, GQA and plain multi-head, causal or not, ragged or
not. Tolerances: 1e-4 in f32 and 3e-2 in bf16, absolute and relative (the
JAX tests' own: sums in another order, one bf16 rounding per output).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as jref
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import ref as tref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention as tattn

torch.set_num_threads(1)

SHAPES = [(1, 17, 4, 2, 8), (2, 33, 6, 6, 4)]  # (B, S, NQ, NKV, D)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(B, S, NQ, NKV, D, ragged, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, S, NQ, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, NKV, D)).astype(np.float32) for _ in range(2))
    # every row a different non-power-of-two prefix, as the JAX tests draw them
    lens = np.array([max(1, (S * (b + 1)) // (B + 1)) for b in range(B)], np.int32)
    return q, k, v, do, (lens if ragged else None)


@functools.cache
def _jax(B, S, NQ, NKV, D, causal, ragged, dtype):
    """(o, dq, dk, dv) of the interpreted Pallas op, as f32 numpy."""
    q, k, v, do, lens = _inputs(B, S, NQ, NKV, D, ragged)
    jl = None if lens is None else jnp.asarray(lens)
    cast = lambda a: jnp.asarray(a).astype(dtype)
    fn = lambda q, k, v: j_flash(q, k, v, causal=causal, lengths=jl, block_q=8, block_k=8)
    o, vjp = jax.vjp(fn, cast(q), cast(k), cast(v))
    grads = vjp(cast(do))
    return tuple(np.asarray(a, np.float32) for a in (o, *grads))


def _port(B, S, NQ, NKV, D, causal, ragged, dtype):
    q, k, v, do, lens = _inputs(B, S, NQ, NKV, D, ragged)
    tdt = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    o = flash_attention(qt, kt, vt, causal=causal,
                        lengths=None if lens is None else torch.from_numpy(lens))
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do).to(tdt))
    return tuple(a.detach().float().numpy() for a in (o, *grads))


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,NQ,NKV,D", SHAPES)
def test_flash_op_matches_jax(B, S, NQ, NKV, D, causal, ragged):
    want = _jax(B, S, NQ, NKV, D, causal, ragged, "float32")
    got = _port(B, S, NQ, NKV, D, causal, ragged, "float32")
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=TOL["float32"], atol=TOL["float32"], err_msg=name)


def test_flash_op_matches_jax_bf16():
    """One GQA causal ragged case in bf16, as the JAX tests' dtype case."""
    args = (2, 33, 4, 2, 8, True, True, "bfloat16")
    for name, g, w in zip(("o", "dq", "dk", "dv"), _port(*args), _jax(*args)):
        np.testing.assert_allclose(g, w, rtol=TOL["bfloat16"], atol=TOL["bfloat16"], err_msg=name)


EDGE_LENS = (63, 64, 65, 129)  # on and beside the CUDA bf16 kernels' tile edges (32 keys, 64 rows)


def test_flash_op_matches_jax_bf16_at_64_key_edges():
    """bf16 at the LMs' head dim 128, 4 query heads on 1, S=192, causal,
    ragged lengths across the CUDA bf16 kernels' tile edges at 64 keys: the
    port's plain flash op, which the card holds those kernels against,
    matches ``repro``'s interpreted Pallas op (64-row blocks), forward and
    VJP, at the bf16 tolerance 3e-2."""
    B, S, NQ, NKV, D = len(EDGE_LENS), 192, 4, 1, 128
    rng = np.random.default_rng(5)
    q, do = (rng.standard_normal((B, S, NQ, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, NKV, D)).astype(np.float32) for _ in range(2))
    lens = np.array(EDGE_LENS, np.int32)
    cast = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    fn = lambda q, k, v: j_flash(q, k, v, causal=True, lengths=jnp.asarray(lens), block_q=64, block_k=64)
    o, vjp = jax.vjp(fn, cast(q), cast(k), cast(v))
    want = [np.asarray(a, np.float32) for a in (o, *vjp(cast(do)))]
    qt, kt, vt = (torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v))
    ot = flash_attention(qt, kt, vt, causal=True, lengths=torch.from_numpy(lens))
    got = [a.detach().float().numpy()
           for a in (ot, *torch.autograd.grad(ot, (qt, kt, vt), torch.from_numpy(do).bfloat16()))]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=TOL["bfloat16"], atol=TOL["bfloat16"], err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,NQ,NKV,D", SHAPES + [(2, 9, 4, 1, 16)])
def test_oracles_match_jax(B, S, NQ, NKV, D, causal):
    """``attention_ref``/``attention_vjp_ref`` against JAX's, with a length-0
    row (zeroed, not uniform); the kernels' own plain versions against them."""
    q, k, v, do, lens = _inputs(B, S, NQ, NKV, D, True, seed=1)
    lens[0] = 0
    t = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3))  # model -> kernel layout
    jargs = [jnp.asarray(t(a)) for a in (q, k, v, do)]
    targs = [torch.from_numpy(t(a)) for a in (q, k, v, do)]
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)
    want_o = np.asarray(jref.attention_ref(*jargs[:3], causal=causal, lengths=jl))
    want_g = jref.attention_vjp_ref(*jargs, causal=causal, lengths=jl)
    got_o = tref.attention_ref(*targs[:3], causal=causal, lengths=tl)
    got_g = tref.attention_vjp_ref(*targs, causal=causal, lengths=tl)
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=1e-5, atol=1e-5)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)

    o, lse = tref.flash_fwd_ref(*targs[:3], tl, causal=causal)
    torch.testing.assert_close(o, got_o, rtol=1e-5, atol=1e-5)
    assert float(lse[0].max()) <= tref.NEG_INF  # the length-0 row
    delta = (targs[3] * o).sum(-1)
    dq = tref.flash_bwd_dq_ref(*targs, lse, delta, tl, causal=causal)
    dk, dv = tref.flash_bwd_dkv_ref(*targs, lse, delta, tl, causal=causal)
    for g, w in zip((dq, dk, dv), got_g):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_matches_jax(causal, ragged):
    """The materializing model path (``attn_impl="auto"``), GQA expanded."""
    q, k, v, _, lens = _inputs(2, 33, 6, 2, 8, ragged, seed=2)
    jl = None if lens is None else jnp.asarray(lens)
    tl = None if lens is None else torch.from_numpy(lens)
    want = jattn.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                kv_len=jl)
    got = tattn.full_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                               kv_len=tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(tattn.expand_kv(torch.from_numpy(k), 6),
                       torch.from_numpy(np.array(jattn.expand_kv(jnp.asarray(k), 6))))


# ---------------------------------------- the CUDA kernels' 3xTF32 scheme


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it (to nearest,
    ties away from zero): an integer add of half a TF32 ulp (0x1000) to the
    magnitude bits, then the 13 low mantissa bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the kernels' tensor-core products take it:
    a = big + small, b likewise, each part TF32, and small·big + big·small +
    big·big summed in f32 (every product of two TF32 values is exact in f32)."""
    ab, bb = _tf32(a), _tf32(b)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    return torch.einsum(eq, asm, bb) + torch.einsum(eq, ab, bsm) + torch.einsum(eq, ab, bb)


def _mm_tf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product, f32 accumulation (what TF32 alone would give)."""
    return torch.einsum(eq, _tf32(a), _tf32(b))


def _bwd_with(mm, q, k, v, do, lse, delta, kvlen, causal):
    """``flash_bwd_dq_ref`` and ``flash_bwd_dkv_ref`` with their five products
    taken by ``mm``: (dq, dk, dv) f32."""
    B, NQ, Sq, D = q.shape
    NKV = k.shape[1]
    G, scale = NQ // NKV, D**-0.5
    qg, dog, kf, vf = tref._grouped(q, NKV), tref._grouped(do, NKV), k.float(), v.float()
    s = mm("bhgqd,bhkd->bhgqk", qg, kf) * scale
    keep = tref._keep(Sq, k.shape[2], causal=causal, lengths=kvlen, device=q.device)
    p = torch.where(keep, torch.exp(s - lse.reshape(B, NKV, G, Sq, 1)), 0.0)
    dp = mm("bhgqd,bhkd->bhgqk", dog, vf)
    ds = p * (dp - delta.reshape(B, NKV, G, Sq, 1))
    dq = mm("bhgqk,bhkd->bhgqd", ds, kf).reshape(q.shape) * scale
    return dq, mm("bhgqk,bhgqd->bhkd", ds, qg) * scale, mm("bhgqk,bhgqd->bhkd", p, dog)


def _vit_head_inputs(causal: bool, seed: int = 3):
    """The ViT's head shape (S=196, D=64, 3 heads) in the kernels' layout,
    standard normal as ``chip_smoke.py`` draws them, one full and one ragged
    row; with the forward's lse and delta."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 3, 196, 64)).astype(np.float32))
                   for _ in range(4))
    kvlen = torch.tensor([196, 97], dtype=torch.int32)
    o, lse = tref.flash_fwd_ref(q, k, v, kvlen, causal=causal)
    return q, k, v, do, lse, (do * o).sum(-1), kvlen


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_backward_within_flash_tolerance(causal):
    """The CUDA backward's scheme, emulated on the CPU at the ViT's head
    shape, holds the f32 flash tolerance against the exact plain versions."""
    args = _vit_head_inputs(causal)
    dq = tref.flash_bwd_dq_ref(*args, causal=causal)
    dk, dv = tref.flash_bwd_dkv_ref(*args, causal=causal)
    tol = TOL["float32"]
    for name, got, want in zip(("dq", "dk", "dv"), _bwd_with(_mm_3xtf32, *args, causal), (dq, dk, dv)):
        torch.testing.assert_close(got, want, atol=tol, rtol=tol, msg=name)



@pytest.mark.parametrize("causal", [False, True])
def test_one_tf32_product_breaks_flash_tolerance(causal):
    """Why three products: TF32 alone misses the f32 tolerance by several
    times at the same inputs (so the card gates would catch a kernel that
    dropped the small terms)."""
    args = _vit_head_inputs(causal)
    dq = tref.flash_bwd_dq_ref(*args, causal=causal)
    got = _bwd_with(_mm_tf32, *args, causal)[0]
    tol = TOL["float32"]
    assert float(((got - dq).abs() / (tol * (1 + dq.abs()))).max()) > 2


FWD_BK = 16  # the CUDA f32 forward's key tile


def _fwd_with(mm, q, k, v, kvlen, causal):
    """``flash_fwd_ref`` as the CUDA forward takes it: scores in base 2 (Q
    scaled by scale·log2(e) in f32, ``exp2``, lse converted back), K/V swept
    in ``FWD_BK``-key tiles with the online rescale, each tile's P V taken
    alone and added to O in f32 (O corr + t), the two products taken by
    ``mm``: (o, lse) f32."""
    B, NQ, Sq, D = q.shape
    NKV, Sk = k.shape[1], k.shape[2]
    qg = tref._grouped(q, NKV) * np.float32(D**-0.5 * np.log2(np.e))
    keep = tref._keep(Sq, Sk, causal=causal, lengths=kvlen, device=q.device)
    m = torch.full(qg.shape[:-1], tref.NEG_INF)
    l, acc = torch.zeros(qg.shape[:-1]), torch.zeros(qg.shape)
    for k0 in range(0, Sk, FWD_BK):
        kt, vt = (x.float()[:, :, None, k0:k0 + FWD_BK] for x in (k, v))
        kp = keep[..., k0:k0 + FWD_BK]
        s = mm("bhgqd,bhgkd->bhgqk", qg, kt)
        mn = torch.maximum(m, torch.where(kp, s, tref.NEG_INF).amax(-1))
        corr = torch.exp2(m - mn)
        p = torch.where(kp, torch.exp2(s - mn[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + mm("bhgqk,bhgkd->bhgqd", p, vt)
        m = mn
    lc = l.clamp_min(1e-30)
    lse = torch.where(m == tref.NEG_INF, m, m * np.float32(np.log(2))) + torch.log(lc)
    return (acc / lc[..., None]).reshape(q.shape), lse.reshape(B, NQ, Sq)


def _gqa_1024_inputs(D: int, seed: int = 4):
    """A causal GQA ragged shape with a long key sweep (Sq = Sk = 1024, 8
    query heads on 2 kv heads), one full row and one ragged, standard normal."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((2, 8, 1024, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 1024, D)).astype(np.float32)) for _ in range(2))
    return q, k, v, torch.tensor([1024, 611], dtype=torch.int32)


@pytest.mark.parametrize("case", ["vit", "vit causal", "gqa 1024 D=16", "gqa 1024 D=128"])
def test_3xtf32_forward_within_flash_tolerance(case):
    """The CUDA forward's scheme, emulated on the CPU, holds the f32 flash
    tolerance against the exact plain version: at the ViT's head shape and
    over a 1024-key causal GQA sweep."""
    if case.startswith("vit"):
        causal = case == "vit causal"
        q, k, v, _, _, _, kvlen = _vit_head_inputs(causal)
    else:
        causal = True
        q, k, v, kvlen = _gqa_1024_inputs(int(case.split("D=")[1]))
    o, lse = tref.flash_fwd_ref(q, k, v, kvlen, causal=causal)
    got_o, got_lse = _fwd_with(_mm_3xtf32, q, k, v, kvlen, causal)
    tol = TOL["float32"]
    torch.testing.assert_close(got_o, o, atol=tol, rtol=tol, msg="o")
    torch.testing.assert_close(got_lse, lse, atol=tol, rtol=tol, msg="lse")


@pytest.mark.parametrize("causal", [False, True])
def test_one_tf32_product_breaks_forward_tolerance(causal):
    """The forward needs three products too: with TF32 alone O misses the
    f32 tolerance by several times at the ViT's head shape (rows that see
    few keys carry V's own rounding into O almost undamped)."""
    q, k, v, _, _, _, kvlen = _vit_head_inputs(causal)
    o, _ = tref.flash_fwd_ref(q, k, v, kvlen, causal=causal)
    got, _ = _fwd_with(_mm_tf32, q, k, v, kvlen, causal)
    tol = TOL["float32"]
    assert float(((got - o).abs() / (tol * (1 + o.abs()))).max()) > 2


def test_tf32_rounding_matches_cvt_rna():
    """Ties round away from zero, the 13 low bits are cleared, and the split
    leaves a remainder below half a TF32 ulp."""
    one = 0x3F800000
    sign = -(2**31)  # the sign bit, as an int32
    # 1, 1 + just under half an ulp, two ties (+ and −) and a tie above an odd ulp
    bits = torch.tensor([one, one + 0x0FFF, one + 0x1000, sign + one + 0x1000, one + 0x3000],
                        dtype=torch.int32)
    x = bits.view(torch.float32)
    want = torch.tensor([one, one, one + 0x2000, sign + one + 0x2000, one + 0x4000],
                        dtype=torch.int32)
    assert torch.equal(_tf32(x).view(torch.int32), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    big = _tf32(y)
    assert bool(((y - big).abs() <= big.abs() * 2.0**-11).all())
    assert bool(((y - big - _tf32(y - big)).abs() <= y.abs() * 2.0**-21).all())


# ------------------------------ the CUDA bf16 kernels' scheme (D ≤ 128)


def _hilo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` as the bf16 kernels feed P or dS to a bf16 product: hi =
    bf16(x) and lo = bf16(x − hi), both back in f32 (a product of two bf16
    values is exact in f32)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _one_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One bf16 operand (what the second product buys), as ``_hilo`` gives it."""
    return x.bfloat16().float(), torch.zeros_like(x)


def _bf16_scheme(split, q, k, v, do, kvlen, causal, bk=32):
    """The CUDA bf16 forward and dQ on bf16-valued inputs, emulated in f32:
    S = Q Kᵀ and dP = dO Vᵀ on the bf16 values, scale·log2(e) applied to S
    after the product, ``exp2``; the forward sweeps K/V in ``bk``-key tiles
    with the online rescale (O scaled by corr, then P V added); P and dS
    enter their products as ``split`` gives them. Returns (o, lse, dq) f32,
    dQ from the emulated forward's lse."""
    B, NQ, Sq, D = q.shape
    NKV, Sk = k.shape[1], k.shape[2]
    qg, dog, kf, vf = tref._grouped(q, NKV), tref._grouped(do, NKV), k.float(), v.float()
    sl2 = np.float32(D**-0.5) * np.float32(np.log2(np.e))
    keep = tref._keep(Sq, Sk, causal=causal, lengths=kvlen, device=q.device)
    m = torch.full(qg.shape[:-1], tref.NEG_INF)
    l, acc = torch.zeros(qg.shape[:-1]), torch.zeros(qg.shape)
    pv = lambda p, x: sum(torch.einsum("bhgqk,bhkd->bhgqd", part, x) for part in split(p)[::-1])
    for k0 in range(0, Sk, bk):
        kp = keep[..., k0:k0 + bk]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf[:, :, k0:k0 + bk])
        mt = torch.where(kp, s, tref.NEG_INF).amax(-1)
        mn = torch.maximum(m, torch.where(mt == tref.NEG_INF, mt, mt * sl2))
        corr = torch.exp2(m - mn)
        p = torch.where(kp, torch.exp2(s * sl2 - mn[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + pv(p, vf[:, :, k0:k0 + bk])
        m = mn
    lc = l.clamp_min(1e-30)
    lse = torch.where(m == tref.NEG_INF, m, m * np.float32(np.log(2))) + torch.log(lc)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf)
    p = torch.where(keep, torch.exp2(s * sl2 - (lse * np.float32(np.log2(np.e)))[..., None]), 0.0)
    o = acc / lc[..., None]
    delta = (dog * o).sum(-1)
    ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", dog, vf) - delta[..., None])
    dq = pv(ds, kf) * np.float32(D**-0.5)
    return o.reshape(q.shape), lse.reshape(B, NQ, Sq), dq.reshape(q.shape)


def _bf16_edge_inputs(causal: bool):
    """bf16-valued f32 tensors in the kernels' layout at the tile edges
    (4 query heads on 1, S=192, lengths 63, 64, 65, 129), and the exact f32
    forward and dQ on them (the plain versions in f32)."""
    rng = np.random.default_rng(6)
    B, S, D = len(EDGE_LENS), 192, 128
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16().float()
    q, k, v, do = bf(B, 4, S, D), bf(B, 1, S, D), bf(B, 1, S, D), bf(B, 4, S, D)
    kvlen = torch.tensor(EDGE_LENS, dtype=torch.int32)
    o, lse = tref.flash_fwd_ref(q, k, v, kvlen, causal=causal)
    dq = tref.flash_bwd_dq_ref(q, k, v, do, lse, (do * o).sum(-1), kvlen, causal=causal)
    return (q, k, v, do, kvlen), (o, lse, dq)


def _worst(got, want, tol) -> float:
    return max(float(((g - w).abs() / (tol * (1 + w.abs()))).max()) for g, w in zip(got, want))


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_scheme_keeps_f32_products(causal):
    """The CUDA bf16 forward and dQ's scheme, emulated on the CPU at the
    tile edges: with P and dS split into hi and lo bf16 parts, O, lse and
    dQ stay within 1e-4 of the exact f32 computation on the same bf16
    values (f32 rounding only, as ``repro``'s Pallas kernels take P V in
    f32), far inside the 3e-2 bf16 gate; one bf16 P and dS would miss 1e-4."""
    args, want = _bf16_edge_inputs(causal)
    assert _worst(_bf16_scheme(_hilo, *args, causal), want, 1e-4) <= 1
    assert _worst(_bf16_scheme(_one_bf16, *args, causal), want, 1e-4) > 1
