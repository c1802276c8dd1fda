"""The port's batched WLS solve (LIME) against ``repro.kernels.lstsq``, on the CPU.

Systems come from seeded numpy designs (``_system``): weighted normal
equations XᵀWX, XᵀWy in float32, handed to both packages. Tolerances:

- the plain Gauss–Jordan sweep against JAX's Pallas kernel (interpret mode)
  to 1e-5 of max|β|: the same unpivoted sweep in the same order, rounding
  apart only where XLA contracts a multiply and a subtraction;
- against the library solves (``torch.linalg.solve``, JAX's oracle,
  least squares) at the 1e-3 band of ``tests/test_kernels.py`` (10× for
  least squares): another algorithm, whose rounding the solve amplifies by
  the ridge-bounded condition number;
- ``prepare_normal_eqs`` exactly.

The kernel's plan chooser (``kernel.solve_plan``) is a pure function and is
tested here; the kernels themselves run in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lstsq import ref as jref
from repro.kernels.lstsq.ops import wls_solve as j_wls_solve
from repro_torch.kernels import common
from repro_torch.kernels.lstsq import ops, ref
from repro_torch.kernels.lstsq import kernel
from repro_torch.kernels.lstsq.kernel import wls_solve_cuda

torch.set_num_threads(1)

SHAPES = [(1, 9, 3), (2, 21, 7), (3, 40, 17), (2, 50, 22)]  # (B, P, N), test_kernels.py's
TOL = 1e-3


def _system(B, P, N, *, seed=0, dup_cols=0, dtype=np.float32):
    """Normal equations (B, N, N), (B, N) of a seeded weighted design;
    ``dup_cols`` duplicates trailing design columns (XᵀWX exactly singular:
    only the ridge makes it solvable)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, P, N))
    if dup_cols:
        X[..., -dup_cols:] = X[..., :dup_cols]
    w = rng.uniform(0.1, 1.0, (B, P))
    y = rng.standard_normal((B, P))
    Xw = X * w[..., None]
    return (np.einsum("bpi,bpj->bij", Xw, X).astype(dtype), np.einsum("bpi,bp->bi", Xw, y).astype(dtype))


def _ragged_mask(B, N, seed=1):
    """(B, N) valid-entry masks: row b keeps a different prefix, and one
    interior entry of the last row is invalid as well."""
    m = np.zeros((B, N), np.float32)
    for b in range(B):
        m[b, : max(1, N - 1 - 2 * b)] = 1.0
    m[-1, N // 3] = 0.0
    m[:, -1] = 1.0  # the intercept column stays live, as in LIME
    return m


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("B,P,N", SHAPES)
def test_gauss_jordan_matches_jax_kernel(B, P, N):
    """The kernel's plain version against the Pallas kernel itself: the same
    sweep, odd N included (the JAX op pads N to 8; the port does not)."""
    A, rhs = _system(B, P, N)
    want = np.asarray(j_wls_solve(jnp.asarray(A), jnp.asarray(rhs), ridge=0.1, interpret=True))
    Ap, bp = ref.prepare_normal_eqs(_t(A), _t(rhs), ridge=0.1)
    got = ref.gauss_jordan_ref(Ap, bp)
    assert got.dtype == torch.float32 and got.shape == (B, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the op on CPU tensors is that sweep over the prepared system
    assert torch.equal(ops.wls_solve(_t(A), _t(rhs), ridge=0.1), got)


@pytest.mark.parametrize("N", [31, 32, 33, 64, 65, 68, 69])
def test_gauss_jordan_matches_jax_kernel_at_variant_edges(N):
    """The plain sweep against the Pallas kernel around the sizes where the
    card's plan changes kernel (``kernel.solve_plan``: the warp variant up
    to N = 31, the register variant up to 68), LIME's design ratio of
    about four masks a column."""
    A, rhs = _system(2, 4 * N, N, seed=N)
    want = np.asarray(j_wls_solve(jnp.asarray(A), jnp.asarray(rhs), ridge=0.1, interpret=True))
    got = ref.gauss_jordan_ref(*ref.prepare_normal_eqs(_t(A), _t(rhs), ridge=0.1))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


H100_SMEM_OPTIN = 232_448  # bytes of shared memory a block can opt into on an H100


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [1, 2, 17, 31, 32, 33, 64, 65, 68, 69, 128, 129])
def test_solve_plan_choices(dtype, N):
    """Each N maps to exactly one variant, the first of ``VARIANTS`` that
    holds it; the register variants stay within their compile-time
    maxima (32 lanes; 17 × 17 threads of 4 × 4 elements), and each
    block's threads and shared memory are what its kernel is built for."""
    plan = kernel.solve_plan(N, dtype, H100_SMEM_OPTIN)
    holds = [v for v in kernel.VARIANTS if kernel.variant_plan(v, N, dtype) is not None]
    assert plan == kernel.variant_plan(holds[0], N, dtype)
    size = 4 if dtype == torch.float32 else 8
    if plan.variant == "warp":
        assert N + 1 <= 32 and plan.threads == 32 * plan.systems and plan.smem == 0
    elif plan.variant == "shared":
        assert N > 68 and (plan.threads, plan.systems) == (256, 1)
        assert plan.smem == size * (N * N + 3 * N + 1)
    else:
        side = -(-N // 4)  # threads down and across, each 4 rows × 4 columns
        assert side <= 17 and side * 4 >= N
        assert plan.threads == side * side and plan.systems == 1
        assert plan.smem == size * (4 * side * 4 + 2)  # two pivot rows (b_k last) and columns
    assert plan.variant == {1: "warp", 2: "warp", 17: "warp", 31: "warp", 32: "regs4", 33: "regs4",
                            64: "regs4", 65: "regs4", 68: "regs4", 69: "shared", 128: "shared",
                            129: "shared"}[N]
    # a system past a block's shared memory is refused: an H100's, or a card's given limit
    with pytest.raises(ValueError, match="shared memory"):
        kernel.solve_plan(400, dtype, H100_SMEM_OPTIN)
    big = N + 129  # the shared-memory variant
    need = size * (big * big + 3 * big + 1)
    assert kernel.solve_plan(big, dtype, smem_limit=need).smem == need
    with pytest.raises(ValueError, match="shared memory"):
        kernel.solve_plan(big, dtype, smem_limit=need - 1)


@pytest.mark.parametrize("B,P,N", SHAPES)
def test_gauss_jordan_matches_library_solves(B, P, N):
    A, rhs = _system(B, P, N, seed=2)
    got = ops.wls_solve(_t(A), _t(rhs), ridge=0.1).numpy().astype(np.float64)
    lib = ref.wls_solve_ref(_t(A), _t(rhs), ridge=0.1).numpy()
    jlib = np.asarray(jref.wls_solve_ref(jnp.asarray(A), jnp.asarray(rhs), ridge=0.1))
    np.testing.assert_allclose(got, lib, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, jlib, rtol=TOL, atol=TOL)
    Ap, bp = ref.prepare_normal_eqs(_t(A), _t(rhs), ridge=0.1)
    direct = torch.linalg.lstsq(Ap, bp[..., None]).solution[..., 0].numpy()
    np.testing.assert_allclose(got, direct, rtol=10 * TOL, atol=10 * TOL)


@pytest.mark.parametrize("B,P,N", [(2, 21, 7), (3, 40, 17)])
def test_ragged_mask_pins_exact_zeros(B, P, N):
    """Masked entries are pinned: β exactly zero there, and the valid block
    solves what the Pallas kernel and the oracles solve."""
    A, rhs = _system(B, P, N, seed=3)
    mask = _ragged_mask(B, N)
    got = ops.wls_solve(_t(A), _t(rhs), mask=_t(mask), ridge=0.1).numpy()
    assert np.all(got[mask == 0.0] == 0.0) and np.all(got[mask == 1.0] != 0.0)
    jk = np.asarray(j_wls_solve(jnp.asarray(A), jnp.asarray(rhs), mask=jnp.asarray(mask), ridge=0.1,
                                interpret=True))
    np.testing.assert_allclose(got, jk, rtol=0, atol=1e-5 * np.abs(jk).max())
    lib = ref.wls_solve_ref(_t(A), _t(rhs), mask=_t(mask), ridge=0.1).numpy()
    np.testing.assert_allclose(got, lib, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rank_deficient_regularized(dtype, B=2, P=24, N=8):
    """Duplicated design columns make XᵀWX exactly singular; the ridge makes
    it solvable, and the unpivoted sweep agrees with the oracle and satisfies
    the regularized equations."""
    A, rhs = _system(B, P, N, seed=7, dup_cols=2, dtype=dtype)
    tol = TOL if dtype == np.float32 else 1e-8
    got = ops.wls_solve(_t(A), _t(rhs), ridge=0.5)
    assert got.dtype == (torch.float32 if dtype == np.float32 else torch.float64)
    lib = ref.wls_solve_ref(_t(A), _t(rhs), ridge=0.5)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), rtol=tol, atol=tol)
    if dtype == np.float32:  # JAX runs in f32 only here (no x64)
        jlib = np.asarray(jref.wls_solve_ref(jnp.asarray(A), jnp.asarray(rhs), ridge=0.5))
        np.testing.assert_allclose(got.numpy(), jlib, rtol=tol, atol=tol)
    Ap, bp = ref.prepare_normal_eqs(_t(A), _t(rhs), ridge=0.5)
    resid = torch.einsum("bij,bj->bi", Ap, got) - bp
    assert float(resid.abs().max()) < 10 * tol * (float(bp.abs().max()) + 1.0)


@pytest.mark.parametrize("masked", [False, True])
def test_prepare_normal_eqs_is_exact(masked):
    A, rhs = _system(3, 30, 9, seed=4)
    mask = _ragged_mask(3, 9) if masked else None
    jA, jb = jref.prepare_normal_eqs(jnp.asarray(A), jnp.asarray(rhs),
                                     None if mask is None else jnp.asarray(mask), 0.37)
    tA, tb = ref.prepare_normal_eqs(_t(A), _t(rhs), None if mask is None else _t(mask), 0.37)
    np.testing.assert_array_equal(tA.numpy(), np.asarray(jA))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # bf16 in, f32 out (the class's accumulation dtype)
    bA, bb = ref.prepare_normal_eqs(_t(A).bfloat16(), _t(rhs).bfloat16(), ridge=0.1)
    assert bA.dtype == bb.dtype == torch.float32


def test_normal_eqs_match_jax():
    rng = np.random.default_rng(5)
    X = rng.integers(0, 2, (2, 16, 5)).astype(np.float32)
    w = rng.uniform(0.1, 1, (2, 16)).astype(np.float32)
    y = rng.standard_normal((2, 16)).astype(np.float32)
    jA, jb = jref.normal_eqs(jnp.asarray(X), jnp.asarray(w), jnp.asarray(y))
    tA, tb = ref.normal_eqs(_t(X), _t(w), _t(y))
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)


def test_cpu_dispatch_and_kernel_refuses_cpu_tensors():
    """CPU tensors take the plain sweep and count no launch; the CUDA
    launcher refuses them (it never runs the plain version itself)."""
    A, rhs = _system(2, 21, 7)
    common.reset_launches()
    ops.wls_solve(_t(A), _t(rhs), ridge=0.1)
    assert common.LAUNCHES["wls_solve"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        wls_solve_cuda(_t(A), _t(rhs))
    with pytest.raises(ValueError, match="float"):
        wls_solve_cuda(_t(A).half(), _t(rhs).half())
    with pytest.raises(ValueError, match="B, N, N"):
        wls_solve_cuda(_t(A)[:, :, :3], _t(rhs))
