"""Forward-only perturbation attribution — occlusion, RISE, LIME.

``repro.core.perturb`` in PyTorch. The gradient class interpolates and
back-propagates; this class evaluates the model forward on a batch of
masked variants of the input and turns the f-values into per-position
scores, so it explains models that cannot be differentiated.

Mask contract:

  * A perturbation mask ``z`` is a (P, S) binary keep-mask over the S
    position axis: ``z=1`` keeps the input, ``z=0`` replaces the position
    with the baseline — ``x_p = z_p ⊙ x + (1 − z_p) ⊙ x′`` in embedding
    space, so LM tokens, ViT patches and image cells ride unchanged.
  * RISE and LIME masks are drawn on the CPU by a ``torch.Generator``
    seeded purely from (seed, S, row index) (``request_seed``) and then
    moved to the device: replay is bit-identical, a row's masks do not
    depend on the batch it rides in, and the card and the CPU draw the same
    masks. ``repro`` folds the same triple into a ``jax.random`` key; the
    two generators give different bits, so parity tests hand JAX's drawn
    masks to ``attribute_from_masks``.
  * Pad positions are pinned to the baseline before perturbation
    (``mask_to_baseline``) and the final scores are multiplied by the
    real-position mask, so padded positions score exactly zero.

Methods (registered in ``repro_torch.core.methods`` with
``forward_only=True``):

  occlusion — deterministic sliding windows: score_s = the mean drop
              f(x) − f(x_p) over the windows that occlude position s.
  rise      — random binary keep-masks (Petsiuk et al., 2018):
              score_s = E[f(x_p) | z_s = 1] − E[f(x_p)] over P
              Bernoulli(p_keep) masks.
  lime      — binary masks over contiguous position groups, an
              exponential-kernel weighted ridge regression of f(x_p) on the
              group indicators; a group's coefficient is spread to its
              positions. The solve is the hook ``solve_fn``, by default the
              kernel op ``kernels.lstsq.ops.wls_solve`` (the CUDA
              Gauss–Jordan kernel on the card).

The accumulators carry chunked sufficient statistics over a Python loop
(``repro`` uses ``lax.scan``): occlusion/RISE (B, S) numerators and
denominators, LIME the (B, G+1, G+1) normal equations, so any mask budget P
runs at the memory of one chunk. Everything runs under ``torch.no_grad()``:
the class never differentiates, and no activations are kept.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.core.paths import mask_to_baseline
from repro_torch.core.probes import ScalarFn, cat_tree, map_tree, repeat_tree
from repro_torch.kernels.lstsq.ops import wls_solve

_MASK64 = (1 << 64) - 1


class PerturbResult(NamedTuple):
    """Forward-only analogue of ``ig.IGResult``; attributions are per
    position (B, S) — the class scores positions, not features."""

    attributions: torch.Tensor  # (B, S) f32 per-position scores
    f_x: torch.Tensor  # (B,) model output at the (pinned) input
    f_baseline: torch.Tensor  # (B,) model output at the baseline
    delta: torch.Tensor  # (B,) |Σ_s score_s − (f_x − f_b)| — diagnostic only:
    # perturbation methods satisfy no completeness axiom


class PerturbMasks(NamedTuple):
    """One batch's drawn masks.

    ``z`` is the (…, P, S) position keep-mask batch. LIME also carries the
    (…, P, G) group indicators its regression runs on and the (S,)
    position→group map; both are ``None`` for occlusion/RISE."""

    z: torch.Tensor  # (..., P, S) position keep-masks
    groups: Optional[torch.Tensor] = None  # (..., P, G) lime group masks
    group_ids: Optional[torch.Tensor] = None  # (S,) int32 position -> group


# ------------------------------------------------------------- mask drawing


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


def request_seed(seed: int, s_bucket: int, index: int) -> int:
    """The per-row mask seed, pure in (seed, bucket width S, row index).

        >>> request_seed(0, 196, 3) == request_seed(0, 196, 3) != request_seed(0, 196, 4)
        True
    """
    h = _mix64(seed & _MASK64)
    h = _mix64((h + (s_bucket & _MASK64)) & _MASK64)
    return _mix64((h + (int(index) & _MASK64)) & _MASK64) >> 1  # manual_seed takes < 2**63


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def occlusion_masks(S: int, n_masks: int) -> torch.Tensor:
    """(P=n_masks, S) sliding-window occlusion masks (deterministic).

    Window width ⌈S/P⌉, stride = width (the windows tile S); when fewer
    windows than P tile S, windows repeat cyclically so P is exactly
    ``n_masks`` for every S. Duplicate windows enter the per-position
    average twice, numerator and denominator alike."""
    window = -(-S // n_masks)  # ceil
    n_win = -(-S // window)
    starts = (torch.arange(n_masks) % n_win) * window
    pos = torch.arange(S)
    occluded = (pos[None, :] >= starts[:, None]) & (pos[None, :] < starts[:, None] + window)
    return 1.0 - occluded.float()


def rise_masks(seed: int, n_masks: int, S: int, p_keep: float = 0.5) -> torch.Tensor:
    """(P, S) iid Bernoulli(p_keep) keep-masks from the row seed (CPU)."""
    return (torch.rand((n_masks, S), generator=_generator(seed)) < p_keep).float()


def default_n_groups(S: int) -> int:
    """LIME group count for a bucket width — pure in S."""
    return min(S, 16)


def lime_group_ids(S: int, n_groups: int) -> torch.Tensor:
    """(S,) int32 position→group map: contiguous, near-equal groups — the
    sequence/patch-grid analogue of superpixels."""
    return torch.clamp(torch.arange(S) * n_groups // S, max=n_groups - 1).to(torch.int32)


def lime_masks(seed: int, n_masks: int, n_groups: int) -> torch.Tensor:
    """(P, G) iid Bernoulli(0.5) group keep-masks (the LIME design rows)."""
    return (torch.rand((n_masks, n_groups), generator=_generator(seed)) < 0.5).float()


def draw_masks(
    method: str,
    seeds: Sequence[int],
    S: int,
    n_masks: int,
    *,
    p_keep: float = 0.5,
    n_groups: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> PerturbMasks:
    """Per-row mask batches for a batch of rows, on ``device``.

    ``seeds``: the (B,) row seeds from ``request_seed`` (ignored by the
    deterministic occlusion generator, which broadcasts one mask set).
    Returns ``PerturbMasks`` with a leading batch axis: z (B, P, S), and for
    lime also groups (B, P, G) and the shared group_ids (S,).
    """
    B = len(seeds)
    if method == "occlusion":
        z = occlusion_masks(S, n_masks).expand(B, n_masks, S)
        return PerturbMasks(z.to(device))
    if method == "rise":
        z = torch.empty((B, n_masks, S))
        for i, s in enumerate(seeds):
            z[i] = rise_masks(s, n_masks, S, p_keep)
        return PerturbMasks(z.to(device))
    if method == "lime":
        G = n_groups if n_groups else default_n_groups(S)
        gids = lime_group_ids(S, G)
        zg = torch.empty((B, n_masks, G))
        for i, s in enumerate(seeds):
            zg[i] = lime_masks(s, n_masks, G)
        return PerturbMasks(zg[..., gids.long()].to(device), zg.to(device), gids.to(device))
    raise ValueError(f"unknown perturbation method {method!r}")


# ----------------------------------------------- forward-value accumulators
#
# The forward-only MethodSpec contract: the accumulator consumes f(perturbed)
# values, not gradients —
#   update(stats, vals (B, c) f32, z (B, c, S | G), *, ctx) -> stats
#   finalize(stats, *, ctx) -> (B, S) f32 scores
# ``stats`` is a dict of f32 sufficient statistics; ``ctx`` the per-call
# context built by ``attribute_from_masks`` (endpoints, P, the lime solve
# hook). ``init`` builds the starting statistics.


def _zeros(*shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def occlusion_init(B: int, S: int, G: int, device="cuda") -> dict:
    return {"num": _zeros(B, S, device=device), "den": _zeros(B, S, device=device)}


def occlusion_update(stats: dict, vals: torch.Tensor, z: torch.Tensor, *, ctx: dict) -> dict:
    """Accumulate the f-drop of every window onto the positions it occludes."""
    drop = ctx["f_x"][:, None] - vals  # (B, c)
    occ = 1.0 - z  # (B, c, S) occluded indicator
    return {
        "num": stats["num"] + torch.einsum("bc,bcs->bs", drop, occ),
        "den": stats["den"] + occ.sum(1),
    }


def occlusion_finalize(stats: dict, *, ctx: dict) -> torch.Tensor:
    den = stats["den"]
    pos = den > 0.0
    return torch.where(pos, stats["num"] / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(den))


def rise_init(B: int, S: int, G: int, device="cuda") -> dict:
    return {
        "sz": _zeros(B, S, device=device),  # Σ_p f_p · z_ps
        "nz": _zeros(B, S, device=device),  # Σ_p z_ps
        "sv": _zeros(B, device=device),  # Σ_p f_p
    }


def rise_update(stats: dict, vals: torch.Tensor, z: torch.Tensor, *, ctx: dict) -> dict:
    return {
        "sz": stats["sz"] + torch.einsum("bc,bcs->bs", vals, z),
        "nz": stats["nz"] + z.sum(1),
        "sv": stats["sv"] + vals.sum(1),
    }


def rise_finalize(stats: dict, *, ctx: dict) -> torch.Tensor:
    """score_s = E[f | z_s = 1] − E[f]; positions never kept score 0."""
    nz = stats["nz"]
    pos = nz > 0.0
    cond = stats["sz"] / torch.where(pos, nz, torch.ones_like(nz))
    mean = stats["sv"][:, None] / float(ctx["n_masks"])
    return torch.where(pos, cond - mean, torch.zeros_like(nz))


def lime_weights(zg: torch.Tensor, kernel_width: float) -> torch.Tensor:
    """Exponential proximity kernel π_p = exp(−(1 − cover_p)² / width²) on
    the group-coverage fraction (full-coverage masks weigh most)."""
    cover = zg.mean(-1)
    width_sq = float(torch.tensor(kernel_width, dtype=torch.float32) ** 2)  # squared in f32
    return torch.exp(-((1.0 - cover) ** 2) / width_sq)


def lime_init(B: int, S: int, G: int, device="cuda") -> dict:
    return {
        "A": _zeros(B, G + 1, G + 1, device=device),  # XᵀWX (+ intercept)
        "b": _zeros(B, G + 1, device=device),  # XᵀWy
    }


def lime_update(stats: dict, vals: torch.Tensor, zg: torch.Tensor, *, ctx: dict) -> dict:
    """Accumulate the weighted normal equations of f ~ [groups, 1]."""
    B, c, _ = zg.shape
    xg = torch.cat([zg, zg.new_ones((B, c, 1))], dim=-1)
    w = lime_weights(zg, ctx["kernel_width"])  # (B, c)
    return {
        "A": stats["A"] + torch.einsum("bci,bc,bcj->bij", xg, w, xg),
        "b": stats["b"] + torch.einsum("bci,bc,bc->bi", xg, w, vals),
    }


def lime_finalize(stats: dict, *, ctx: dict) -> torch.Tensor:
    """Ridge-solve the accumulated normal equations and spread each group's
    coefficient to its positions. ``group_valid`` rows (groups with no real
    position in a padded input) are pinned to identity by the solver, so
    their β — and so every pad position's score — is exactly zero."""
    gv = ctx["group_valid"]
    if gv is not None:  # the intercept column is always live
        gv = torch.cat([gv, gv.new_ones((gv.shape[0], 1))], dim=-1)
    beta = ctx["solve_fn"](stats["A"], stats["b"], mask=gv, ridge=ctx["ridge"])
    return beta[:, :-1].index_select(1, ctx["group_ids"].long())  # (B, S)


_FWD = {
    "occlusion": (occlusion_init, occlusion_update, occlusion_finalize),
    "rise": (rise_init, rise_update, rise_finalize),
    "lime": (lime_init, lime_update, lime_finalize),
}


# ---------------------------------------------------------------- attribute


@torch.no_grad()
def attribute_from_masks(
    f: ScalarFn,
    x: torch.Tensor,
    baseline: torch.Tensor,
    target: Any,
    pm: PerturbMasks,
    *,
    method: Union[str, Any] = "occlusion",
    mask: Optional[torch.Tensor] = None,
    group_valid: Optional[torch.Tensor] = None,
    chunk: int = 0,
    ridge: float = 1e-2,
    kernel_width: float = 0.25,
    solve_fn: Optional[Callable] = None,
    f_x: Optional[torch.Tensor] = None,
) -> PerturbResult:
    """Forward-only attribution over pre-drawn masks.

    f: (xs (N, S, *E), targets) -> (N,);  x/baseline: (B, S, *E).
    pm: batched ``PerturbMasks`` (z (B, P, S); lime adds groups/group_ids).
    mask: optional (B, S) real-position mask — pad positions are pinned to
    the baseline before perturbation and scored exactly zero.
    group_valid: optional (B, G) — lime groups with at least one real
    position; invalid groups are pinned out of the solve (β = 0 exactly).
    chunk: masks per model call (0 = all P at once); must divide P. The
    perturbed batch (B, chunk, S, *E) is built one chunk at a time.
    solve_fn: the lime WLS hook ``(A, rhs, *, mask, ridge) -> beta``;
    default ``kernels.lstsq.ops.wls_solve`` (the CUDA kernel for CUDA
    tensors, its plain sweep for CPU tensors).
    f_x: optional known (B,) endpoint f(x) (probe reuse): only f(baseline)
    is then computed alongside the mask batch.
    """
    from repro_torch.core import methods as methods_mod

    spec = methods_mod.get(method)
    if not spec.forward_only:
        raise ValueError(
            f"method {spec.name!r} is gradient-based; use repro_torch.core.ig.attribute"
        )
    init, update, finalize = _FWD[spec.accum]

    B, S = x.shape[:2]
    feat = tuple(x.shape[2:])
    P = pm.z.shape[1]
    G = pm.groups.shape[-1] if pm.groups is not None else 0
    xp = mask_to_baseline(x, baseline, mask)

    if f_x is not None:
        f_x = f_x.float()
        f_b = f(baseline, target).float()
    else:
        fv = f(torch.cat([xp, baseline], dim=0), cat_tree(target, target)).float()
        f_x, f_b = fv[:B], fv[B:]

    ctx = {
        "f_x": f_x,
        "n_masks": P,
        "kernel_width": kernel_width,
        "ridge": ridge,
        "group_ids": pm.group_ids,
        "group_valid": group_valid,
        "solve_fn": solve_fn if solve_fn is not None else wls_solve,
    }

    c = chunk if chunk and chunk < P else P
    if P % c:
        raise ValueError(f"chunk {c} must divide n_masks {P}")
    # the accumulator's design rows: group indicators for lime, the position
    # masks themselves otherwise
    acc_rows = pm.groups if pm.groups is not None else pm.z
    stats = init(B, S, G, x.device)
    t = repeat_tree(target, c)
    for s in range(0, P, c):
        z, rows = pm.z[:, s : s + c], acc_rows[:, s : s + c]  # (B, c, S), (B, c, S|G)
        ze = z.reshape(tuple(z.shape) + (1,) * len(feat))
        xi = ze * xp[:, None] + (1.0 - ze) * baseline[:, None]  # (B, c, S, *E)
        vals = f(xi.reshape((B * c, S) + feat), t).reshape(B, c).float()
        stats = update(stats, vals, rows, ctx=ctx)
    scores = finalize(stats, ctx=ctx)  # (B, S)
    if mask is not None:
        scores = scores * mask.float()
    delta = (scores.sum(-1) - (f_x - f_b)).abs()
    return PerturbResult(scores, f_x, f_b, delta)


# ------------------------------------------------------------- convenience


@dataclass(frozen=True)
class PerturbExplainer:
    """Self-contained forward-only explainer over (B, S, *E) inputs.

    Draws row i's masks from ``request_seed(seed, S, i)``, so a row's masks
    are pure in (seed, S, i). Inputs are moved to ``device`` (the CUDA card
    by default); the LIME solve defaults to the kernel op.
    """

    f: ScalarFn
    method: str = "occlusion"
    n_masks: int = 64
    seed: int = 0
    chunk: int = 0
    p_keep: float = 0.5
    n_groups: int = 0  # 0 = default_n_groups(S)
    ridge: float = 1e-2
    kernel_width: float = 0.25
    solve_fn: Optional[Callable] = None  # None: kernels.lstsq.ops.wls_solve
    device: Union[str, torch.device] = "cuda"

    def masks_for(self, B: int, S: int) -> PerturbMasks:
        """The masks of rows 0..B-1 at width S, on ``device``."""
        seeds = [request_seed(self.seed, S, i) for i in range(B)]
        return draw_masks(self.method, seeds, S, self.n_masks, p_keep=self.p_keep,
                          n_groups=self.n_groups, device=self.device)

    def attribute(
        self,
        x: torch.Tensor,
        baseline: torch.Tensor,
        target: Any,
        *,
        mask: Optional[torch.Tensor] = None,
    ) -> PerturbResult:
        x, baseline, target, mask = (map_tree(lambda a: torch.as_tensor(a, device=self.device), t)
                                     for t in (x, baseline, target, mask))
        B, S = x.shape[:2]
        pm = self.masks_for(B, S)
        group_valid = None
        if pm.group_ids is not None and mask is not None:
            group_valid = group_real_mask(mask, pm.group_ids, pm.groups.shape[-1])
        return attribute_from_masks(
            self.f, x, baseline, target, pm,
            method=self.method, mask=mask, group_valid=group_valid,
            chunk=self.chunk, ridge=self.ridge,
            kernel_width=self.kernel_width, solve_fn=self.solve_fn,
        )


def group_real_mask(mask: torch.Tensor, group_ids: torch.Tensor, n_groups: int) -> torch.Tensor:
    """(B, S) real-position mask → (B, G) "group has a real position"."""
    onehot = torch.nn.functional.one_hot(group_ids.long(), n_groups).float()  # (S, G)
    return (mask.float() @ onehot > 0.0).float()


# ----------------------------------------------------- image <-> cell views
#
# Perturbation scores positions; a dense image has none, so images are
# carved (B, H, W, C) into a grid of cell² patches — the move ViT's patchify
# makes — and cells are perturbed. Below: the exact, invertible reshape pair
# and the score broadcast back to pixels.


def image_to_cells(images: torch.Tensor, cell: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, (H/cell)·(W/cell), cell·cell·C) position view."""
    B, H, W, C = images.shape
    gh, gw = H // cell, W // cell
    assert gh * cell == H and gw * cell == W, (H, W, cell)
    x = images.reshape(B, gh, cell, gw, cell, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, cell * cell * C)


def cells_to_image(cells: torch.Tensor, image_shape: tuple, cell: int) -> torch.Tensor:
    """Inverse of ``image_to_cells``."""
    B = cells.shape[0]
    H, W, C = image_shape
    gh, gw = H // cell, W // cell
    x = cells.reshape(B, gh, gw, cell, cell, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def cell_fn(f: ScalarFn, image_shape: tuple, cell: int) -> ScalarFn:
    """Lift a pixel-space scalar fn to the (B, S, D) cell view."""

    def g(xc, target):
        return f(cells_to_image(xc, image_shape, cell), target)

    return g


def cell_scores_to_pixels(scores: torch.Tensor, image_shape: tuple, cell: int) -> torch.Tensor:
    """Broadcast (B, S) cell scores to (B, H, W, C) pixel attributions
    (every pixel of a cell shares its cell's score)."""
    B, S = scores.shape
    H, W, C = image_shape
    cells = scores[..., None].expand(B, S, cell * cell * C)
    return cells_to_image(cells, image_shape, cell)
