"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Needs a CUDA card, the ``triton`` package and ``nvcc``; exits non-zero at
once when ``torch.cuda.is_available()`` is false. Imports nothing of JAX or
``repro``. Phases, each raising on a failed gate:

  1. device — the ``nvidia-smi`` name and power-limit line;
  2. Triton kernels — builds the six Triton kernels (the compile cache
     goes to ``build/triton``) while two threads build the CUDA flash and
     solve libraries (``build/cuda``), and holds each Triton kernel against its plain
     PyTorch version on the card: at the CNN path's shape (B=16, K=64,
     F=3072, f32) and the ViT path's (B=16, K=16, F=150,528), at a ragged
     masked shape through the op wrappers, in bf16, and (IDGI's two) on
     zero-gradient rows, and the three K-sweeps (``accum_cot``,
     ``ig_accum``, ``ig_accum_sq``), ``idgi_dots``, ``interpolate`` and
     ``interp_add`` (both carry ranks) twice on one input for the same bits
     at both stage-2 shapes, printing the tile and the dots plan they
     chose; times the kernel, its plain version and one PyTorch library
     call of the same function, each with a cold L2, beside the bound the
     card's bandwidth sets (``interp_add`` with each carry rank: the (B, F)
     carry broadcast over the steps and IDGI's (B, K, F) per-step carry),
     and one launch on a single 128-column row (the floor of that timing);
  3. CUDA kernels — the three flash kernels (forward, dQ, dK/dV) against
     their plain versions and the op's autograd against the analytic
     oracle, at the ViT's attention shape (256 images, 6 heads, S=196,
     D=64, f32), at a causal GQA ragged shape (f32 and bf16) and over a
     long causal GQA key sweep (Sq = Sk = 1024, 8 query heads on 2, one row
     ragged, f32, at D=128 and the reduced LM's D=16; each kernel's worst
     err/allowed ratio there is recorded); timed at
     the ViT's shape beside the plain version, SDPA pinned to its
     memory-efficient backend (named in the output) and the bound at f32
     accuracy on the tensor cores (3xTF32: three TF32 products per f32
     product, or the bytes, whichever is larger), with the backward pair's
     summed time against one SDPA backward. The Gauss–Jordan solve kernels
     bit-equal to their plain version at the LIME slice's shape (16 systems
     of 17×17), at a ragged masked shape and at N=65, each with the variant
     it took, timed beside its bound and ``torch.linalg.solve_ex``;
  4. the CNN slice — the paper CNN at ``CnnConfig()`` width with seeded
     random weights answers 4 batches of 16 seeded images through
     ``Explainer(method="ig", schedule="paper", m=64, n_int=4)``: fixed-m
     unfused, fixed-m fused and ``attribute_adaptive``;
  5. the CNN zoo — one batch of 16 on the same CNN through every method
     (ig, idgi, noise_tunnel, expected_grad) on ``paper``, ig on every
     other schedule family (uniform, warp, gauss, refine), IDGI fused, and
     the two path ensembles adaptive; each ensemble's result must be the
     mean of its sample rows run as plain ig; and one LIME batch over
     4×4×3 image cells (S=64) through the solve kernel;
  6. the ViT slice — the same explainer with ``chunk=16`` on the full-width
     ViT-S/16 (``attn_impl="flash"``, seeded random weights), 3 batches of
     16 seeded 224×224 images: fixed-m unfused and fused, one adaptive run
     (``m_max=256``), peak memory and one profiled explanation of each;
  7. the ViT IDGI slice — phase 6 with ``method="idgi"``, through IDGI's
     two kernels, and Σ_j φ_idgi = Σ_j φ_ig on each batch's schedule;
  8. the forward-only ViT slice — ``PerturbExplainer`` with ``lime``,
     ``occlusion`` and ``rise`` (``n_masks=64``, ``chunk=16``: 256 images a
     forward) on the same ViT over its 196 patch features, f the target
     logit, 3 batches of 16: finite scores, LIME through the flash forward
     and the solve kernel only, occlusion and RISE through the flash
     forward only, a replayed call bit-identical, the card against the port
     on CPU copies of two images at P=16 on the same masks; wall time per
     batch, peak memory and one profiled explanation per method;
  9. the LM engine — ``ExplainEngine`` on llama3-8b at full width cut to
     4 layers (``attn="flash"``, bf16 compute, weights drawn on the card
     from a seeded CUDA generator) over 20 seeded requests (16 of 17–128
     tokens, 4 of 300–512: buckets of S 32, 64, 128 and 512), m=64,
     n_int=4, chunk 16: ig unfused, ig fused, IDGI fused, the adaptive
     ladder (tol 1e-2, m_max 256) and occlusion, RISE and LIME at 64
     masks, each served twice (the replay adds no miss and gives the same
     bits); fused against unfused and a mixed-length bucket against its
     requests served one by one within rtol = atol = 2e-2 (bf16), the
     card against the port on the CPU (2 prompts of ≤ 16 tokens, m=8, f32);
     the stage-2 plans at the LM's F, walls per path and bucket, misses and
     hits, mean δ and m_used, peak memory and one profiled warm round;
 9b. the caches (``cache_phase``, right after phase 9) — phase 9's model
     from seed 0 and its 20 requests, m=64: A. ``model_fingerprint`` timed,
     the bytes it hashed printed; B. an unfused ``ig`` engine, chunk 16,
     ``result_cache`` of 256 MiB, serves the 20 (all misses), then the 20
     in another order and 4 new ones: every hit equal to round 1's result
     bit for bit, result hits/misses 20/24, the 4 new equal to an engine
     without a cache, a caller's change to a hit never reaching the entry,
     an all-hit round timed and launching nothing; C. ``autotune_engine`` on
     it (files under ``build/cache_phase/``): each bucket's candidates
     priced by ``roofline.hotpath_cost`` (bytes, FLOPs, bound, predicted
     peak), those above the card's memory pruned before any launch, the
     best three by bound timed with their measured peak; then an
     ``autotune=True`` engine: each bucket at its winner's chunk and equal
     bit for bit to an engine with that chunk engine-wide, a second round
     without a miss; D. an adaptive ``ig`` engine (tol 1e-2, m_max 256,
     ``hop_zero_min=4``) serves rounds until its hop-zero starting rungs
     settle (each round feeds the δ-history), ``save_warm_state``, its first
     and last rounds' results to ``build/cache_phase/``; then, the card
     freed, two fresh processes (``chip_smoke.py --warm-child cold|restore
     DIR``) build the same model and serve the round once: the restored one
     must report ``via="replay"``, this process's fingerprint, no miss and
     this process's last round bit for bit, the cold one must miss and give
     this process's first round bit for bit; each prints its fingerprint
     and replay ms, round-0 wall and peak. Any failure, in a child too,
     fails the run;
 10. generation serving — ``ServeEngine`` on llama3-8b at full width and 32
     layers (bf16, flash prefill, weights drawn on the card): 16 prompts of
     128 tokens with 64 new, greedy, then sampled at T=0.8 with seeds 1234,
     1234 and 1235; 2 prompts of 999 tokens with 32 new (flash's ragged
     last tile); an 8-step ``make_decode_chunk`` at B=16, profiled. Prefill
     ms, decode ms a token, tokens/s, peak memory. Gates: the same seed
     gives the same tokens and another seed others, every id in [0, V);
     the chunk at T=0 gives generate's greedy tokens; f32 at full depth,
     decode logits teacher-forced against a fresh forward within 1e-4 of
     the row's largest |logit| (the bf16 ratio at full depth is printed,
     not gated); bf16 at 4 layers within 2e-2; the card against the CPU
     (f32, 2 layers, 2 prompts of 16, 8 new) within 1e-4 and equal tokens
     (a row may part only at a near tie); one 8192-token prompt through
     the blocked branch (``attn_impl="auto"``) against flash within 2e-2;
     then internlm2-20b and yi-9b at full width, 2 layers, one greedy
     generate each held against a fresh forward within 2e-2;
 11. mixed serving — ``MixedScheduler(max_len=256, decode_chunk=8)`` over
     one adaptive ``ig`` ``ExplainEngine`` on phase 9's model (m=64,
     n_int=4, chunk 16, tol 1e-2, m_max 256, S buckets 32, 64, 128, 512):
     one round of 8 greedy INTERACTIVE generates of 128 + 32 tokens (4
     with the donated endpoint), 1 streamed of 64 + 4, 2 BATCH sampled at
     T=0.8 with seed 1234 and 8 explain-only requests of 17–128 tokens,
     served cold, warm (no miss, the same bits and tokens) and profiled;
     per-class p50/p99, walls, decode ms a token beside the same greedy
     generates alone, the deepest queue and peak memory. Gates: every
     ticket done, every id in [0, V), scores finite and exactly 0 past each
     request; the greedy tokens equal ``ServeEngine.generate``'s on the
     same batch; each donated f(x) within rtol = atol = 2e-2 of the
     engine's own, and every scheduled attribution ``engine.explain``'s on
     the same request list bit for bit; hops queued by the requests that
     climbed are preempted by later generates; one fault round (a
     transient fault at the first hop, an exhausted one at the first
     ``exp_start`` bucket, one raised inside a sampled decode chunk's
     second ``decode_step``) gives the clean bits and tokens but for
     exactly that bucket's requests, which degrade; then a LIME scheduler
     (64 masks) whose mask batches decode preempts, its attributions
     ``lime.explain``'s bit for bit. Prefill items launch the flash
     forward only, decode items nothing;
 12. gemma3-27b generation — ``ServeEngine`` at full width and window
     (d=5376, 32 heads on 16, SwiGLU 21504, vocabulary 262,144 tied, w=1024),
     cut to 32 of 62 layers (5 periods of 5 local + 1 global, then the (L, L)
     remainder; bf16, flash for the global layers, weights drawn on the
     card): greedy groups A (2 × 1000 + 48: prefill below w, the rings wrap
     in decode), B (2 × 2000 + 48: the rolled prefill) and C (2 × 4096 + 32:
     the blocked local path); A's and B's decode logits teacher-forced
     against a fresh forward within 2e-2 of the row's largest |logit|, their
     tokens that forward's argmax but at near ties; C's prefill and decode
     timed and a decode chunk after it profiled; the card against the CPU on
     a narrow gemma3 (reduced widths, 8 layers, w=64, 2 prompts of 256 + 80
     new, f32) within 1e-4, tokens equal;
 13. gemma3-27b explanations — ``ExplainEngine`` at full width, 8 layers
     (one period and the (L, L) remainder), chunk 4, S buckets the defaults
     and 2048, over 7 seeded requests (4 of 17–128 tokens, 2 of 300–512, 1
     of 1100–2000), ``ig`` unfused and fused at m=64, each served twice (no
     miss on the replay, the same bits); fused against unfused within
     rtol = atol = 2e-2; one warm round profiled; the card against the CPU
     on a narrow gemma3 (w=8, buckets 16 and 32 > 2w, m=8, f32);
 14. gemma3-27b mixed serving — ``MixedScheduler(max_len=1048,
     decode_chunk=8)`` over an ``ig`` engine on phase 13's model: 2 greedy
     generates of 1000 + 48 and 2 explain-only requests, the tokens
     ``ServeEngine.generate``'s and the attributions ``engine.explain``'s
     bit for bit; then the round again with a fault raised inside
     ``decode_step`` at the third step of the chunk from position 1024 (its
     first two steps overwrote ring slots the retried steps attend to): the
     retry gives the clean tokens and bits, every decode step's logits
     and the final cache bit for bit, and nothing degrades; a control
     round with the rings' snapshot saving nothing must not match;
 15. qwen3-moe-30b-a3b explanations — ``ExplainEngine`` at full width
     (d=2048, 32 heads on 4 of 128, 128 experts top-8 of 768, vocabulary
     151,936), 4 of 48 layers, bf16, flash, over the LM engine phase's 20
     requests, m=64, at the largest chunk whose ``hotpath_cost`` peak fits
     70 GB: ``ig`` unfused and fused, each served twice (no miss, the same
     bits), the warm round's measured peak at or below the predicted one,
     fused against unfused printed (a near-tie routing may part two bf16
     paths), the share of (token, choice) slots the capacity dropped in one
     call of each bucket (recorded beside the model), one profiled warm
     round; the card against the CPU (f32, 2 prompts, m=8), rows exempt
     (and counted) when a router's near tie (margin below 1e-5) routes a
     token apart;
 16. qwen3-moe-30b-a3b generation — ``ServeEngine`` at 16 layers: 16 × 128 +
     64 greedy, an 8-step decode chunk (profiled), bf16 decode against a
     fresh forward (printed), the card against the CPU at 2 layers, f32,
     within 1e-4 unless a router's near tie parts them;
 17. mamba2-780m at full width and depth (48 layers, 48 SSD heads of 64,
     state 128, chunk 256; no attention, so no flash kernel) — generation
     (16 × 128 + 64; 2 × 997 + 32, whose prefill runs at chunk 1; a decode
     chunk; f32 decode against a fresh forward within 1e-4 after a 509-token
     chunk-1 prefill), ``ExplainEngine`` ``ig`` over the 20 requests at the
     largest fitting chunk, served twice (every score finite at buckets 128
     and 512, the peak against the prediction, a profiled m=8 call of the
     512 bucket), and a ``MixedScheduler`` round whose fault inside a decode
     chunk retries to the clean tokens, logits and SSM states bit for bit
     (a control with the states unsaved must differ);
 18. jamba-v0.1-52b at full width, 5 layers (M_D M_E M_D M_E A_D, no whole
     period) — ``ExplainEngine`` ``ig`` over 6 requests of 17–128 tokens,
     m=64, served twice with the peak gate and a profiled warm round, and a
     greedy generate of 2 × 128 + 32 against a fresh forward (printed).

Before the slices, the kernels at the LM engine's shapes in bf16: the
stage-2 kernels at (16, 16, 128·4096) beside their byte bounds, and the
flash trio at 256 sequences of 128 (32 query heads on 8, head dim 128,
causal, ragged lengths) beside SDPA on the same tensors and their bounds
at the bf16 rate (``at_lm_shape`` in each kernel's record).
Then the flash forward at the serve phase's prefill shapes (16 × 128 and
2 × 999, 32 on 8, D=128, bf16, causal, every key) against its plain
version, timed beside SDPA's forward and its bound
(``at_prefill_shapes``), and at the GQA groups of internlm2-20b (48 on 8)
and yi-9b (32 on 4) with ragged lengths (``at_gqa_groups``). Then at gemma3-27b's shapes: the flash forward at group
C's prefill attention (2 × 4096, 32 on 16, D=128, bf16, causal) against its
plain version, timed beside SDPA's forward and its bound
(``at_gemma_prefill``); the trio at the engine's 2048 bucket (4 rows, ragged)
beside SDPA (``at_gemma_explain``); ``local_attention``'s blocked path at
2 × 4096 against the masked ``full_attention(window=1024)``, both timed; and
the four stage-2 kernels of ``ig`` at that bucket's (1, 4, 2048·5376) in
bf16 against their plain versions beside their bounds (``at_gemma_explain``).

Gates of the slices: finite results, every kernel of each path launched
and no other, fused agrees with unfused, resume (and a replayed
forward-only call) is bit-identical, and the card agrees with the port run
on CPU copies (the CNN's first batch; two ViT images at m=16 or P=16). The
launch counts are reset before each slice and read after it; ``interp_add``'s
are split by carry rank (the ``ig`` slices broadcast, the ViT IDGI slice
per step, the LM engine both). The LM engine adds: raw scores exactly 0
past each request's tokens, and no new miss on replayed traffic. Every
generate path of the serve slices launches the flash forward and no other
kernel; their decode chunks launch none; the gemma3 and qwen3-moe engine
slices launch the flash trio and the four kernels of ``ig`` unfused and
fused, jamba's the trio and unfused ``ig``'s two; the mamba2 slice launches
no flash kernel. The mixed slice counts its launches
by work-item kind as well (prefill, decode, ``exp_start``, hop, ``exp_fwd``).

Before the last line it prints one JSON object ``{"kernels": [...]}`` (per
kernel: launches on the slices, errors, ms, plain_ms, bound_ms, library_ms);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores (dense)
B, K, F = 16, 64, 3072  # the CNN path's stage-2 shape: 16 images, m=64, 32·32·3
VIT_STAGE2 = (16, 16, 224 * 224 * 3)  # the ViT path's: 16 images, chunk=16 steps
VIT_ATTN = (16 * 16, 196, 6, 6, 64)  # (B·chunk, S, NQ, NKV, D) of the ViT's attention
LM_ATTN = (2, 333, 8, 2, 128)  # a causal GQA ragged shape at the LMs' head dim
# long causal GQA key sweeps, the engine's largest bucket, at the LMs' and the reduced LM's head dim
LONG_ATTN = ((2, 1024, 8, 2, 128), (2, 1024, 8, 2, 16))
LONG_KVLEN = (1024, 611)  # one row sees the whole sweep
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # the JAX flash tests' own
VIT_BATCHES, VIT_CHUNK, VIT_M_MAX, VIT_CPU_M = 3, 16, 256, 16
N_MASKS, CPU_MASKS, CNN_CELL = 64, 16, 4  # forward-only: masks a row, at the CPU check; cell side
WLS_SHAPES = ((16, 17, False), (5, 17, True), (16, 65, False))  # (B, N, masked) of the solve
N_BATCHES, M, N_INT, TOL = 4, 64, 4, 1e-2
TOL_LADDER = 0.0  # every row whose δ is not exactly 0 climbs the whole ladder
TOL_F32 = 1e-6  # elementwise f32 kernels: FMA contraction is off, rounding matches
TOL_SUM = 1e-5  # K-sums, relative to the largest |value|: another summation order
TOL_BF16 = 2.0**-7  # one bf16 ulp for values in [1, 2)
# kernel groups of a profiler trace, by substrings of the kernels' names
PROFILE_GROUPS = {
    "Triton (the port's)": ("_interp_kernel", "_accum_kernel", "_interp_add_kernel",
                            "_accum_cot_kernel", "_dots_kernel", "_dots_sum_kernel"),
    "flash (the port's)": ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"),
    "solve (the port's)": ("gauss_jordan",),
    "GEMM (cuBLAS)": ("gemm", "Gemm", "gemv", "nvjet"),
    "casts and copies": ("copy_kernel",),
    "gathers, sorts and scans": ("index", "gather", "Sort", "sort", "scan", "Scan"),
}


def _sync():
    if DEV == "cuda":
        torch.cuda.synchronize()


def _cold_ms(fn) -> float:
    """Mean device time of ``fn`` with a cold L2 (``repro_torch.kernels.sweep.cold_ms``)."""
    from repro_torch.kernels.sweep import cold_ms

    return cold_ms(fn)


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    return float((got.float() - want.float()).abs().max())


def _check(name: str, err: float, tol: float) -> None:
    print(f"  {name}: max_abs_err={err:.3g} tol={tol:.3g}")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")


def _bound(nbytes: int, flops: int, tf32x3: bool = False) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes over the card's memory
    rate and the operations over its f32 rate, or, with ``tf32x3``, three
    TF32 tensor-core operations per f32 operation (f32 accuracy on the
    tensor cores) over the TF32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    if tf32x3:
        t_ops, ops = 3 * flops / TF32_FLOPS, "operations (3xTF32)"
    else:
        t_ops, ops = flops / FP32_FLOPS, "operations"
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else ops


def _triton_specs(g: torch.Generator, B: int, K: int, F: int) -> list[dict]:
    """The six Triton kernels, each with its plain version and library call,
    on seeded inputs of the stage-2 shape (B, K, F) f32."""
    from repro_torch.kernels.ig_accum import kernel as k_acc, ref as r_acc
    from repro_torch.kernels.interp_accum import kernel as k_ia, ref as r_ia
    from repro_torch.kernels.interpolate import kernel as k_int, ref as r_int

    rnd = lambda *s: torch.rand(s, generator=g, device=DEV)
    x, b = rnd(B, F), rnd(B, F)  # images in [0, 1), like the slice's
    a = rnd(B, K)
    w = rnd(B, K) / K
    acc = torch.randn(B, F, generator=g, device=DEV)
    grads = torch.randn(B, K, F, generator=g, device=DEV)
    carry = torch.randn(B, F, generator=g, device=DEV) * 0.01
    diff = x - b
    es = 4  # f32 bytes
    return [
        dict(name="interpolate", source="src/repro_torch/kernels/interpolate/kernel.py",
             replaces="src/repro/kernels/interpolate/kernel.py:30",
             kernel=lambda: k_int.interpolate_triton(x, b, a),
             plain=lambda: r_int.interpolate_ref(x, b, a),
             library=lambda: torch.lerp(b[:, None, :], x[:, None, :], a[:, :, None]),
             tol=TOL_F32, nbytes=es * (2 * B * F + B * K + B * K * F), flops=B * F + 2 * B * K * F),
        dict(name="ig_accum", source="src/repro_torch/kernels/ig_accum/kernel.py",
             replaces="src/repro/kernels/ig_accum/kernel.py:133",
             kernel=lambda: k_acc.ig_accum_triton(acc, grads, w),
             plain=lambda: r_acc.ig_accum_ref(acc, grads, w),
             library=lambda: torch.baddbmm(acc[:, None, :], w[:, None, :], grads),
             tol=None, nbytes=es * (2 * B * F + B * K + B * K * F), flops=2 * B * K * F + B * F),
        # the library call computes ⟨g, diff⟩ only, reading the same bytes
        dict(name="idgi_dots", source="src/repro_torch/kernels/ig_accum/kernel.py",
             replaces="src/repro/kernels/ig_accum/kernel.py:69",
             kernel=lambda: k_acc.idgi_dots_triton(grads, diff),
             plain=lambda: r_acc.idgi_dots_ref(grads, diff),
             library=lambda: torch.bmm(grads, diff[:, :, None]),
             tol=None, nbytes=es * (B * K * F + B * F + 2 * B * K), flops=4 * B * K * F),
        dict(name="ig_accum_sq", source="src/repro_torch/kernels/ig_accum/kernel.py",
             replaces="src/repro/kernels/ig_accum/kernel.py:102",
             kernel=lambda: k_acc.ig_accum_sq_triton(acc, grads, w),
             plain=lambda: r_acc.ig_accum_sq_ref(acc, grads, w),
             library=None,
             tol=None, nbytes=es * (2 * B * F + B * K + B * K * F), flops=3 * B * K * F + B * F),
        dict(name="interp_add", source="src/repro_torch/kernels/interp_accum/kernel.py",
             replaces="src/repro/kernels/interp_accum/kernel.py:64",
             kernel=lambda: k_ia.interp_add_triton(x, b, a, carry),
             plain=lambda: r_ia.interp_add_ref(x, b, a, carry),
             library=None,
             tol=TOL_F32, nbytes=es * (3 * B * F + B * K + B * K * F), flops=B * F + 3 * B * K * F),
        dict(name="accum_cot", source="src/repro_torch/kernels/interp_accum/kernel.py",
             replaces="src/repro/kernels/interp_accum/kernel.py:104",
             kernel=lambda: k_ia.accum_cot_triton(grads),
             plain=lambda: r_ia.accum_cot_ref(grads),
             library=lambda: grads.sum(1),
             tol=None, nbytes=es * (B * K * F + B * F), flops=B * K * F),
    ]


def _step_carry_spec(g: torch.Generator, B: int, K: int, F: int) -> dict:
    """``interp_add`` with the per-step (B, K, F) f32 carry, IDGI's fused
    form, on seeded inputs of the stage-2 shape (B, K, F) f32: it reads the
    carry in full, so its bound has twice the other form's bytes."""
    from repro_torch.kernels.interp_accum import kernel as k_ia, ref as r_ia

    rnd = lambda *s: torch.rand(s, generator=g, device=DEV)
    x, b, a = rnd(B, F), rnd(B, F), rnd(B, K)
    carry = torch.randn(B, K, F, generator=g, device=DEV) * 0.01
    return dict(name="interp_add", label="interp_add (per-step carry)",
                source="src/repro_torch/kernels/interp_accum/kernel.py",
                replaces="src/repro/kernels/interp_accum/kernel.py:64",
                kernel=lambda: k_ia.interp_add_triton(x, b, a, carry),
                plain=lambda: r_ia.interp_add_ref(x, b, a, carry),
                library=None, tol=TOL_F32, nbytes=4 * (2 * B * F + B * K + 2 * B * K * F),
                flops=B * F + 3 * B * K * F)


def _record(s: dict, route: str, err: float, tol: float) -> dict:
    """Time one kernel spec, its plain version and its library call, beside
    its bound; the kernel's record for the kernels line."""
    bound_ms, bound_by = _bound(s["nbytes"], s["flops"], s.get("tf32x3", False))
    return {
        "name": s["name"], "route": route, "source": s["source"], "replaces": s["replaces"],
        "launches": 0, "max_abs_err": err, "tolerance": tol,
        "ms": _cold_ms(s["kernel"]), "plain_ms": _cold_ms(s["plain"]),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None if s["library"] is None else _cold_ms(s["library"]),
    }


def _measure(s: dict) -> dict:
    """Check one Triton kernel spec against its plain version (each output,
    for a kernel with several), then time it."""
    got, want = s["kernel"](), s["plain"]()
    _sync()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err, tol = 0.0, 0.0
    for i, (gi, wi) in enumerate(zip(got, want)):
        e = _err(gi, wi)
        t = s["tol"] if s["tol"] is not None else TOL_SUM * float(wi.abs().max())
        _check(s.get("label", s["name"]) + (f" output {i}" if len(got) > 1 else ""), e, t)
        err, tol = max(err, e), max(tol, t)
    return _record(s, "triton", err, tol)


def kernel_phase() -> list[dict]:
    """Each Triton kernel vs its plain version on the card; one record each,
    timed at the CNN's stage-2 shape and again at the ViT's."""
    from repro_torch.core import methods, paths
    from repro_torch.kernels import common
    from repro_torch.kernels.ig_accum import kernel as k_acc, ops as o_acc, ref as r_acc
    from repro_torch.kernels.interp_accum import kernel as k_ia, ops as o_ia, ref as r_ia
    from repro_torch.kernels.interpolate import kernel as k_int, ops as o_int, ref as r_int

    g = torch.Generator(device=DEV).manual_seed(0)
    rnd = lambda *s: torch.rand(s, generator=g, device=DEV)
    keys = ("max_abs_err", "tolerance", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"kernels at the CNN path's shape B={B} K={K} F={F} f32:")
    records = [_measure(s) for s in _triton_specs(g, B, K, F)]
    step = {k: v for k, v in _measure(_step_carry_spec(g, B, K, F)).items() if k in keys}
    Bv, Kv, Fv = VIT_STAGE2
    print(f"kernels at the ViT path's shape B={Bv} K={Kv} F={Fv} f32:")
    for rec, s in zip(records, _triton_specs(g, Bv, Kv, Fv)):
        vit = _measure(s)
        rec["at_vit_shape"] = {k: vit[k] for k in keys}
    step["at_vit_shape"] = {k: v for k, v in _measure(_step_carry_spec(g, Bv, Kv, Fv)).items() if k in keys}
    ia = next(r for r in records if r["name"] == "interp_add")
    ia["per_step_carry"] = step
    for form, r in (("broadcast carry", ia), ("per-step carry", step)):
        print(f"  interp_add ({form}): {r['ms']:.5f} ms at the CNN's shape (bound {r['bound_ms']:.5f}), "
              f"{r['at_vit_shape']['ms']:.5f} ms at the ViT's (bound {r['at_vit_shape']['bound_ms']:.5f}), "
              f"{r['at_vit_shape']['bound_ms'] / r['at_vit_shape']['ms']:.3f} of the bound there")
    x, b, a = rnd(B, F), rnd(B, F), rnd(B, K)
    carry = torch.randn(B, F, generator=g, device=DEV) * 0.01
    grads = torch.randn(B, K, F, generator=g, device=DEV)

    print("kernels at a ragged shape (B=5, K=37, F=3·31·29, masked) through the op wrappers:")
    Bm, Km, feat = 5, 37, (31, 29, 3)
    xm, bm = rnd(Bm, *feat), rnd(Bm, *feat)
    am, wm = rnd(Bm, Km), rnd(Bm, Km) / Km
    mask = rnd(Bm, 31) > 0.3
    gm = torch.randn((Bm, Km) + feat, generator=g, device=DEV)
    accm = torch.randn((Bm,) + feat, generator=g, device=DEV)
    um = torch.randn((Bm,) + feat, generator=g, device=DEV) * 0.01
    _check("interpolate", _err(o_int.interpolate(xm, bm, am, mask=mask),
                               paths.interpolate(xm, bm, am, mask=mask)), TOL_F32)
    want = methods.riemann_accum(accm, gm, wm, mask=mask)
    _check("ig_accum", _err(o_acc.ig_accum(accm, gm, wm, mask=mask), want),
           TOL_SUM * float(want.abs().max()))
    _check("interp_add", _err(o_ia.interp_accum(xm, bm, am, um, mask=mask),
                              paths.interp_add(xm, bm, am, um, mask=mask)), TOL_F32)
    u1, u2 = um.clone().requires_grad_(), um.clone().requires_grad_()
    (g1,) = torch.autograd.grad((o_ia.interp_accum(xm, bm, am, u1, mask=mask) * gm).sum(), u1)
    (g2,) = torch.autograd.grad((paths.interp_add(xm, bm, am, u2, mask=mask) * gm).sum(), u2)
    _check("accum_cot", _err(g1, g2), TOL_SUM * float(g2.abs().max()))
    us = torch.randn((Bm, Km) + feat, generator=g, device=DEV) * 0.01
    _check("interp_add (per-step carry)", _err(o_ia.interp_accum(xm, bm, am, us, mask=mask),
                                               paths.interp_add(xm, bm, am, us, mask=mask)), TOL_F32)
    gm[1, 3] = 0  # a zero-gradient step inside a row
    for dt in (torch.float32, torch.bfloat16):  # both IDGI kernels through the op
        want = methods.idgi_accum(accm, gm.to(dt), wm, diff=(xm - bm).to(dt), mask=mask)
        got = o_acc.ig_accum_idgi(accm, gm.to(dt), wm, diff=(xm - bm).to(dt), mask=mask)
        _check(f"ig_accum_idgi {str(dt)[6:]}", _err(got, want), TOL_SUM * float(want.abs().max()))

    print("kernels in bf16 at the main path's shape:")
    xb, bb = x.bfloat16(), b.bfloat16()
    _check("interpolate bf16", _err(k_int.interpolate_triton(xb, bb, a), r_int.interpolate_ref(xb, bb, a)),
           TOL_BF16)
    _check("interp_add bf16", _err(k_ia.interp_add_triton(xb, bb, a, carry),
                                   r_ia.interp_add_ref(xb, bb, a, carry)), TOL_BF16)
    _check("accum_cot bf16", _err(k_ia.accum_cot_triton(grads.bfloat16()),
                                  r_ia.accum_cot_ref(grads.bfloat16())),
           TOL_SUM * float(grads.abs().sum(1).max()))
    sms = common.sm_count(torch.device(DEV))
    for shape in ((B, K, F), VIT_STAGE2):  # the resume gates compare with torch.equal
        Bs, Ks, Fs = shape
        gs = torch.randn(shape, generator=g, device=DEV)
        accs, cs = torch.randn(Bs, Fs, generator=g, device=DEV), rnd(Bs, Ks) / Ks
        bs, us = rnd(Bs, Fs), torch.randn(Bs, Fs, generator=g, device=DEV) * 0.01
        sweeps = {"accum_cot": lambda: (k_ia.accum_cot_triton(gs),),
                  "ig_accum": lambda: (k_acc.ig_accum_triton(accs, gs, cs),),
                  "ig_accum_sq": lambda: (k_acc.ig_accum_sq_triton(accs, gs, cs),),
                  "idgi_dots": lambda: k_acc.idgi_dots_triton(gs, accs),
                  "interpolate": lambda: (k_int.interpolate_triton(accs, bs, cs),),
                  "interp_add": lambda: (k_ia.interp_add_triton(accs, bs, cs, us),),
                  "interp_add (per-step carry)": lambda: (k_ia.interp_add_triton(accs, bs, cs, gs * 0.01),)}
        for name, fn in sweeps.items():
            if not all(torch.equal(a1, a2) for a1, a2 in zip(fn(), fn())):
                raise AssertionError(f"{name} at {shape}: two calls on one input differ")
        tile = common.sweep_tile(Bs, Fs, gs.dtype, sms)
        print(f"  {', '.join(sweeps)} at {shape}: the same bits on a second call; (BLOCK_F, "
              f"num_warps) {tile} for the K-sums and interpolate, (BLOCK_F, num_warps, UNROLL) "
              f"{k_ia.interp_add_plan(Bs, Fs, gs.dtype, False, sms)} for interp_add, "
              f"{k_ia.interp_add_plan(Bs, Fs, gs.dtype, True, sms)} with the per-step carry; "
              f"idgi_dots' plan {common.dots_plan(Bs, Ks, Fs, gs.dtype, sms)}")
    gb, db = grads.bfloat16(), (x - b).bfloat16()
    for i, (got, want) in enumerate(zip(k_acc.idgi_dots_triton(gb, db), r_acc.idgi_dots_ref(gb, db))):
        _check(f"idgi_dots bf16 output {i}", _err(got, want), TOL_SUM * float(want.abs().max()))
    w = rnd(B, K) / K
    want = r_acc.ig_accum_ref(carry, gb, w)
    _check("ig_accum bf16", _err(k_acc.ig_accum_triton(carry, gb, w), want),
           TOL_SUM * float(want.abs().max()))
    want = r_acc.ig_accum_sq_ref(carry, gb, w)
    _check("ig_accum_sq bf16", _err(k_acc.ig_accum_sq_triton(carry, gb, w), want),
           TOL_SUM * float(want.abs().max()))

    print("IDGI kernels on zero-gradient rows (output exactly 0 and finite):")
    gz = grads.clone()
    gz[::2] = 0  # every other row: every step's gradient is 0
    s_, p_ = k_acc.idgi_dots_triton(gz, x - b)
    out = o_acc.ig_accum_idgi(torch.zeros(B, F, device=DEV), gz, w, diff=x - b)
    _sync()
    zero = [s_[::2], p_[::2], out[::2]]
    if not (all(not bool(z.any()) for z in zero) and bool(torch.isfinite(out).all())):
        raise AssertionError("IDGI on zero-gradient rows: not exactly 0 or not finite")
    print("  ⟨g,g⟩, ⟨g,diff⟩ and the accumulation exactly 0 on the zero rows, all finite")
    # what a launch costs in this timing with next to no work: the floor under
    # every kernel's time at the small CNN shape
    one = (torch.zeros(1, 128, device=DEV), torch.zeros(1, 1, 128, device=DEV),
           torch.zeros(1, 1, device=DEV))
    print(f"launch floor: ig_accum on one 128-column row, cold L2, "
          f"{_cold_ms(lambda: k_acc.ig_accum_triton(*one)):.5f} ms")
    return records


def _flash_inputs(g, Bq, S, NQ, NKV, D, dtype, ragged):
    """q, k, v, dO in the model's (B, S, H, D) layout, seen through the
    transposed (B, H, S, D) views the op hands the kernels, and kvlen
    (``ragged``: random lengths, or the lengths themselves)."""
    rnd = lambda *s: torch.randn(s, generator=g, device=DEV).to(dtype).transpose(1, 2)
    q, k, v, do = rnd(Bq, S, NQ, D), rnd(Bq, S, NKV, D), rnd(Bq, S, NKV, D), rnd(Bq, S, NQ, D)
    if isinstance(ragged, tuple):
        kvlen = torch.tensor(ragged, dtype=torch.int32, device=DEV)
    elif ragged:
        kvlen = torch.randint(1, S + 1, (Bq,), generator=g, device=DEV, dtype=torch.int32)
    else:
        kvlen = torch.full((Bq,), S, dtype=torch.int32, device=DEV)
    return q, k, v, do, kvlen


def _flash_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, float]:
    """|got − want| ≤ tol·(1 + |want|) elementwise (the JAX tests' allclose
    with rtol = atol = tol); returns the largest absolute error and the
    worst ratio of error to what is allowed."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    diff = (got.detach().float() - want.float()).abs()
    ratio = float((diff / (tol * (1 + want.float().abs()))).max()) if diff.numel() else 0.0
    err = float(diff.max()) if diff.numel() else 0.0
    print(f"  {name}: max_abs_err={err:.3g} worst err/allowed={ratio:.3g} (tol {tol:g})")
    if not ratio <= 1:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")
    return err, ratio


def _flash_check(g, Bq, S, NQ, NKV, D, dtype, causal, ragged) -> dict:
    """Each flash kernel against its plain version on the same inputs, then
    the op's forward and autograd against the analytic oracle; returns each
    kernel's largest error and worst err/allowed ratio."""
    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr
    from repro_torch.kernels.flash_attention.ops import flash_attention

    tol = FLASH_TOL[dtype]
    q, k, v, do, kvlen = _flash_inputs(g, Bq, S, NQ, NKV, D, dtype, ragged)
    print(f"flash kernels at B={Bq} S={S} NQ={NQ} NKV={NKV} D={D} {dtype} causal={causal} "
          f"ragged={ragged}:")
    o_ref, lse_ref = fr.flash_fwd_ref(q, k, v, kvlen, causal=causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, kvlen)
    o, lse = fk.flash_fwd_cuda(q, k, v, kvlen, causal=causal)
    dq = fk.flash_bwd_dq_cuda(*args, causal=causal)
    dk, dv = fk.flash_bwd_dkv_cuda(*args, causal=causal)
    dk_ref, dv_ref = fr.flash_bwd_dkv_ref(*args, causal=causal)
    _sync()
    worst = lambda *pairs: tuple(max(x) for x in zip(*pairs))
    errs = {
        "flash_fwd": worst(_flash_close("flash_fwd o", o, o_ref, tol),
                           _flash_close("flash_fwd lse", lse, lse_ref, tol)),
        "flash_bwd_dq": _flash_close("flash_bwd_dq", dq, fr.flash_bwd_dq_ref(*args, causal=causal),
                                     tol),
        "flash_bwd_dkv": worst(_flash_close("flash_bwd_dkv dk", dk, dk_ref, tol),
                               _flash_close("flash_bwd_dkv dv", dv, dv_ref, tol)),
    }
    # the op, model layout in and out, through autograd
    t = lambda x: x.transpose(1, 2)
    leaves = [t(x).detach().clone().requires_grad_() for x in (q, k, v)]
    lengths = kvlen if ragged else None
    out = flash_attention(*leaves, causal=causal, lengths=lengths)
    grads = torch.autograd.grad(out, leaves, t(do))
    _flash_close("op forward", out, t(fr.attention_ref(q, k, v, causal=causal, lengths=lengths)), tol)
    want = fr.attention_vjp_ref(q, k, v, do, causal=causal, lengths=lengths)
    for name, got, w in zip(("op dq", "op dk", "op dv"), grads, want):
        _flash_close(name, got, t(w), tol)
    return errs


def flash_kernel_phase() -> list[dict]:
    """The three CUDA flash kernels against their plain versions at the ViT
    slice's attention shape, at a causal GQA ragged shape (f32, bf16) and
    over 1024-key causal GQA sweeps (f32); timed at the ViT's shape beside
    their plain versions, SDPA (its memory-efficient backend, which runs f32
    as 3xTF32 on the tensor cores) and the 3xTF32 bound. One record each,
    with its worst err/allowed ratio over the long sweeps."""
    import torch.nn.functional as tnf
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr

    g = torch.Generator(device=DEV).manual_seed(2)
    errs = {n: e for n, (e, _) in _flash_check(g, *VIT_ATTN, torch.float32, False, False).items()}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (e, _) in _flash_check(g, *LM_ATTN, dtype, True, True).items():
            if dtype == torch.float32:
                errs[name] = max(errs[name], e)
    long_ratio = {}  # worst err/allowed over the long sweeps, by kernel and head dim
    for shape in LONG_ATTN:
        for name, (e, r) in _flash_check(g, *shape, torch.float32, True, LONG_KVLEN).items():
            errs[name] = max(errs[name], e)
            long_ratio.setdefault(name, {})[f"D={shape[-1]}"] = r
    print("  worst err/allowed over the 1024-key causal GQA sweeps (f32, tol 1e-4): "
          + "; ".join(f"{n} {json.dumps(r)}" for n, r in long_ratio.items()))

    Bq, S, NQ, NKV, D = VIT_ATTN
    q, k, v, do, kvlen = _flash_inputs(g, Bq, S, NQ, NKV, D, torch.float32, False)
    o, lse = fk.flash_fwd_cuda(q, k, v, kvlen, causal=False)
    delta = (do * o).sum(-1)
    args = (q, k, v, do, lse, delta, kvlen)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    backend = SDPBackend.EFFICIENT_ATTENTION

    def sdpa_fwd():
        with sdpa_kernel(backend):
            return tnf.scaled_dot_product_attention(q, k, v)

    with sdpa_kernel(backend):  # the backward runs the backend the forward chose
        o_sdpa = tnf.scaled_dot_product_attention(*leaves)
    sdpa_bwd = lambda: torch.autograd.grad(o_sdpa, leaves, do, retain_graph=True)
    print(f"  SDPA yardstick: backend {backend.name}, backward node {type(o_sdpa.grad_fn).__name__}")
    qkv_bytes, row_bytes = 4 * Bq * S * D * (NQ + 2 * NKV), 4 * Bq * NQ * S
    q_bytes, kv_bytes = 4 * Bq * NQ * S * D, 4 * Bq * NKV * S * D
    work = Bq * NQ * S * S * D
    src = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
    replaces = "src/repro/kernels/flash_attention/kernel.py:"
    specs = [
        dict(name="flash_fwd", replaces=replaces + "99",
             kernel=lambda: fk.flash_fwd_cuda(q, k, v, kvlen, causal=False),
             plain=lambda: fr.flash_fwd_ref(q, k, v, kvlen, causal=False),
             library=sdpa_fwd, nbytes=qkv_bytes + q_bytes + row_bytes, flops=4 * work),
        dict(name="flash_bwd_dq", replaces=replaces + "212",
             kernel=lambda: fk.flash_bwd_dq_cuda(*args, causal=False),
             plain=lambda: fr.flash_bwd_dq_ref(*args, causal=False), library=sdpa_bwd,
             nbytes=qkv_bytes + 2 * q_bytes + 2 * row_bytes, flops=6 * work),
        dict(name="flash_bwd_dkv", replaces=replaces + "299",
             kernel=lambda: fk.flash_bwd_dkv_cuda(*args, causal=False),
             plain=lambda: fr.flash_bwd_dkv_ref(*args, causal=False), library=sdpa_bwd,
             nbytes=qkv_bytes + q_bytes + 2 * row_bytes + 2 * kv_bytes, flops=8 * work),
    ]
    records = []
    for s in specs:
        r = _record(dict(s, source=src, tf32x3=True), "cuda", errs[s["name"]], FLASH_TOL[torch.float32])
        r["worst_ratio_1024_keys"] = long_ratio[s["name"]]
        records.append(r)
        print(f"  {s['name']} at the ViT shape: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    pair, sdpa = records[1]["ms"] + records[2]["ms"], records[1]["library_ms"]
    print(f"  backward pair (flash_bwd_dq + flash_bwd_dkv): {pair:.4f} ms against one SDPA backward "
          f"({backend.name}) {sdpa:.4f} ms, ratio {pair / sdpa:.3f}")
    return records


def _lime_system(g, B: int, N: int, masked: bool):
    """LIME's normal equations on the card: N−1 Bernoulli(0.5) group columns
    and the intercept over P = max(64, 4N) masks (a full-rank design, as
    LIME's), weighted by the proximity kernel, with normal responses;
    ``masked`` pins about a third of the groups out. Returns the prepared
    system (A + λI, pinned) and the raw one with its mask."""
    from repro_torch.core.perturb import lime_weights
    from repro_torch.kernels.lstsq import ref as lr

    P = max(N_MASKS, 4 * N)
    zg = (torch.rand((B, P, N - 1), generator=g, device=DEV) < 0.5).float()
    X = torch.cat([zg, torch.ones((B, P, 1), device=DEV)], dim=-1)
    A, rhs = lr.normal_eqs(X, lime_weights(zg, 0.25), torch.randn((B, P), generator=g, device=DEV))
    mask = None
    if masked:
        mask = (torch.rand((B, N), generator=g, device=DEV) > 0.3).float()
        mask[:, -1] = 1  # the intercept stays live
    return lr.prepare_normal_eqs(A, rhs, mask, 1e-2), (A, rhs, mask)


def solve_kernel_phase() -> dict:
    """The Gauss–Jordan kernels against their plain version (gated equal
    bit for bit, and at 1e-6 of max|β|) at the LIME slice's shape, at a
    ragged masked shape (β exactly 0 where masked, through the op) and at
    N=65, printing the variant ``solve_plan`` chose for each; each timed
    beside its bound, the plain sweep and ``torch.linalg.solve_ex`` (LU
    with pivoting; ``solve`` itself would wait on the host to check its
    info). One record, at the slice's shape."""
    from repro_torch.kernels.lstsq import kernel as lk, ops as lo, ref as lr

    g = torch.Generator(device=DEV).manual_seed(3)
    out = {}
    for B_, N, masked in WLS_SHAPES:
        (Ap, bp), (A, rhs, mask) = _lime_system(g, B_, N, masked)
        got, want = lk.wls_solve_cuda(Ap, bp), lr.gauss_jordan_ref(Ap, bp)
        _sync()
        name = f"wls_solve B={B_} N={N}" + (" masked" if masked else "")
        err, tol = _err(got, want), 1e-6 * float(want.abs().max())
        _check(name, err, tol)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bit-equal to the plain sweep")
        limit = torch.cuda.get_device_properties(Ap.device).shared_memory_per_block_optin
        print(f"    bit-equal to the plain sweep; plan {tuple(lk.solve_plan(N, Ap.dtype, limit))}; against "
              f"torch.linalg.solve: {_err(got, lr.wls_solve_ref(A, rhs, mask=mask, ridge=1e-2)):.3g}")
        if masked:
            op = lo.wls_solve(A, rhs, mask=mask, ridge=1e-2)
            _sync()
            if bool(op[mask == 0].any()) or not torch.equal(op, got):
                raise AssertionError(f"{name}: the op's β is not exactly 0 where masked")
            print("    β exactly 0 on the masked entries (through the op)")
        spec = dict(name="wls_solve", source="src/repro_torch/kernels/lstsq/csrc/lstsq.cu",
                    replaces="src/repro/kernels/lstsq/kernel.py:56",
                    kernel=lambda: lk.wls_solve_cuda(Ap, bp), plain=lambda: lr.gauss_jordan_ref(Ap, bp),
                    library=lambda: torch.linalg.solve_ex(Ap, bp[..., None]),
                    nbytes=4 * B_ * (N * N + 2 * N), flops=B_ * N * (2 * N * N + N))
        r = _record(spec, "cuda", err, tol)
        print(f"    {r['ms'] * 1e3:.2f} µs, plain {r['plain_ms'] * 1e3:.2f} µs, solve_ex "
              f"{r['library_ms'] * 1e3:.2f} µs, bound {r['bound_ms'] * 1e3:.4f} µs ({r['bound_by']})")
        out[(B_, N, masked)] = r
    rec = out[WLS_SHAPES[0]]
    for (B_, N, masked), r in list(out.items())[1:]:
        rec[f"at B={B_} N={N}" + (" masked" if masked else "")] = {
            k: r[k] for k in ("max_abs_err", "tolerance", "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}
    return rec


def _delta_tol(res) -> torch.Tensor:
    """δ agreement allowed between two runs of one explanation: 1e-6 plus
    1e-4 of |f(x) − f(x′)|, for f32 sums taken in another order."""
    return 1e-6 + 1e-4 * (res.f_x - res.f_baseline).abs()


def _attr_close(name, got, want, rows=None) -> None:
    """Attributions per row within 1e-4 of the row's largest |attribution|."""
    d = (got.float() - want.float()).flatten(1).abs().amax(1)
    lim = 1e-4 * want.float().flatten(1).abs().amax(1) + 1e-12
    ok = d <= lim
    if rows is not None:
        ok = ok | ~rows
    print(f"  {name}: max row err/limit {float((d / lim).max()):.3g}")
    if not bool(ok.all()):
        raise AssertionError(f"{name}: rows {torch.nonzero(~ok).flatten().tolist()} disagree")


def _profile(name: str, fn) -> None:
    """Print the card's busy share of one call of ``fn``, the device time of
    each group of kernels in ``PROFILE_GROUPS`` and the top kernels by device
    time (torch.profiler, CUDA activity only); "not measured" if the trace
    has none."""
    from torch.profiler import ProfilerActivity, profile

    _sync()
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # kernels only: the trace reads fast
        t0 = time.perf_counter()
        fn()
        _sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {e.key: e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    busy = sum(kernels.values())
    if not busy:
        print(f"  profile {name}: device time not measured")
        return
    groups = dict.fromkeys(PROFILE_GROUPS, 0.0)
    for k, v in kernels.items():  # each kernel in the first group that names it
        g = next((g for g, names in PROFILE_GROUPS.items() if any(n in k for n in names)), None)
        if g is not None:
            groups[g] += v
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"  profile {name}: wall {wall_us / 1e3:.2f} ms (the trace taken and read in "
          f"{time.perf_counter() - t_all:.1f} s), device busy {busy / 1e3:.2f} ms "
          f"({busy / wall_us:.3f}), "
          + ", ".join(f"{g} {v / 1e3:.3f} ms ({v / busy:.3f} of busy)" for g, v in groups.items())
          + f", other {(busy - sum(groups.values())) / 1e3:.3f} ms, {len(kernels)} kernel names; top: "
          + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top))


def _launched(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _timed(fn):
    """(fn(), wall ms of the synchronised call, launches per kernel in it)."""
    from repro_torch.kernels import common

    _sync()
    t0 = time.perf_counter()
    before = dict(common.LAUNCHES)
    out = fn()
    _sync()
    return out, (time.perf_counter() - t0) * 1e3, _launched(before, common.LAUNCHES)


def _need(paths_launched: dict, path: str, launched: dict, names) -> None:
    """Record a path's first launches; raise unless exactly ``names`` ran."""
    paths_launched.setdefault(path, launched)
    missing = [n for n in names if launched[n] == 0]
    extra = [n for n in launched if n not in names and launched[n]]
    if missing or extra:
        raise AssertionError(f"{path}: kernels not launched {missing}, unexpected {extra}")


def _near_tie_rows(vals: torch.Tensor, m: int) -> torch.Tensor:
    """Rows whose largest-remainder ranking is within 1e-5 of a tie (or of a
    floor boundary), where two devices' probe values may allocate apart."""
    from repro_torch.core import schedule

    imp = schedule.normalized_deltas(vals)
    n = imp.shape[-1]
    q = imp * (m - n)
    rem = q - torch.floor(q)
    short = (m - n) - torch.floor(q).sum(-1)
    srt = torch.sort(rem, dim=-1, descending=True).values
    near = (torch.minimum(rem, 1 - rem) < 1e-5).any(-1)
    for r in range(vals.shape[0]):
        s = int(short[r])
        if 0 < s < n and float(srt[r, s - 1] - srt[r, s]) < 1e-5:
            near[r] = True
    return near


def slice_phase() -> dict:
    """The paper's explainer on the paper CNN, 4 batches of 16, with gates."""
    from repro_torch.configs.paper_cnn import CnnConfig
    from repro_torch.core import ig, probes, schedule
    from repro_torch.core.api import Explainer
    from repro_torch.kernels import common
    from repro_torch.models.cnn import PaperCNN, init_params

    cfg = CnnConfig()
    params = init_params(cfg, torch.Generator().manual_seed(0), device=DEV)
    model = PaperCNN(cfg, params)
    model_cpu = PaperCNN(cfg, {k: {n: t.cpu() for n, t in grp.items()} for k, grp in params.items()})
    ex = Explainer(model.prob, method="ig", schedule="paper", m=M, n_int=N_INT, device=DEV)
    ex_fused = replace(ex, fused=True)
    ex_uniform = replace(ex, schedule="uniform")
    gen = torch.Generator().manual_seed(1)
    s = cfg.image_size
    paths_launched = {}

    common.reset_launches()  # the slice's own count starts here
    for i in range(N_BATCHES):
        x_cpu = torch.rand((B, s, s, cfg.channels), generator=gen)
        t_cpu = torch.randint(0, cfg.num_classes, (B,), generator=gen)
        x, t = x_cpu.to(DEV), t_cpu.to(DEV)
        bl = torch.zeros_like(x)

        _, probe_ms, _ = _timed(lambda: ex.build_schedule(x, bl, t))
        res_u, ms_u, l_u = _timed(lambda: ex.attribute(x, bl, t))
        _need(paths_launched, "fixed-m unfused", l_u, ("interpolate", "ig_accum"))
        res_f, ms_f, l_f = _timed(lambda: ex_fused.attribute(x, bl, t))
        _need(paths_launched, "fixed-m fused", l_f, ("interp_add", "accum_cot"))
        (res_a, info), ms_a, l_a = _timed(lambda: ex.attribute_adaptive(x, bl, t, tol=TOL))
        _need(paths_launched, "adaptive", l_a, ("interpolate", "ig_accum"))
        # a zero tolerance sends rows up the whole ladder, so the hop path
        # (row gathers, refinement, resume) runs on the card too
        (res_e, info_e), ms_e, l_e = _timed(lambda: ex.attribute_adaptive(x, bl, t, tol=TOL_LADDER))
        _need(paths_launched, "adaptive, escalating", l_e, ("interpolate", "ig_accum"))
        if not (info_e["hops"] > 0).any():
            raise AssertionError(f"batch {i}: tol={TOL_LADDER} ran no hop")
        res_uni, _, _ = _timed(lambda: ex_uniform.attribute(x, bl, t))
        for name, res in (("unfused", res_u), ("fused", res_f), ("adaptive", res_a),
                          ("adaptive, escalating", res_e)):
            if not all(bool(torch.isfinite(v).all()) for v in res):
                raise AssertionError(f"batch {i} {name}: non-finite result")
            if res.attributions.shape != x.shape:
                raise AssertionError(f"batch {i} {name}: shape {tuple(res.attributions.shape)}")
        print(f"batch {i}:")
        _attr_close("fused vs unfused", res_f.attributions, res_u.attributions)
        if not bool(((res_f.delta - res_u.delta).abs() <= _delta_tol(res_u)).all()):
            raise AssertionError(f"batch {i}: fused δ disagrees with unfused")

        # resume: one ladder hop == one fixed run over the refined schedule
        for e in (ex, ex_fused):
            _, st, sched = e.start(x, bl, t)
            refined = schedule.refine_nested(sched)
            new = schedule.Schedule(refined.alphas[:, M:], refined.weights[:, M:])
            (res1, _), _, l_hop = _timed(lambda: e.resume(x, bl, t, new, st))
            _need(paths_launched, "adaptive hop" + (" fused" if e.fused else ""), l_hop,
                 ("interp_add", "accum_cot") if e.fused else ("interpolate", "ig_accum"))
            fixed = ig.attribute(model.prob, x, bl, refined, t, chunk=e.adaptive_chunk, **e.ig_kwargs())
            if not (torch.equal(res1.attributions, fixed.attributions) and torch.equal(res1.delta, fixed.delta)):
                raise AssertionError(f"batch {i}: resume (fused={e.fused}) not bit-identical")

        print(f"  wall ms: probe {probe_ms:.2f}, unfused {ms_u:.2f}, fused {ms_f:.2f}, "
              f"adaptive {ms_a:.2f}; probe share of unfused {probe_ms / ms_u:.3f}")
        print(f"  mean δ at m={M}: paper {float(res_u.delta.mean()):.3g}, "
              f"uniform {float(res_uni.delta.mean()):.3g}; adaptive m_used mean "
              f"{float(info['m_used'].mean()):.1f}, hops {info['hops'].tolist()}")
        print(f"  escalating adaptive (tol={TOL_LADDER}): {ms_e:.2f} ms, hops "
              f"{int(info_e['hops'].sum())}, steps {info_e['total_steps']}, launches {l_e}")
        if i == 1:  # warm: where one explanation's time goes
            _profile("unfused", lambda: ex.attribute(x, bl, t))
            _profile("fused", lambda: ex_fused.attribute(x, bl, t))

        if i == 0:  # the card against the port on CPU copies, one batch
            ex_cpu = replace(ex, f=model_cpu.prob, device="cpu")
            vals = probes.run_probe("boundary", model.prob, x, bl, t, n_int=N_INT).vals.cpu()
            vals_cpu = probes.run_probe("boundary", model_cpu.prob, x_cpu, bl.cpu(), t_cpu,
                                        n_int=N_INT).vals
            norm = lambda v: schedule.allocate_steps(schedule.normalized_deltas(v), M)
            tied = _near_tie_rows(vals_cpu, M) | _near_tie_rows(vals, M)
            same = (norm(vals) == norm(vals_cpu)).all(-1)
            print(f"  card vs CPU: near-tie rows {torch.nonzero(tied).flatten().tolist()}")
            if not bool((same | tied).all()):
                raise AssertionError("card and CPU allocate steps differently off a tie")
            res_c = ex_cpu.attribute(x_cpu, bl.cpu(), t_cpu)
            _attr_close("card vs CPU attributions", res_u.attributions.cpu(), res_c.attributions, ~tied)
            dd = (res_u.delta.cpu() - res_c.delta).abs()
            if not bool(((dd <= _delta_tol(res_c)) | tied).all()):
                raise AssertionError(f"card vs CPU δ: {dd.tolist()}")
            _, info_c = ex_cpu.attribute_adaptive(x_cpu, bl.cpu(), t_cpu, tol=TOL)
            thr = info_c["threshold"]
            edge = ((abs(info["delta"] - thr) <= 1e-3 * thr) | (abs(info_c["delta"] - thr) <= 1e-3 * thr))
            print(f"  card vs CPU adaptive: rows near the threshold {list(edge.nonzero()[0])}")
            for key in ("m_used", "hops", "converged"):
                if not ((info[key] == info_c[key]) | edge).all():
                    raise AssertionError(f"card vs CPU adaptive {key}: {info[key]} != {info_c[key]}")
    return {"launches": dict(common.LAUNCHES), "carry_ranks": dict(common.CARRY_RANKS),
            "per_path": paths_launched}


def _tree_to(tree: dict, device: str) -> dict:
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


# the kernels each path of an explainer launches, by accumulator class:
# (unfused, fused); the flash kernels come on top on the ViT
PATH_KERNELS = {
    "riemann": (("interpolate", "ig_accum"), ("interp_add", "accum_cot")),
    "idgi": (("interpolate", "idgi_dots", "ig_accum_sq"), ("interp_add", "idgi_dots", "ig_accum_sq")),
}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _sum_identity(name, res_idgi, res_ig) -> None:
    """Σ_j φ_idgi = Σ_j φ_ig on one schedule: both are the quadrature
    Σ_k w_k ⟨g_k, x − x′⟩. Allowed per row: 1e-6 plus 1e-4 of Σ|φ_ig| +
    Σ|φ_idgi|, for f32 sums over F (and IDGI's ⟨g,g⟩ taken twice, in two
    orders) of up to 150,528 terms."""
    si, sg = (r.attributions.flatten(1) for r in (res_idgi, res_ig))
    d = (si.sum(1) - sg.sum(1)).abs()
    lim = 1e-6 + 1e-4 * (si.abs().sum(1) + sg.abs().sum(1))
    print(f"  {name}: |Σφ_idgi − Σφ_ig| max {float(d.max()):.3g}, worst err/limit "
          f"{float((d / lim).max()):.3g}; mean |Σφ_ig| {float(sg.sum(1).abs().mean()):.3g}")
    if not bool((d <= lim).all()):
        raise AssertionError(f"{name}: IDGI's total departs from IG's: {d.tolist()}")


def vit_phase(method: str) -> dict:
    """The paper's explainer with ``method`` on the full-width ViT-S/16
    through the flash kernels, ``VIT_BATCHES`` batches of 16, with gates."""
    from repro_torch.configs.vit import VitConfig
    from repro_torch.core import ig, methods, paths, probes, schedule
    from repro_torch.core.api import Explainer
    from repro_torch.kernels import common
    from repro_torch.models import vit

    cfg = replace(VitConfig(), attn_impl="flash")
    params = vit.init_params(cfg, torch.Generator().manual_seed(0), device=DEV)
    params_cpu = _tree_to(params, "cpu")
    f = lambda xs, t: vit.prob_fn(cfg, params, xs, t)
    ex = Explainer(f, method=method, schedule="paper", m=M, n_int=N_INT, chunk=VIT_CHUNK, device=DEV)
    ex_fused = replace(ex, fused=True)
    unfused, fused = (k + FLASH for k in PATH_KERNELS[ex.spec.accum])
    gen = torch.Generator().manual_seed(1)
    s = cfg.image_size
    paths_launched = {}
    tag = "vit" if method == "ig" else f"vit {method}"
    print(f"ViT slice ({method}): {cfg.name}, {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.num_heads} heads, {cfg.num_patches} patches, attn_impl={cfg.attn_impl}; m={M}, "
          f"n_int={N_INT}, chunk={VIT_CHUNK}, batches of {B}")

    common.reset_launches()  # the slice's own count starts here
    torch.cuda.reset_peak_memory_stats()
    for i in range(VIT_BATCHES):
        x_cpu = torch.rand((B, s, s, cfg.channels), generator=gen)
        t_cpu = torch.randint(0, cfg.num_classes, (B,), generator=gen)
        x, t = x_cpu.to(DEV), t_cpu.to(DEV)
        bl = torch.zeros_like(x)

        sched, probe_ms, l_p = _timed(lambda: ex.build_schedule(x, bl, t))
        _need(paths_launched, f"{tag} probe", l_p, ("flash_fwd",))
        res_u, ms_u, l_u = _timed(lambda: ex.attribute(x, bl, t))
        _need(paths_launched, f"{tag} fixed-m unfused", l_u, unfused)
        res_f, ms_f, l_f = _timed(lambda: ex_fused.attribute(x, bl, t))
        _need(paths_launched, f"{tag} fixed-m fused", l_f, fused)
        for name, res in (("unfused", res_u), ("fused", res_f)):
            if not all(bool(torch.isfinite(v).all()) for v in res):
                raise AssertionError(f"{tag} batch {i} {name}: non-finite result")
            if res.attributions.shape != x.shape:
                raise AssertionError(f"{tag} batch {i} {name}: shape {tuple(res.attributions.shape)}")
        print(f"{tag} batch {i}:")
        _attr_close("fused vs unfused", res_f.attributions, res_u.attributions)
        if not bool(((res_f.delta - res_u.delta).abs() <= _delta_tol(res_u)).all()):
            raise AssertionError(f"{tag} batch {i}: fused δ disagrees with unfused")
        if method == "idgi":  # against ig on the same schedule, through the plain versions
            res_ig = ig.attribute(f, x, bl, sched, t, method="ig", chunk=VIT_CHUNK,
                                  interp_fn=paths.interpolate, accum_fn=methods.riemann_accum)
            _sum_identity("Σφ unfused", res_u, res_ig)
            _sum_identity("Σφ fused", res_f, res_ig)
        print(f"  wall ms: probe {probe_ms:.2f}, unfused {ms_u:.2f}, fused {ms_f:.2f}; probe share "
              f"of unfused {probe_ms / ms_u:.3f}; mean δ {float(res_u.delta.mean()):.3g}, "
              f"mean |f(x) − f(x′)| {float((res_u.f_x - res_u.f_baseline).abs().mean()):.3g}")
        if i == 0:
            print(f"  peak device memory (probe, unfused, fused): "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            (res_a, info), ms_a, l_a = _timed(
                lambda: ex.attribute_adaptive(x, bl, t, tol=TOL, m_max=VIT_M_MAX))
            _need(paths_launched, f"{tag} adaptive", l_a, unfused)
            if not all(bool(torch.isfinite(v).all()) for v in res_a):
                raise AssertionError(f"{tag} adaptive: non-finite result")
            print(f"  adaptive (tol={TOL}, m_max={VIT_M_MAX}): {ms_a:.2f} ms, m_used "
                  f"{info['m_used'].tolist()}, steps {info['total_steps']}")
            for e in (ex, ex_fused):  # one ladder hop == one fixed run over the refined schedule
                _, st, sched = e.start(x, bl, t)
                refined = schedule.refine_nested(sched)
                new = schedule.Schedule(refined.alphas[:, M:], refined.weights[:, M:])
                (res1, _), _, l_hop = _timed(lambda: e.resume(x, bl, t, new, st))
                _need(paths_launched, f"{tag} adaptive hop" + (" fused" if e.fused else ""), l_hop,
                      fused if e.fused else unfused)
                fixed = ig.attribute(f, x, bl, refined, t, method=e.spec, chunk=e.adaptive_chunk,
                                     **e.ig_kwargs())
                if not (torch.equal(res1.attributions, fixed.attributions)
                        and torch.equal(res1.delta, fixed.delta)):
                    raise AssertionError(f"{tag}: resume (fused={e.fused}) not bit-identical")
            print("  resume bit-identical to the fixed run over the refined schedule (unfused, fused)")

            # the card against the port on CPU copies: 2 images at m=16
            x2, t2, b2 = x[:2], t[:2], bl[:2]
            ex2 = replace(ex, m=VIT_CPU_M)
            ex2_cpu = replace(ex2, f=lambda xs, tt: vit.prob_fn(cfg, params_cpu, xs, tt), device="cpu")
            vals = probes.run_probe("boundary", f, x2, b2, t2, n_int=N_INT).vals.cpu()
            vals_cpu = probes.run_probe("boundary", ex2_cpu.f, x2.cpu(), b2.cpu(), t2.cpu(),
                                        n_int=N_INT).vals
            norm = lambda v: schedule.allocate_steps(schedule.normalized_deltas(v), VIT_CPU_M)
            tied = _near_tie_rows(vals_cpu, VIT_CPU_M) | _near_tie_rows(vals, VIT_CPU_M)
            if not bool(((norm(vals) == norm(vals_cpu)).all(-1) | tied).all()):
                raise AssertionError(f"{tag}: card and CPU allocate steps differently off a tie")
            res_g = ex2.attribute(x2, b2, t2)
            t0 = time.perf_counter()
            res_c = ex2_cpu.attribute(x2.cpu(), b2.cpu(), t2.cpu())
            print(f"  card vs CPU (2 images, m={VIT_CPU_M}; CPU run {time.perf_counter() - t0:.1f} s), "
                  f"near-tie rows {torch.nonzero(tied).flatten().tolist()}")
            _attr_close("card vs CPU attributions", res_g.attributions.cpu(), res_c.attributions, ~tied)
            dd = (res_g.delta.cpu() - res_c.delta).abs()
            if not bool(((dd <= _delta_tol(res_c)) | tied).all()):
                raise AssertionError(f"{tag} card vs CPU δ: {dd.tolist()}")
        if i == 1:  # warm: where one explanation's time goes
            _profile(f"{tag} unfused", lambda: ex.attribute(x, bl, t))
            _profile(f"{tag} fused", lambda: ex_fused.attribute(x, bl, t))
    print(f"  peak device memory over the {tag} slice: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return {"launches": dict(common.LAUNCHES), "carry_ranks": dict(common.CARRY_RANKS),
            "per_path": paths_launched}


def zoo_phase() -> dict:
    """Every method on the paper schedule and ig on every schedule family,
    one batch of 16 on the paper CNN, plus the two path ensembles adaptive
    and IDGI fused; gates: finite results of the input's shape, the path's
    kernels launched and no others, IDGI fused close to unfused, and each
    ensemble's result the mean of its sample rows run as plain ig."""
    from repro_torch.configs.paper_cnn import CnnConfig
    from repro_torch.core.api import Explainer
    from repro_torch.core.perturb import PerturbExplainer, cell_fn, cell_scores_to_pixels, image_to_cells
    from repro_torch.kernels import common
    from repro_torch.models.cnn import PaperCNN, init_params

    cfg = CnnConfig()
    model = PaperCNN(cfg, init_params(cfg, torch.Generator().manual_seed(0), device=DEV))
    gen = torch.Generator().manual_seed(2)
    s = cfg.image_size
    x = torch.rand((B, s, s, cfg.channels), generator=gen).to(DEV)
    t = torch.randint(0, cfg.num_classes, (B,), generator=gen).to(DEV)
    bl = torch.zeros_like(x)
    base = Explainer(model.prob, m=M, n_int=N_INT, device=DEV)
    runs = [(m, "paper", False) for m in ("ig", "idgi", "noise_tunnel", "expected_grad")]
    runs += [("ig", sch, False) for sch in ("uniform", "warp", "gauss", "refine")] + [("idgi", "paper", True)]
    paths_launched, out = {}, {}
    print(f"zoo: paper CNN, 1 batch of {B}, m={M}, n_int={N_INT}")

    def check(name, res):
        if res.attributions.shape != x.shape or not all(bool(torch.isfinite(v).all()) for v in res):
            raise AssertionError(f"zoo {name}: non-finite result or shape {tuple(res.attributions.shape)}")

    common.reset_launches()  # the slice's own count starts here
    for method, sch, fused in runs:
        ex = replace(base, method=method, schedule=sch, fused=fused)
        name = f"{method} {sch}" + (" fused" if fused else "")
        res, ms, launched = _timed(lambda: ex.attribute(x, bl, t))
        _need(paths_launched, f"zoo {name}", launched, PATH_KERNELS[ex.spec.accum][fused])
        check(name, res)
        out[name] = res
        print(f"  {name}: {ms:.2f} ms, mean δ {float(res.delta.mean()):.3g}, rows {B * ex.ensemble_size}")
    _attr_close("idgi fused vs unfused", out["idgi paper fused"].attributions,
                out["idgi paper"].attributions)
    for method in ("noise_tunnel", "expected_grad"):
        ex = replace(base, method=method)
        row = replace(base, method=ex.spec.row_spec())
        x2, b2, t2, _, n = ex.expand_inputs(x, bl, t)
        rows = Explainer.reduce_result(row.attribute(x2, b2, t2), n)
        _attr_close(f"{method}: the mean of its sample rows", out[f"{method} paper"].attributions,
                    rows.attributions)
        (res_a, info), ms_a, l_a = _timed(lambda: ex.attribute_adaptive(x, bl, t, tol=TOL))
        _need(paths_launched, f"zoo {method} adaptive", l_a, PATH_KERNELS["riemann"][0])
        check(f"{method} adaptive", res_a)
        rows_a, _ = row.attribute_adaptive(x2, b2, t2, tol=TOL)
        _attr_close(f"{method} adaptive: the mean of its sample rows", res_a.attributions,
                    Explainer.reduce_result(rows_a, n).attributions)
        if info["n_samples"] != n or info["m_used"].shape != (B * n,):
            raise AssertionError(f"zoo {method} adaptive: info {info['n_samples']}, {info['m_used'].shape}")
        print(f"  {method} adaptive: {ms_a:.2f} ms, {n} samples a row, m_used mean "
              f"{float(info['m_used'].mean()):.1f}")

    # the forward-only class on the CNN: LIME over 4×4×3 image cells (S=64)
    shape = (s, s, cfg.channels)
    logit = lambda imgs, tt: model.forward(imgs).gather(1, tt[:, None])[:, 0]
    pe = PerturbExplainer(cell_fn(logit, shape, CNN_CELL), method="lime", n_masks=N_MASKS, device=DEV)
    xc = image_to_cells(x, CNN_CELL)
    res, ms, launched = _timed(lambda: pe.attribute(xc, torch.zeros_like(xc), t))
    _need(paths_launched, "zoo lime cells", launched, ("wls_solve",))
    px = cell_scores_to_pixels(res.attributions, shape, CNN_CELL)
    if (res.attributions.shape != xc.shape[:2] or px.shape != x.shape
            or not all(bool(torch.isfinite(v).all()) for v in res)):
        raise AssertionError(f"zoo lime cells: non-finite result or shape {tuple(res.attributions.shape)}")
    print(f"  lime over {xc.shape[1]} cells of {CNN_CELL}×{CNN_CELL}×{cfg.channels}: {ms:.2f} ms, "
          f"{N_MASKS} masks a row, mean |score| {float(res.attributions.abs().mean()):.3g}")
    return {"launches": dict(common.LAUNCHES), "carry_ranks": dict(common.CARRY_RANKS),
            "per_path": paths_launched}


def _perturb_close(name: str, got, want, amp: torch.Tensor) -> None:
    """Scores of the card (``got``) against the port on the CPU (``want``),
    per row: within 1e-4 of the row's largest |score| plus 10·amp·ε, where ε
    is the larger of the endpoint f-values' card-vs-CPU gap and 1e-7 of
    their size (the noise of one f-value in f32 GEMMs summed in another
    order), and amp how far a method's scores carry that noise to first
    order: 2 for occlusion and RISE (a difference of f-values, or of their
    means), P·√N·‖(A+λI)⁻¹‖₂ for LIME (β = (A+λI)⁻¹ XᵀW y with x ∈ {0, 1}
    and w ≤ 1, so ‖XᵀW‖₂ ≤ √(P·N), and ‖δy‖₂ ≤ √P·ε)."""
    gap = torch.maximum((got.f_x.cpu() - want.f_x).abs(), (got.f_baseline.cpu() - want.f_baseline).abs())
    eps = torch.maximum(gap, 1e-7 * torch.maximum(want.f_x.abs(), want.f_baseline.abs()))
    d = (got.attributions.cpu() - want.attributions).abs().amax(1)
    lim = 1e-4 * want.attributions.abs().amax(1) + 10 * amp * eps + 1e-12
    print(f"  {name}: max row err {float(d.max()):.3g}, worst err/limit {float((d / lim).max()):.3g}, "
          f"endpoint f gap {float(gap.max()):.3g}, amplification {[round(float(a), 1) for a in amp]}")
    if not bool((d <= lim).all()):
        raise AssertionError(f"{name}: rows {torch.nonzero(d > lim).flatten().tolist()} disagree")


def vit_fwd_phase() -> dict:
    """The forward-only class through ``PerturbExplainer`` on the full-width
    ViT-S/16 over its patch features, ``VIT_BATCHES`` batches of 16, with
    gates (phase 8)."""
    from repro_torch.configs.vit import VitConfig
    from repro_torch.core.perturb import PerturbExplainer
    from repro_torch.kernels import common
    from repro_torch.kernels.lstsq import ops as lo
    from repro_torch.models import vit

    cfg = replace(VitConfig(), attn_impl="flash")
    params = vit.init_params(cfg, torch.Generator().manual_seed(0), device=DEV)
    params_cpu = _tree_to(params, "cpu")

    def logit_fn(p):
        def f(fe, t):
            h = vit.encode(cfg, p, vit.embed_features(cfg, p, fe))
            return vit.pool_logits(cfg, p, h).gather(1, t[:, None])[:, 0]
        return f

    f, f_cpu = logit_fn(params), logit_fn(params_cpu)
    gen = torch.Generator().manual_seed(1)
    s = cfg.image_size
    paths_launched = {}
    kernels = {"lime": ("flash_fwd", "wls_solve"), "occlusion": ("flash_fwd",), "rise": ("flash_fwd",)}
    print(f"forward-only ViT slice: {cfg.name}, {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.num_patches} patch positions of {cfg.patch_dim} features, attn_impl={cfg.attn_impl}; "
          f"n_masks={N_MASKS}, chunk={VIT_CHUNK} ({B * VIT_CHUNK} images a forward), batches of {B}")
    batches = []
    for _ in range(VIT_BATCHES):
        imgs = torch.rand((B, s, s, cfg.channels), generator=gen)
        t_cpu = torch.randint(0, cfg.num_classes, (B,), generator=gen)
        batches.append((vit.patchify(cfg, imgs.to(DEV)), t_cpu.to(DEV)))

    common.reset_launches()  # the slice's own count starts here
    torch.cuda.reset_peak_memory_stats()
    for method, names in kernels.items():
        pe = PerturbExplainer(f, method=method, n_masks=N_MASKS, chunk=VIT_CHUNK, device=DEV)
        walls = []
        for i, (x, t) in enumerate(batches):
            bl = torch.zeros_like(x)
            res, ms, launched = _timed(lambda: pe.attribute(x, bl, t))
            _need(paths_launched, f"vit {method}", launched, names)
            walls.append(ms)
            if res.attributions.shape != x.shape[:2] or not all(bool(torch.isfinite(v).all()) for v in res):
                raise AssertionError(f"vit {method} batch {i}: non-finite result or shape "
                                     f"{tuple(res.attributions.shape)}")
            again = pe.attribute(x, bl, t)
            if not all(torch.equal(a, b) for a, b in zip(again, res)):
                raise AssertionError(f"vit {method} batch {i}: a replayed call is not bit-identical")
            if i == 0:  # the card against the port on CPU copies: 2 images at P=16, the same masks
                small = replace(pe, n_masks=CPU_MASKS)
                systems = []  # LIME's normal equations, the card's then the CPU's

                def recording(A, rhs, **kw):
                    systems.append((A.cpu(), rhs.cpu(), kw["ridge"]))
                    return lo.wls_solve(A, rhs, **kw)

                res_g = replace(small, solve_fn=recording).attribute(x[:2], bl[:2], t[:2])
                t0 = time.perf_counter()
                res_c = replace(small, f=f_cpu, device="cpu", solve_fn=recording).attribute(
                    x[:2].cpu(), bl[:2].cpu(), t[:2].cpu())
                print(f"  card vs CPU ({method}, 2 images, P={CPU_MASKS}; CPU run "
                      f"{time.perf_counter() - t0:.1f} s):")
                amp = torch.full((2,), 2.0)
                if method == "lime":
                    (A_g, b_g, ridge), (A_c, b_c, _) = systems
                    eps = float(max((res_g.f_x.cpu() - res_c.f_x).abs().max(),
                                    (res_g.f_baseline.cpu() - res_c.f_baseline).abs().max(), 1e-7))
                    # A: mask counts times exp weights; b: P weighted f-values (x, w ≤ 1)
                    _check("lime XᵀWX card vs CPU", _err(A_g, A_c), 1e-5 * float(A_c.abs().max()))
                    _check("lime XᵀWy card vs CPU", _err(b_g, b_c), 10 * CPU_MASKS * eps)
                    inv = torch.linalg.inv(A_c.double() + ridge * torch.eye(A_c.shape[-1], dtype=torch.float64))
                    amp = CPU_MASKS * A_c.shape[-1] ** 0.5 * torch.linalg.matrix_norm(inv, ord=2).float()
                _perturb_close(f"{method} card vs CPU scores", res_g, res_c, amp)
            if i == 1:  # warm: where one explanation's time goes
                _profile(f"vit {method}", lambda: pe.attribute(x, bl, t))
        print(f"  {method}: wall ms per batch of {B}: {', '.join(f'{w:.2f}' for w in walls)}; "
              f"replay bit-identical; mean |score| {float(res.attributions.abs().mean()):.3g}, "
              f"mean δ {float(res.delta.mean()):.3g}")
    print(f"  peak device memory over the forward-only slice: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return {"launches": dict(common.LAUNCHES), "carry_ranks": dict(common.CARRY_RANKS),
            "per_path": paths_launched}


# ---------------------------------------------------------------- the LM engine

LM_LAYERS = 4  # llama3-8b at full width, depth cut from 32 (PERF.md §4)
LM_SHORT, LM_LONG = (16, 17, 128), (4, 300, 512)  # (requests, shortest, longest prompt)
LM_CHUNK = 16
LM_CPU = (2, 16, 8)  # card vs CPU: prompts, most tokens, m (f32, TF32 off)
ENGINE_TOL = 2e-2  # bf16 rtol, and atol of the row maximum: repro's own fused-vs-unfused tolerance
                   # (test_hotpath.py)
LM_STAGE2 = (16, 16, 128 * 4096)  # the engine's stage-2 shape at S=128: B, chunk, S·d (bf16)
LM_ATTN_SHAPE = (16 * 16, 128, 32, 8, 128)  # (B·chunk, S, NQ, NKV, D) of its attention
BF16_FLOPS = 989e12  # H100 SXM, bf16 on the tensor cores (dense)


def _lm_config():
    from repro_torch.configs import ARCHS

    return replace(ARCHS["llama3-8b"], num_layers=LM_LAYERS)


def _lm_traffic(cfg, groups, seed):
    """Seeded requests: ``groups`` of (count, shortest, longest) lengths."""
    import numpy as np

    from repro_torch.serve import ExplainRequest

    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(lo, hi + 1)) for n, lo, hi in groups for _ in range(n)]
    return [ExplainRequest(rng.integers(1, cfg.vocab_size, s).astype("int32"),
                           int(rng.integers(0, cfg.vocab_size))) for s in lens]


def _reset_peak() -> None:
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else float("nan")


def _served_ok(name: str, out: list, reqs: list) -> None:
    """Finite scores of each request's length, exactly 0 past it."""
    import numpy as np

    for i, (r, q) in enumerate(zip(out, reqs)):
        raw, n = r["raw_token_scores"], len(q.tokens)
        if not (np.isfinite(raw).all() and np.isfinite([r["delta"], r["f_x"], r["f_baseline"]]).all()):
            raise AssertionError(f"engine {name}: request {i} has a non-finite result")
        if r["token_scores"].shape != (n,) or np.any(raw[n:] != 0.0):
            raise AssertionError(f"engine {name}: request {i} is not exactly 0 past its {n} tokens")


def _scores_close(name: str, got: list, want: list, skip=(), gate: bool = True) -> None:
    """Token scores within ENGINE_TOL · (|want| + the request's largest
    |want|) elementwise (bf16): rtol ENGINE_TOL, atol ENGINE_TOL of the row
    maximum, as ``_attr_close`` takes its atol; printed only unless
    ``gate``."""
    import numpy as np

    worst, typical = 0.0, []
    for i, (g, w) in enumerate(zip(got, want)):
        if i in skip:
            continue
        a, b = g["token_scores"], w["token_scores"]
        allowed = ENGINE_TOL * np.abs(b) + ENGINE_TOL * np.abs(b).max()
        worst = max(worst, float((np.abs(a - b) / allowed).max()))
        typical.append(np.abs(b))
    typical = np.concatenate(typical)
    print(f"  {name}: worst err/allowed {worst:.3g} (rtol {ENGINE_TOL}, atol {ENGINE_TOL} of the row's "
          f"largest |score|); |score| median {np.median(typical):.3g}, largest {typical.max():.3g}"
          + (f", rows excluded {sorted(skip)}" if skip else "") + ("" if gate else " (printed, not gated)"))
    if gate and not worst <= 1:
        raise AssertionError(f"{name}: token scores disagree beyond {ENGINE_TOL}")


def engine_phase() -> dict:
    """The port's ``ExplainEngine`` on llama3-8b at full width (4 layers,
    flash attention, bf16 compute, weights drawn on the card) over 20
    seeded requests: ig unfused (then replayed), ig fused, IDGI fused, the
    adaptive ladder and the forward-only class, with gates."""
    import numpy as np

    from repro_torch.core import probes
    from repro_torch.kernels import common
    from repro_torch.kernels.interp_accum.kernel import interp_add_plan
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.serve import ExplainEngine
    from repro_torch.serve.batching import plan_buckets

    cfg = _lm_config()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    _sync()
    print(f"LM engine: {cfg.name} at full width, {cfg.num_layers} layers (of 32), d={cfg.d_model}, "
          f"{cfg.num_heads} heads on {cfg.num_kv_heads}, head dim {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff}, vocabulary {cfg.vocab_size}, {cfg.compute_dtype} compute; "
          f"{cfg.param_count() / 1e9:.3f}B parameters drawn on the card in {time.perf_counter() - t0:.3f} s")
    reqs = _lm_traffic(cfg, (LM_SHORT, LM_LONG), seed=0)
    kw = dict(schedule="paper", m=M, n_int=N_INT, chunk=LM_CHUNK, attn="flash", device=DEV)
    engines = {
        "ig unfused": ExplainEngine(cfg, params, method="ig", **kw),
        "ig fused": ExplainEngine(cfg, params, method="ig", fused=True, **kw),
        "idgi fused": ExplainEngine(cfg, params, method="idgi", fused=True, **kw),
        "ig adaptive": ExplainEngine(cfg, params, method="ig", adaptive=True, tol=TOL,
                                     m_max=VIT_M_MAX, **kw),
        **{m: ExplainEngine(cfg, params, method=m, n_masks=N_MASKS, **kw)
           for m in ("occlusion", "rise", "lime")},
    }
    kernels = {
        "ig unfused": PATH_KERNELS["riemann"][0] + FLASH,
        "ig fused": PATH_KERNELS["riemann"][1] + FLASH,
        "idgi fused": PATH_KERNELS["idgi"][1] + FLASH,
        "ig adaptive": PATH_KERNELS["riemann"][0] + FLASH,
        "occlusion": ("flash_fwd",), "rise": ("flash_fwd",), "lime": ("flash_fwd", "wls_solve"),
    }
    plan = plan_buckets(reqs)
    print(f"  traffic: {len(reqs)} requests of {min(len(r.tokens) for r in reqs)}–"
          f"{max(len(r.tokens) for r in reqs)} tokens in buckets (B×S) "
          f"{[f'{bb.bucket[0]}x{bb.bucket[1]}' for bb in plan]}; m={M}, n_int={N_INT}, chunk={LM_CHUNK}, "
          f"{N_MASKS} masks")
    sms = common.sm_count(torch.device(DEV)) if DEV == "cuda" else 132
    for bb in plan:
        Bb, F = bb.bucket[0], bb.bucket[1] * cfg.d_model
        print(f"  plans at B={Bb} F={F} bf16: K-sums and interpolate (BLOCK_F, num_warps) "
              f"{common.sweep_tile(Bb, F, torch.bfloat16, sms)}, interp_add "
              f"{interp_add_plan(Bb, F, torch.bfloat16, False, sms)} broadcast, "
              f"{interp_add_plan(Bb, F, torch.bfloat16, True, sms)} per step, idgi_dots "
              f"{tuple(common.dots_plan(Bb, LM_CHUNK, F, torch.bfloat16, sms))}")

    paths_launched, outs = {}, {}
    common.reset_launches()  # the slice's own count starts here
    _reset_peak()
    for name, eng in engines.items():
        # round 0 (callables built, Triton's bf16 variants compiled), then the
        # same traffic again: no new miss, the same bits, the warm walls
        out, ms0, launched = _timed(lambda: eng.explain(reqs, return_raw=True))
        _need(paths_launched, f"engine {name}", launched, kernels[name])
        _served_ok(name, out, reqs)
        misses, before = eng.stats.misses, {b: (s.total_s, s.calls) for b, s in eng.stats.buckets.items()}
        again, ms, launched = _timed(lambda: eng.explain(reqs, return_raw=True))
        _need(paths_launched, f"engine {name} replay", launched, kernels[name])
        if eng.stats.misses != misses:
            raise AssertionError(f"engine {name} replay: {eng.stats.misses - misses} new misses")
        for i, (a, b) in enumerate(zip(again, out)):
            if not all(np.array_equal(a[k], b[k]) for k in a):
                raise AssertionError(f"engine {name} replay: request {i} not bit-identical")
        outs[name] = out
        per_bucket = ", ".join(
            f"{b[0]}x{b[1]} {(st.total_s - before[b][0]) * 1e3 / (st.calls - before[b][1]):.1f}"
            for b, st in sorted(eng.stats.buckets.items(), key=lambda kv: kv[0][1]))
        print(f"  {name}: {ms:.1f} ms for {len(reqs)} requests warm ({ms0:.1f} ms in round 0); replay "
              f"bit-identical, no new miss (misses {misses}, hits {eng.stats.hits}); warm ms per "
              f"bucket call (B×S): {per_bucket}; mean δ {np.mean([r['delta'] for r in out]):.4g}, mean "
              f"|f(x) − f(x′)| {np.mean([abs(r['f_x'] - r['f_baseline']) for r in out]):.4g}, mean |δ| / "
              f"|f(x) − f(x′)| {np.mean([abs(r['delta']) / max(abs(r['f_x'] - r['f_baseline']), 1e-12) for r in out]):.4g}")
    ast = engines["ig adaptive"].stats.adaptive
    print(f"  ig adaptive (tol={TOL}, m_max={VIT_M_MAX}), both rounds: mean m_used {ast.mean_m_used:.1f}, "
          f"m_used {dict(sorted(ast.m_used.items()))}, converged {ast.converged} of {ast.requests}, "
          f"hop calls {ast.hop_calls}, steps {ast.total_steps} (launched {ast.launched_steps})")
    print(f"  peak device memory over the paths: {_peak_gb():.2f} GB")
    eng = engines["ig unfused"]
    _scores_close("ig fused vs unfused", outs["ig fused"], outs["ig unfused"])

    # a mixed-length bucket against its requests served one by one; rows whose
    # schedule differs (a bf16 probe value moved a step across an interval
    # boundary) are excluded, as near-tie rows are below
    bb = next(b for b in plan if len(b.indices) > 1)
    single = [eng.explain([reqs[i]], return_raw=True)[0] for i in bb.indices]
    args = eng._bucket_inputs(bb)
    batched = eng._explainer.build_schedule(*args[:3], mask=args[3]).weights.expand(len(bb.lens), -1)
    moved = set()
    for j, i in enumerate(bb.indices):
        one = plan_buckets([reqs[i]])[0]
        a1 = eng._bucket_inputs(one)
        w1 = eng._explainer.build_schedule(*a1[:3], mask=a1[3]).weights.expand(1, -1)
        if not torch.equal(w1[0], batched[j]):
            moved.add(j)
    _scores_close(f"bucket {bb.bucket[0]}x{bb.bucket[1]} vs its {len(bb.indices)} requests one by one",
                  single, [outs["ig unfused"][i] for i in bb.indices], skip=moved)
    _profile("engine ig unfused (warm)", lambda: eng.explain(reqs))

    # the card against the port on the CPU: f32 compute, 2 short prompts
    n_cpu, most, m_cpu = LM_CPU
    cfg32 = replace(cfg, compute_dtype="float32")
    short = _lm_traffic(cfg, ((n_cpu, most // 2, most),), seed=1)
    params_cpu = tree_map(lambda _, t: t.cpu(), params)
    kw32 = dict(method="ig", schedule="paper", m=m_cpu, n_int=N_INT, attn="flash", seq_buckets=(most,))
    eng_g = ExplainEngine(cfg32, params, device=DEV, **kw32)
    eng_c = ExplainEngine(cfg32, params_cpu, device="cpu", **kw32)
    res_g = eng_g.explain(short)
    t0 = time.perf_counter()
    res_c = eng_c.explain(short)
    cpu_s = time.perf_counter() - t0
    bb32 = plan_buckets(short, seq_buckets=(most,))[0]
    vals = [probes.run_probe("boundary", e._explainer.f, *a[:3], n_int=N_INT, mask=a[3]).vals.cpu()
            for e in (eng_g, eng_c) for a in (e._bucket_inputs(bb32),)]
    tied = (_near_tie_rows(vals[0], m_cpu) | _near_tie_rows(vals[1], m_cpu))[: n_cpu]
    print(f"  card vs CPU ({n_cpu} prompts of {[len(r.tokens) for r in short]} tokens, m={m_cpu}, f32, "
          f"TF32 off; CPU run {cpu_s:.1f} s): near-tie rows {torch.nonzero(tied).flatten().tolist()}, "
          f"f(x) gap {max(abs(g['f_x'] - c['f_x']) for g, c in zip(res_g, res_c)):.3g}")
    got = torch.nn.utils.rnn.pad_sequence([torch.from_numpy(r["token_scores"]) for r in res_g], True)
    want = torch.nn.utils.rnn.pad_sequence([torch.from_numpy(r["token_scores"]) for r in res_c], True)
    _attr_close("card vs CPU token scores", got, want, ~tied)
    print(f"  peak device memory over the LM engine phase: {_peak_gb():.2f} GB")
    return {"launches": dict(common.LAUNCHES), "carry_ranks": dict(common.CARRY_RANKS),
            "per_path": paths_launched}


# ---------------------------------------------------------------- the caches

CACHE_BUDGET = 256 * 2**20  # the result cache's byte budget
CACHE_NEW = (4, 17, 128)  # round 2's new requests: count, shortest, longest prompt
TUNE_ROUNDS = 2  # timed calls a tuner candidate, after one warm call
HOP_ZERO_MIN = 4  # base-rung observations before hop-zero moves a start
WARM_CHILD_S = 600  # each warm-state child's time limit


def _cache_dir() -> Path:
    """The phase's files, under the git-ignored ``build/``."""
    import shutil

    d = ROOT / "build" / "cache_phase"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def _same_results(name: str, got: list, want: list) -> None:
    """Result dicts equal key for key, arrays bit for bit."""
    import numpy as np

    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if g.keys() != w.keys() or not all(
                np.array_equal(g[k], w[k]) if isinstance(g[k], np.ndarray) else g[k] == w[k] for k in g):
            raise AssertionError(f"{name}: request {i} differs")


_ROUND_FIELDS = ("delta", "f_x", "f_baseline", "threshold", "m_used", "hops", "converged", "degraded")


def _save_round(path: Path, out: list) -> None:
    """One round's results as arrays (``_round_equal`` reads them)."""
    import numpy as np

    arrays = {f"scores_{i}": r["token_scores"] for i, r in enumerate(out)}
    arrays |= {f"raw_{i}": r["raw_token_scores"] for i, r in enumerate(out)}
    arrays |= {k: np.asarray([r[k] for r in out]) for k in _ROUND_FIELDS}
    np.savez(path, **arrays)


def _round_equal(path: Path, out: list) -> tuple[bool, str]:
    """(every array and field of ``out`` equal to the saved round's bit for
    bit, the first difference)."""
    import numpy as np

    with np.load(path) as saved:
        if len(out) != len([k for k in saved.files if k.startswith("scores_")]):
            return False, f"{len(out)} results against {len(saved.files)} arrays"
        for i, r in enumerate(out):
            for k, name in (("token_scores", "scores"), ("raw_token_scores", "raw")):
                if not np.array_equal(r[k], saved[f"{name}_{i}"]):
                    return False, f"request {i} {k}"
        for k in _ROUND_FIELDS:
            if not np.array_equal(np.asarray([r[k] for r in out]), saved[k]):
                return False, k
    return True, ""


def _adaptive_engine(cfg, params):
    """The warm-state part's engine, the same in the parent and its children."""
    from repro_torch.serve import ExplainEngine

    return ExplainEngine(cfg, params, method="ig", schedule="paper", m=M, n_int=N_INT, chunk=LM_CHUNK,
                         attn="flash", adaptive=True, tol=TOL, m_max=VIT_M_MAX, hop_zero=True,
                         hop_zero_min=HOP_ZERO_MIN, device=DEV)


def _cache_parent(out_dir: Path, paths_launched: dict) -> dict:
    """Parts A–D of ``cache_phase`` in this process; returns what the
    warm-state children are held to."""
    import numpy as np

    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.serve import ExplainEngine, autotune_engine, save_warm_state
    from repro_torch.serve.batching import plan_buckets

    cfg = _lm_config()
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    reqs = _lm_traffic(cfg, (LM_SHORT, LM_LONG), seed=0)
    kw = dict(method="ig", schedule="paper", m=M, n_int=N_INT, attn="flash", device=DEV)
    ig_path = PATH_KERNELS["riemann"][0] + FLASH

    # A. the model fingerprint, hashed leaf by leaf from the card
    eng = ExplainEngine(cfg, params, chunk=LM_CHUNK, result_cache=CACHE_BUDGET, **kw)
    sizes = []
    tree_map(lambda _, t: sizes.append(t.numel() * t.element_size()), eng.params)
    nbytes = sum(sizes)
    _sync()
    t0 = time.perf_counter()
    fingerprint = eng.model_fingerprint
    fp_ms = (time.perf_counter() - t0) * 1e3
    print(f"  A. model_fingerprint {fingerprint[:16]}…: {fp_ms:.1f} ms for {nbytes / 1e9:.3f} GB of "
          f"{cfg.param_dtype} weights ({nbytes / fp_ms / 1e6:.3f} GB/s: each leaf streamed to the host through pinned buffers and hashed)")

    # B. the result cache: 20 misses, then the 20 in another order (hits) and 4 new
    out1, ms1, launched = _timed(lambda: eng.explain(reqs, return_raw=True))
    _need(paths_launched, "cache: round 1, all misses", launched, ig_path)
    if (eng.stats.result_hits, eng.stats.result_misses) != (0, len(reqs)):
        raise AssertionError(f"cache round 1: hits/misses {eng.stats.result_hits}/{eng.stats.result_misses}")
    _served_ok("cache round 1", out1, reqs)
    order = np.random.default_rng(5).permutation(len(reqs))
    new = _lm_traffic(cfg, (CACHE_NEW,), seed=2)
    round2 = [reqs[i] for i in order] + new
    out2, ms2, launched = _timed(lambda: eng.explain(round2, return_raw=True))
    _need(paths_launched, f"cache: round 2, {len(new)} misses", launched, ig_path)
    hm = (eng.stats.result_hits, eng.stats.result_misses)
    if hm != (len(reqs), len(reqs) + len(new)):
        raise AssertionError(f"cache round 2: result hits/misses {hm}, not {len(reqs)}/{len(reqs) + len(new)}")
    _same_results("cache hits vs round 1", out2[: len(reqs)], [out1[i] for i in order])
    fresh = ExplainEngine(cfg, params, chunk=LM_CHUNK, **kw).explain(new, return_raw=True)
    _same_results("cache: the 4 new vs an engine without a cache", out2[len(reqs):], fresh)
    out2[0]["token_scores"][:] = -1.0  # a caller's change never reaches the stored bytes
    _same_results("cache: a hit after the caller changed one", eng.explain([round2[0]], return_raw=True),
                  [out1[order[0]]])
    hits, ms_hit, launched = _timed(lambda: eng.explain(reqs))
    if any(launched.values()):
        raise AssertionError(f"an all-hit round launched {launched}")
    print(f"  B. result cache ({CACHE_BUDGET >> 20} MiB): round 1 {ms1:.1f} ms ({len(reqs)} misses); round 2 "
          f"{ms2:.1f} ms (the {len(reqs)} reordered, all hits, bit-identical to round 1, and {len(new)} new misses, bit-identical "
          f"to an engine without a cache); result hits/misses {hm[0]}/{hm[1]}; a changed hit leaves the "
          f"entry; an all-hit round of {len(reqs)}: {ms_hit:.3f} ms, no launch; {len(eng.result_cache)} "
          f"entries, {eng.result_cache.bytes} bytes, hit rate {eng.stats.result_hit_rate:.3f}")

    # C. the tuner: priced, pruned by memory, measured; then served tuned
    tune_dir = out_dir / "autotune"
    _sync()
    t0 = time.perf_counter()
    report = autotune_engine(eng, reqs, rounds=TUNE_ROUNDS, results_dir=str(tune_dir))
    tune_s = time.perf_counter() - t0
    total = torch.cuda.get_device_properties(0).total_memory if DEV == "cuda" else float("inf")
    print(f"  C. autotune_engine ({report['hw']} model, {TUNE_ROUNDS} timed calls after a warm one, "
          f"{tune_s:.1f} s) -> {report['path']}; predicted by roofline.hotpath_cost:")
    winners = {}
    for key, b in report["buckets"].items():
        bucket = tuple(int(v) for v in key.split("/")[0][1:].split("xS"))
        winners[bucket] = b["winner"]["chunk"]
        for c in b["candidates"]:
            mp = c["measured_peak_bytes"]
            if mp is not None and mp > total:
                raise AssertionError(f"tuner: chunk {c['chunk']} at {bucket} peaked above the card")
            done = (f"pruned: {c['pruned']}" if c["latency_s"] is None else f"{c['latency_s'] * 1e3:.1f} ms"
                    + (f", measured peak {mp / 1e9:.2f} GB" if mp is not None else ""))
            print(f"     {bucket[0]}x{bucket[1]} chunk {c['chunk']:>2}: {c['bytes_accessed'] / 1e9:.2f} GB, "
                  f"{c['flops'] / 1e12:.2f} TFLOP, bound {c['bound_s'] * 1e3:.2f} ms, predicted peak "
                  f"{c['peak_bytes'] / 1e9:.2f} GB; {done}")
        print(f"     {bucket[0]}x{bucket[1]} winner: chunk {winners[bucket]}")
    tuned = ExplainEngine(cfg, params, autotune=True, autotune_dir=str(tune_dir), chunk=LM_CHUNK, **kw)
    outT, msT0, launched = _timed(lambda: tuned.explain(reqs, return_raw=True))
    _need(paths_launched, "cache: autotuned", launched, ig_path)
    misses = tuned.stats.misses
    outT2, msT, _ = _timed(lambda: tuned.explain(reqs, return_raw=True))
    if tuned.stats.misses != misses:
        raise AssertionError(f"autotuned replay: {tuned.stats.misses - misses} new misses")
    _same_results("autotuned replay", outT2, outT)
    for bb in plan_buckets(reqs):
        if tuned._cfg_for(bb.bucket).chunk != winners[bb.bucket]:
            raise AssertionError(f"bucket {bb.bucket} does not run its winner's chunk")
        fixed = ExplainEngine(cfg, params, chunk=winners[bb.bucket], **kw)
        _same_results(f"bucket {bb.bucket} tuned vs chunk {winners[bb.bucket]} engine-wide",
                      fixed.explain([reqs[i] for i in bb.indices], return_raw=True), [outT[i] for i in bb.indices])
    print(f"  autotuned engine: round 0 {msT0:.1f} ms, warm {msT:.1f} ms, no new miss, the same bits; each "
          f"bucket at its winner's chunk, bit-identical to an engine with that chunk engine-wide; model "
          f"bytes and peak per bucket (hotpath_cost): "
          + ", ".join(f"{b[0]}x{b[1]} {s.bytes_accessed / 1e9:.2f} GB / {s.peak_bytes / 1e9:.2f} GB"
                      for b, s in sorted(tuned.stats.buckets.items(), key=lambda kv: kv[0][1])))
    del eng, tuned, fixed, fresh
    _free_card()

    # D. warm state: an adaptive hop-zero engine served until its starting
    # rungs settle (a round moves the δ-history, and a bucket whose
    # observations cross hop_zero_min starts higher in the next round), so
    # that the state saved is the one its last round ran under
    ad = _adaptive_engine(cfg, params)
    buckets = sorted({bb.bucket for bb in plan_buckets(reqs)})
    starts, walls = [{b: ad._hop_zero_m(b) for b in buckets}], []
    _reset_peak()
    while True:
        outA, ms, launched = _timed(lambda: ad.explain(reqs, return_raw=True))
        _need(paths_launched, f"cache: adaptive hop-zero, round {len(walls) + 1}", launched, ig_path)
        walls.append(ms)
        if len(walls) == 1:
            _save_round(out_dir / "parent_round1.npz", outA)  # base-rung starts: the cold child's work
        starts.append({b: ad._hop_zero_m(b) for b in buckets})
        if starts[-1] == starts[-2]:
            break
        if len(walls) == 4:
            raise AssertionError(f"hop-zero starts did not settle in 4 rounds: {starts}")
    peak = _peak_gb()
    warm_dir = out_dir / "warm"
    t0 = time.perf_counter()
    save_warm_state(ad, str(warm_dir))
    save_ms = (time.perf_counter() - t0) * 1e3
    _save_round(out_dir / "parent_round.npz", outA)
    print(f"  D. adaptive hop-zero engine (hop_zero_min {HOP_ZERO_MIN}): rounds "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms, starting rungs before each and after the last "
          f"{starts}; peak {peak:.2f} GB; save_warm_state {save_ms:.1f} ms (the fingerprint included), "
          f"{len(ad._cache)} keys ({sum(k[0] == 'start' for k in ad._cache)} starts, "
          f"{sum(k[0] == 'hop' for k in ad._cache)} hops); rounds 1 and {len(walls)} saved beside the state")
    return {"fingerprint": ad.model_fingerprint, "keys": len(ad._cache), "walls": walls}


def _warm_child(mode: str) -> dict:
    """Run ``chip_smoke.py --warm-child MODE DIR`` and read its JSON line."""
    out_dir = ROOT / "build" / "cache_phase"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--warm-child", mode,
                           str(out_dir / "warm")], capture_output=True, text=True, timeout=WARM_CHILD_S)
    wall = time.perf_counter() - t0
    if proc.returncode:
        print(proc.stdout[-4000:] + proc.stderr[-8000:])
        raise AssertionError(f"the {mode} warm-state child exited {proc.returncode}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["process_s"] = wall
    return res


def warm_child(mode: str, directory: str) -> int:
    """One fresh process of the warm-state part: the parent's model from the
    same seed and its engine, ``load_warm_state`` first when ``mode`` is
    ``restore``, then the parent's last round once; prints one JSON line."""
    from repro_torch.models import lm
    from repro_torch.serve import load_warm_state

    t_start = time.perf_counter()
    cfg = _lm_config()
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    eng = _adaptive_engine(cfg, params)
    reqs = _lm_traffic(cfg, (LM_SHORT, LM_LONG), seed=0)
    _sync()
    t0 = time.perf_counter()
    fingerprint = eng.model_fingerprint
    fp_ms = (time.perf_counter() - t0) * 1e3
    rep, replay_ms = None, 0.0
    if mode == "restore":
        t0 = time.perf_counter()
        rep = load_warm_state(eng, directory)
        replay_ms = (time.perf_counter() - t0) * 1e3
    _reset_peak()
    out, round_ms, _ = _timed(lambda: eng.explain(reqs, return_raw=True))
    ref = "parent_round.npz" if mode == "restore" else "parent_round1.npz"
    equal, first_diff = _round_equal(Path(directory).parent / ref, out)
    print(json.dumps({
        "mode": mode, "fingerprint": fingerprint, "fingerprint_ms": fp_ms, "replay_ms": replay_ms,
        "restored": bool(rep and rep.restored), "via": rep.via if rep else "",
        "executables": rep.executables if rep else 0, "reason": rep.reason if rep else "",
        "round0_ms": round_ms, "misses": eng.stats.misses, "hits": eng.stats.hits, "peak_gb": _peak_gb(),
        "equal": equal, "first_diff": first_diff, "to_round_end_s": time.perf_counter() - t_start,
    }))
    return 0


def cache_phase() -> dict:
    """The caches on the engine phase's llama3-8b (full width, 4 layers,
    flash, bf16; weights drawn on the card from seed 0) over its 20
    requests, m=64: A. the model fingerprint; B. the result cache; C. the
    tuner and an autotuned engine; D. warm state, saved here and restored in
    a fresh process (and a cold one beside it); every gate raises."""
    from repro_torch.kernels import common

    _free_card()
    out_dir = _cache_dir()
    paths_launched = {}
    common.reset_launches()  # the slice's own count starts here
    parent = _cache_parent(out_dir, paths_launched)
    launches = dict(common.LAUNCHES)
    carry = dict(common.CARRY_RANKS)
    _free_card()  # the children need the card's memory
    children = {mode: _warm_child(mode) for mode in ("cold", "restore")}
    walls = parent["walls"]
    for mode, ch in children.items():
        same = 1 if mode == "cold" else len(walls)  # this process's round of the same work
        print(f"  {mode} child (Triton's and the CUDA library's disk caches already filled by this process): "
              f"fingerprint {ch['fingerprint_ms']:.1f} ms, replay {ch['replay_ms']:.1f} ms "
              f"({ch['executables']} keys, via {ch['via'] or '—'}), round 0 {ch['round0_ms']:.1f} ms (this "
              f"process's round {same}, the same work: {walls[same - 1]:.1f} ms), misses {ch['misses']}, hits "
              f"{ch['hits']}, peak {ch['peak_gb']:.2f} GB, equal to that round bit for bit: {ch['equal']}"
              + (f" (first difference: {ch['first_diff']})" if not ch["equal"] else "")
              + f"; {ch['to_round_end_s']:.1f} s from start to the round's end, {ch['process_s']:.1f} s the process")
    r = children["restore"]
    if not (r["restored"] and r["via"] == "replay" and r["executables"] == parent["keys"]):
        raise AssertionError(f"warm restore: {r}")
    if r["fingerprint"] != parent["fingerprint"]:
        raise AssertionError("the restored child's model fingerprint differs from this process's")
    if r["misses"] or not r["equal"]:
        raise AssertionError(f"the restored child's round: {r['misses']} misses, equal={r['equal']} "
                             f"({r['first_diff']})")
    ch = children["cold"]
    if ch["restored"] or not ch["misses"] or not ch["equal"]:
        raise AssertionError(f"the cold child must miss and equal this process's round 1: {ch}")
    return {"launches": launches, "carry_ranks": carry, "per_path": paths_launched}


def _causal_pairs(S: int, kvlen: torch.Tensor) -> int:
    """(query, key) pairs a causal attention with per-row key lengths
    computes over S queries: key k < min(q + 1, kvlen)."""
    q = torch.arange(1, S + 1)
    return int(torch.minimum(q[None, :], kvlen.cpu().long()[:, None]).sum())


def lm_kernel_phase(records: list) -> None:
    """Every stage-2 kernel (both classes, interp_add with both carry
    ranks) and the flash trio at the engine's shapes on the LM (bf16),
    against their plain versions, timed beside their bounds and (flash)
    SDPA on the same bf16 tensors; each kernel's record gains
    ``at_lm_shape``."""
    g = torch.Generator(device=DEV).manual_seed(4)
    by_name = {r["name"]: r for r in records}
    _stage2_timed(g, LM_STAGE2, by_name, "at_lm_shape", "the LM engine's stage-2 shape (S=128 · d=4096)")
    _flash_trio_timed(g, LM_ATTN_SHAPE, by_name, "at_lm_shape", "the LM engine's attention")


def _stage2_timed(g, shape, by_name: dict, into: str, what: str, labels=None) -> None:
    """The stage-2 kernels (both classes, interp_add with both carry ranks;
    only those in ``labels`` if given) at ``shape`` (B, K, F) in bf16 against
    their plain versions on the same tensors, timed beside their bounds and
    library calls; each kernel's record in ``by_name`` gains ``into``."""
    from repro_torch.kernels import common
    from repro_torch.kernels.interp_accum import kernel as k_ia, ref as r_ia
    from repro_torch.kernels.ig_accum import kernel as k_acc, ref as r_acc
    from repro_torch.kernels.interpolate import kernel as k_int, ref as r_int

    Bs, Ks, Fs = shape
    bf = torch.bfloat16
    x, b = (torch.randn(Bs, Fs, generator=g, device=DEV).to(bf) for _ in range(2))
    a = torch.rand(Bs, Ks, generator=g, device=DEV)
    w = a / Ks
    acc = torch.randn(Bs, Fs, generator=g, device=DEV)
    carry = torch.randn(Bs, Fs, generator=g, device=DEV) * 0.01
    grads = torch.randn(Bs, Ks, Fs, generator=g, device=DEV).to(bf)
    steps = torch.randn(Bs, Ks, Fs, generator=g, device=DEV) * 0.01  # IDGI's per-step carry
    diff = x - b
    n, nk = Bs * Fs, Bs * Ks
    specs = [
        dict(name="interpolate", kernel=lambda: k_int.interpolate_triton(x, b, a),
             plain=lambda: r_int.interpolate_ref(x, b, a),
             library=lambda: torch.lerp(b[:, None, :], x[:, None, :], a[:, :, None].to(bf)),
             tol=TOL_BF16 * 8, nbytes=2 * 2 * n + 4 * nk + 2 * n * Ks, flops=n + 2 * n * Ks),
        dict(name="ig_accum", kernel=lambda: k_acc.ig_accum_triton(acc, grads, w),
             plain=lambda: r_acc.ig_accum_ref(acc, grads, w), library=None,
             tol=None, nbytes=2 * 4 * n + 4 * nk + 2 * n * Ks, flops=2 * n * Ks + n),
        dict(name="interp_add", kernel=lambda: k_ia.interp_add_triton(x, b, a, carry),
             plain=lambda: r_ia.interp_add_ref(x, b, a, carry), library=None,
             tol=TOL_BF16 * 8, nbytes=2 * 2 * n + 4 * n + 4 * nk + 2 * n * Ks, flops=n + 3 * n * Ks),
        dict(name="accum_cot", kernel=lambda: k_ia.accum_cot_triton(grads),
             plain=lambda: r_ia.accum_cot_ref(grads), library=lambda: grads.sum(1, dtype=torch.float32),
             tol=None, nbytes=2 * n * Ks + 4 * n, flops=n * Ks),
        # IDGI's kernels: the library call computes ⟨g, diff⟩ only, reading the same bytes
        dict(name="idgi_dots", kernel=lambda: k_acc.idgi_dots_triton(grads, diff),
             plain=lambda: r_acc.idgi_dots_ref(grads, diff),
             library=lambda: torch.bmm(grads, diff[:, :, None]),
             tol=None, nbytes=2 * n * Ks + 2 * n + 2 * 4 * nk, flops=4 * n * Ks),
        dict(name="ig_accum_sq", kernel=lambda: k_acc.ig_accum_sq_triton(acc, grads, w),
             plain=lambda: r_acc.ig_accum_sq_ref(acc, grads, w), library=None,
             tol=None, nbytes=2 * 4 * n + 4 * nk + 2 * n * Ks, flops=3 * n * Ks + n),
        dict(name="interp_add", label="interp_add (per-step carry)",
             kernel=lambda: k_ia.interp_add_triton(x, b, a, steps),
             plain=lambda: r_ia.interp_add_ref(x, b, a, steps), library=None,
             tol=TOL_BF16 * 8, nbytes=2 * 2 * n + 4 * nk + 4 * n * Ks + 2 * n * Ks, flops=n + 3 * n * Ks),
    ]
    keys = ("max_abs_err", "tolerance", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    sms = common.sm_count(torch.device(DEV))
    plan = common.dots_plan(Bs, Ks, Fs, bf, sms)
    print(f"kernels at {what} B={Bs} K={Ks} F={Fs} bf16"
          + (f"; idgi_dots' plan {plan} (F split in {plan.split})" if labels is None or "idgi_dots" in labels
             else "") + ":")
    for s in specs:
        label = s.get("label", s["name"])
        if labels is not None and label not in labels:
            continue
        rec = _measure(dict(s, source="", replaces=""))
        rec_of = by_name[s["name"]]
        if label != s["name"]:
            rec_of = rec_of["per_step_carry"]
        rec_of[into] = {k: rec[k] for k in keys}
        print(f"  {label}: {rec['ms']:.5f} ms, bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}), "
              f"{rec['bound_ms'] / rec['ms']:.3f} of it; plain {rec['plain_ms']:.5f}"
              + (f", library {rec['library_ms']:.5f}" if rec["library_ms"] is not None else ""))
    del x, b, acc, carry, grads, steps, diff


def _flash_trio_timed(g, shape, by_name: dict, into: str, what: str) -> None:
    """The flash trio at ``shape`` (B, S, NQ, NKV, D) in bf16, causal, with
    ragged lengths in (S/2, S], against their plain versions at 3e-2, timed
    beside their bounds at the bf16 rate and SDPA on the same tensors (K/V
    repeated to the query heads, the causal ragged mask as a boolean mask);
    each kernel's record in ``by_name`` gains ``into``."""
    import torch.nn.functional as tnf
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr

    bf = torch.bfloat16
    Bq, S, NQ, NKV, D = shape
    q, k, v, do, _ = _flash_inputs(g, Bq, S, NQ, NKV, D, bf, False)
    kvlen = torch.randint(S // 2 + 1, S + 1, (Bq,), generator=g, device=DEV, dtype=torch.int32)
    tol = FLASH_TOL[bf]
    o_ref, lse_ref = fr.flash_fwd_ref(q, k, v, kvlen, causal=True)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, kvlen)
    dk_ref, dv_ref = fr.flash_bwd_dkv_ref(*args, causal=True)
    print(f"flash kernels at {what} B·chunk={Bq} S={S} NQ={NQ} NKV={NKV} D={D} bf16, causal, ragged "
          f"kvlen in [{int(kvlen.min())}, {int(kvlen.max())}]:")
    o, lse = fk.flash_fwd_cuda(q, k, v, kvlen, causal=True)
    dk, dv = fk.flash_bwd_dkv_cuda(*args, causal=True)
    errs = {"flash_fwd": max(_flash_close("flash_fwd o", o, o_ref, tol)[0],
                             _flash_close("flash_fwd lse", lse, lse_ref, tol)[0]),
            "flash_bwd_dq": _flash_close("flash_bwd_dq", fk.flash_bwd_dq_cuda(*args, causal=True),
                                         fr.flash_bwd_dq_ref(*args, causal=True), tol)[0],
            "flash_bwd_dkv": max(_flash_close("flash_bwd_dkv dk", dk, dk_ref, tol)[0],
                                 _flash_close("flash_bwd_dkv dv", dv, dv_ref, tol)[0])}
    # SDPA on the same bf16 tensors, K/V expanded to the query heads and the
    # causal ragged mask as a boolean mask (its memory-efficient backend)
    ke, ve = (t.repeat_interleave(NQ // NKV, dim=1) for t in (k, v))
    pos = torch.arange(S, device=DEV)
    allowed = (pos[None, :, None] >= pos[None, None, :]) & (pos[None, None, :] < kvlen[:, None, None].long())
    allowed = allowed[:, None]
    leaves = [t.detach().clone().requires_grad_() for t in (q, ke, ve)]
    backends = [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]
    for backend in backends:  # the first that takes a boolean mask in bf16, forward and backward
        try:
            with sdpa_kernel(backend):
                o_sdpa = tnf.scaled_dot_product_attention(*leaves, attn_mask=allowed)
            torch.autograd.grad(o_sdpa, leaves, do, retain_graph=True)
            break
        except RuntimeError as e:
            print(f"  SDPA backend {backend.name} refused: {str(e).splitlines()[0][:120]}")
    else:
        raise AssertionError(f"no SDPA backend of {[b.name for b in backends]} takes {what}'s bf16 "
                             "inputs with a boolean mask, forward and backward")

    def sdpa_fwd():
        with sdpa_kernel(backend):
            return tnf.scaled_dot_product_attention(q, ke, ve, attn_mask=allowed)

    sdpa_bwd = lambda: torch.autograd.grad(o_sdpa, leaves, do, retain_graph=True)
    print(f"  SDPA yardstick: backend {backend.name}, backward node {type(o_sdpa.grad_fn).__name__}, "
          f"max |o − plain| {_err(o_sdpa.detach(), o_ref):.3g}")
    pairs = _causal_pairs(S, kvlen)
    work = pairs * NQ * D
    qb, kvb, rowb = 2 * Bq * NQ * S * D, 2 * Bq * NKV * S * D, 4 * Bq * NQ * S
    flash = [
        dict(name="flash_fwd", kernel=lambda: fk.flash_fwd_cuda(q, k, v, kvlen, causal=True),
             plain=lambda: fr.flash_fwd_ref(q, k, v, kvlen, causal=True), library=sdpa_fwd,
             nbytes=2 * qb + 2 * kvb + rowb, flops=4 * work),
        dict(name="flash_bwd_dq", kernel=lambda: fk.flash_bwd_dq_cuda(*args, causal=True),
             plain=lambda: fr.flash_bwd_dq_ref(*args, causal=True), library=sdpa_bwd,
             nbytes=3 * qb + 2 * kvb + 2 * rowb, flops=6 * work),
        dict(name="flash_bwd_dkv", kernel=lambda: fk.flash_bwd_dkv_cuda(*args, causal=True),
             plain=lambda: fr.flash_bwd_dkv_ref(*args, causal=True), library=sdpa_bwd,
             nbytes=2 * qb + 4 * kvb + 2 * rowb, flops=8 * work),
    ]
    times = {}
    for s in flash:
        t_bytes, t_ops = s["nbytes"] / HBM_BYTES_PER_S, s["flops"] / BF16_FLOPS
        rec = {"max_abs_err": errs[s["name"]], "tolerance": tol, "ms": _cold_ms(s["kernel"]),
               "plain_ms": _cold_ms(s["plain"]), "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations (bf16)",
               "library_ms": _cold_ms(s["library"])}
        by_name[s["name"]][into] = rec
        times[s["name"]] = rec
        print(f"  {s['name']}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, SDPA "
              f"{rec['library_ms']:.4f} ms ({'forward' if s['name'] == 'flash_fwd' else 'backward'}), "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), {rec['bound_ms'] / rec['ms']:.3f} of it")
    pair = times["flash_bwd_dq"]["ms"] + times["flash_bwd_dkv"]["ms"]
    sdpa_b = times["flash_bwd_dq"]["library_ms"]
    print(f"  backward pair {pair:.4f} ms against one SDPA backward {sdpa_b:.4f} ms (ratio "
          f"{pair / sdpa_b:.3f}); forward + backward {pair + times['flash_fwd']['ms']:.4f} ms against "
          f"SDPA's {sdpa_b + times['flash_fwd']['library_ms']:.4f} ms; {pairs} causal pairs a head")


# ------------------------------------------------------------ generation serving

SERVE_TRAFFIC = (16, 128, 64)  # prompts, tokens, new (greedy, then sampled)
SERVE_LONG = (2, 999, 32)  # prompts, tokens, new: flash's ragged last tile
SERVE_TEMP, SERVE_SEEDS = 0.8, (1234, 1234, 1235)
SERVE_CHUNK = 8  # make_decode_chunk steps at the traffic's batch
SERVE_F32 = (2, 16, 8)  # full depth, f32: prompts, tokens, new
SERVE_BF16_LAYERS = 4  # the engine phase's depth: bf16 decode against a fresh forward
SERVE_CPU = (2, 2, 16, 8)  # card vs CPU, f32: layers, prompts, tokens, new
SERVE_BLOCKED = (2, 8192)  # layers, tokens of one prompt over 4096 (the blocked branch)
SERVE_3B = (2, 2, 64, 16)  # internlm2-20b and yi-9b: layers, prompts, tokens, new
LOGIT_TOL_F32 = 1e-4  # of a row's largest |logit|: f32 products summed in another order
# the flash forward at the prefills' attention shapes (B, S, NQ, NKV, D), every key, and at
# the GQA groups of internlm2-20b (48 on 8) and yi-9b (32 on 4), ragged
PREFILL_ATTN = ((16, 128, 32, 8, 128), (2, 999, 32, 8, 128))
GQA_ATTN = ((4, 256, 48, 8, 128), (4, 256, 32, 4, 128))


def _serve_configs():
    """llama3-8b, internlm2-20b and yi-9b at full width, flash attention."""
    from repro_torch.configs import ARCHS

    return tuple(replace(ARCHS[n], attn_impl="flash") for n in ("llama3-8b", "internlm2-20b", "yi-9b"))


def serve_kernel_phase(records: list) -> None:
    """The flash forward at the serve phase's prefill shapes (causal, every
    key, bf16) against its plain version, timed beside its bound at the
    bf16 rate and one SDPA forward on the same tensors; then at the GQA
    groups of internlm2-20b and yi-9b with ragged lengths. The flash
    forward's record gains ``at_prefill_shapes`` and ``at_gqa_groups``."""
    import torch.nn.functional as tnf

    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr

    g = torch.Generator(device=DEV).manual_seed(6)
    bf, tol = torch.bfloat16, FLASH_TOL[torch.bfloat16]
    rec = next(r for r in records if r["name"] == "flash_fwd")
    for shapes, ragged, into in ((PREFILL_ATTN, False, "at_prefill_shapes"),
                                 (GQA_ATTN, True, "at_gqa_groups")):
        rec[into] = {}
        for Bq, S, NQ, NKV, D in shapes:
            q, k, v, _, kvlen = _flash_inputs(g, Bq, S, NQ, NKV, D, bf, ragged)
            print(f"flash forward at B={Bq} S={S} NQ={NQ} NKV={NKV} D={D} bf16, causal, "
                  + (f"ragged kvlen {kvlen.tolist()}:" if ragged else "every key:"))
            o, lse = fk.flash_fwd_cuda(q, k, v, kvlen, causal=True)
            o_ref, lse_ref = fr.flash_fwd_ref(q, k, v, kvlen, causal=True)
            _sync()
            err_o, r_o = _flash_close("flash_fwd o", o, o_ref, tol)
            err_l, r_l = _flash_close("flash_fwd lse", lse, lse_ref, tol)
            out = {"max_abs_err": max(err_o, err_l), "worst_ratio": max(r_o, r_l), "tolerance": tol}
            if not ragged:  # timed at the prefills' own shapes
                ke, ve = (t.repeat_interleave(NQ // NKV, dim=1) for t in (k, v))
                work = _causal_pairs(S, kvlen) * NQ * D
                nbytes = 2 * (2 * Bq * NQ * S * D) + 2 * (2 * Bq * NKV * S * D) + 4 * Bq * NQ * S
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 4 * work / BF16_FLOPS
                out.update(
                    ms=_cold_ms(lambda: fk.flash_fwd_cuda(q, k, v, kvlen, causal=True)),
                    plain_ms=_cold_ms(lambda: fr.flash_fwd_ref(q, k, v, kvlen, causal=True)),
                    bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations (bf16)",
                    library_ms=_cold_ms(lambda: tnf.scaled_dot_product_attention(q, ke, ve, is_causal=True)))
                print(f"  flash_fwd: {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, SDPA forward "
                      f"{out['library_ms']:.4f} ms (its own backend choice, causal, K/V repeated), bound "
                      f"{out['bound_ms']:.4f} ms ({out['bound_by']}), {out['bound_ms'] / out['ms']:.3f} of it")
            rec[into][f"B={Bq} S={S} NQ={NQ} NKV={NKV} D={D}"] = out


def _row_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float, gate: bool = True) -> float:
    """Logits (…, V) within ``tol`` of each row's largest |want|; returns the
    worst ratio of error to that limit."""
    d = (got.float() - want.float()).abs().amax(-1)
    ratio = float((d / (tol * want.float().abs().amax(-1))).max())
    print(f"  {name}: worst |logit err| / ({tol:g} · the row's largest |logit|) = {ratio:.3g}"
          + ("" if gate else " (printed, not gated)"))
    if gate and not ratio <= 1:
        raise AssertionError(f"{name}: logits disagree beyond {tol} of the row maximum")
    return ratio


def _tokens_agree(name: str, got: torch.Tensor, want: torch.Tensor, ref_logits: torch.Tensor,
                  tol: float) -> None:
    """Generated ids equal, except where a row first parts at a near tie of
    the reference logits (top two within 2·tol of the row maximum, which
    two summation orders may break apart); the row is not compared past
    that step."""
    top2 = ref_logits.float().topk(2, dim=-1).values
    tie = ((top2[..., 0] - top2[..., 1]) <= 2 * tol * ref_logits.float().abs().amax(-1)).cpu()
    differ = got.cpu().long() != want.cpu().long()
    first = [int(torch.nonzero(row)[0]) for row in differ if row.any()]
    rows = [b for b in range(differ.shape[0]) if differ[b].any()]
    bad = [(b, t) for b, t in zip(rows, first) if not tie[b, t]]
    print(f"  {name}: {got.numel()} tokens; rows that part at a near tie: {len(rows) - len(bad)}")
    if bad:
        raise AssertionError(f"{name}: tokens differ at (row, step) {bad} with no near tie")


def _generated(paths_launched: dict, path: str, fn, vocab: int, kernels=("flash_fwd",)):
    """One generate: its ids checked, its launches recorded; (ids, ms)."""
    out, ms, launched = _timed(fn)
    _need(paths_launched, path, launched, kernels)
    if out.dtype != torch.int32 or int(out.min()) < 0 or int(out.max()) >= vocab:
        raise AssertionError(f"{path}: ids not int32 in [0, {vocab})")
    return out, ms


def _teacher_forced(model, params, prompts: torch.Tensor, toks: torch.Tensor, max_len: int):
    """Decode logits (B, n, V): the prefill's, then ``decode_step`` fed
    ``toks[:, :-1]``."""
    lg, cache = model.prefill(params, {"tokens": prompts}, max_len)
    out = [lg[:, -1]]
    for j in range(toks.shape[1] - 1):
        lg, cache = model.decode_step(params, cache, toks[:, j:j + 1])
        out.append(lg[:, -1])
    return torch.stack(out, 1)


@torch.no_grad()
def _fresh(model, params, prompts: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """Logits (B, n, V) of one causal forward over prompt + toks[:, :-1] at
    the positions that predict each of ``toks``: a fresh forward over each
    prefix, all at once."""
    full = torch.cat([prompts, toks[:, :-1].to(prompts.dtype)], 1)
    h = model.hidden_from_embeds(params, model.embed_inputs(params, {"tokens": full}))
    return model.logits(params, h[:, prompts.shape[1] - 1:])


def _layers_of(params: dict, n: int) -> dict:
    """The first ``n`` layers of a stacked parameter tree, as views."""
    from repro_torch.models.common import tree_map

    return {**params, "layers": tree_map(lambda _, t: t[:n], params["layers"])}


def _prompts(g, cfg, B: int, S: int) -> torch.Tensor:
    return torch.randint(1, cfg.vocab_size, (B, S), generator=g, device=DEV, dtype=torch.int32)


def serve_phase() -> dict:
    """The port's ``ServeEngine`` on llama3-8b at full width and 32 layers
    (bf16, flash prefill, weights drawn on the card): greedy, sampled
    (seeds 1234, 1234, 1235) and long-prompt generation and a decode
    chunk, with the serve gates, then one greedy generate each on
    internlm2-20b and yi-9b."""
    from repro_torch.kernels import common
    from repro_torch.models import attention, lm
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import Model
    from repro_torch.serve import ServeEngine, make_decode_chunk

    cfg, internlm2, yi = _serve_configs()
    model = Model(cfg)
    paths_launched = {}
    common.reset_launches()  # the slice's own count starts here
    _reset_peak()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    _sync()
    print(f"serve: {cfg.name} at full width and depth, {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.num_heads} heads on {cfg.num_kv_heads}, {cfg.compute_dtype} compute, attn_impl "
          f"{cfg.attn_impl}; {cfg.param_count() / 1e9:.3f}B parameters drawn on the card in "
          f"{time.perf_counter() - t0:.3f} s")

    def gen(path, fn, vocab=cfg.vocab_size, kernels=("flash_fwd",)):
        return _generated(paths_launched, path, fn, vocab, kernels)

    g = torch.Generator(device=DEV).manual_seed(5)
    Bs, S, n_new = SERVE_TRAFFIC
    prompts = _prompts(g, cfg, Bs, S)
    batch = {"tokens": prompts}
    eng = ServeEngine(cfg, params, max_len=S + n_new, device=DEV)
    eng.generate(batch, 2)  # warm: cuBLAS handles and plans
    _, prefill_ms = gen("serve prefill (1 token)", lambda: eng.generate(batch, 1))
    greedy, ms = gen(f"serve greedy {Bs}x{S}+{n_new}", lambda: eng.generate(batch, n_new))
    print(f"  greedy, {Bs} prompts of {S}, {n_new} new: {ms:.1f} ms; prefill {prefill_ms:.1f} ms, decode "
          f"{(ms - prefill_ms) / (n_new - 1):.2f} ms a token (B={Bs}), {Bs * n_new / ms * 1e3:.0f} tokens/s")
    # gate 1: sampling follows the generator's seed
    sampled = []
    for seed in SERVE_SEEDS:
        gs = torch.Generator(device=DEV).manual_seed(seed)
        out, ms = gen(f"serve sampled T={SERVE_TEMP} seed {seed}",
                      lambda: eng.generate(batch, n_new, generator=gs, temperature=SERVE_TEMP))
        sampled.append(out)
        print(f"  sampled T={SERVE_TEMP}, seed {seed}: {ms:.1f} ms")
    if not torch.equal(sampled[0], sampled[1]) or torch.equal(sampled[0], sampled[2]):
        raise AssertionError("gate 1: the same seed must give the same tokens, another seed others")
    if torch.equal(sampled[0], greedy):
        raise AssertionError(f"gate 1: sampling at T={SERVE_TEMP} gave the greedy tokens")
    print(f"  gate 1: seed {SERVE_SEEDS[0]} twice identical, seed {SERVE_SEEDS[2]} differs in "
          f"{int((sampled[0] != sampled[2]).sum())} of {sampled[0].numel()} tokens; every id in [0, V)")
    Bl, Sl, nl = SERVE_LONG
    long_batch = {"tokens": _prompts(g, cfg, Bl, Sl)}
    eng_long = ServeEngine(cfg, params, max_len=Sl + nl, device=DEV)
    _, long_prefill_ms = gen("serve prefill long (1 token)", lambda: eng_long.generate(long_batch, 1))
    _, ms = gen(f"serve greedy {Bl}x{Sl}+{nl}", lambda: eng_long.generate(long_batch, nl))
    print(f"  greedy, {Bl} prompts of {Sl}, {nl} new: {ms:.1f} ms; prefill {long_prefill_ms:.1f} ms, "
          f"decode {(ms - long_prefill_ms) / (nl - 1):.2f} ms a token (B={Bl})")

    # the scheduler's decode unit at the traffic's batch launches no kernel of the port
    chunk = make_decode_chunk(cfg)
    (_, cache), _, launched = _timed(lambda: model.prefill(params, batch, S + n_new))
    _need(paths_launched, "serve chunk prefill", launched, ("flash_fwd",))
    gc = torch.Generator(device=DEV).manual_seed(7)
    (toks, lps, cache), ms, launched = _timed(lambda: chunk(params, cache, greedy[:, :1], gc, 0.0,
                                                            SERVE_CHUNK))
    _need(paths_launched, "serve decode chunk", launched, ())
    if not torch.equal(toks, greedy[:, 1:1 + SERVE_CHUNK]):
        raise AssertionError("decode chunk at temperature 0 did not give generate's greedy tokens")
    if not (bool(torch.isfinite(lps).all()) and bool((lps <= 0).all())):
        raise AssertionError("decode chunk: log-probabilities not finite or above 0")
    print(f"  decode chunk of {SERVE_CHUNK} at B={Bs}, T=0: {ms:.1f} ms ({ms / SERVE_CHUNK:.2f} a token), "
          f"generate's greedy tokens; mean log-prob {float(lps.mean()):.3f}")
    _profile(f"serve decode chunk ({SERVE_CHUNK} tokens, B={Bs}, T={SERVE_TEMP})",
             lambda: chunk(params, cache, toks[:, -1:], gc, SERVE_TEMP, SERVE_CHUNK))
    del cache

    # bf16 at full depth: decode against a fresh forward, printed only
    _row_close(f"bf16 decode vs fresh forward, {cfg.num_layers} layers, steps 0..{n_new - 1}",
               _teacher_forced(model, params, prompts, greedy, S + n_new),
               _fresh(model, params, prompts, greedy), ENGINE_TOL, gate=False)

    # gate 2: f32 at full depth
    n2, s2, k2 = SERVE_F32
    cfg32 = replace(cfg, compute_dtype="float32")
    m32, p2 = Model(cfg32), _prompts(g, cfg, n2, s2)
    out, _ = gen("serve greedy f32 full depth",
                 lambda: ServeEngine(cfg32, params, s2 + k2, device=DEV).generate({"tokens": p2}, k2))
    tf = _teacher_forced(m32, params, p2, out, s2 + k2)
    fresh = _fresh(m32, params, p2, out)
    _row_close(f"gate 2: f32 decode vs fresh forward, {cfg.num_layers} layers", tf, fresh, LOGIT_TOL_F32)
    if not torch.equal(tf.argmax(-1).to(torch.int32), out):
        raise AssertionError("gate 2: generate's tokens are not the argmax of its decode logits")
    _tokens_agree("gate 2: tokens vs the fresh forward's argmax", out, fresh.argmax(-1), fresh, LOGIT_TOL_F32)

    # gate 3: bf16 at 4 layers, every step of the traffic
    cfg4 = replace(cfg, num_layers=SERVE_BF16_LAYERS)
    m4, params4 = Model(cfg4), _layers_of(params, SERVE_BF16_LAYERS)
    out, _ = gen(f"serve greedy bf16 {SERVE_BF16_LAYERS} layers",
                 lambda: ServeEngine(cfg4, params4, S + n_new, device=DEV).generate(batch, n_new))
    _row_close(f"gate 3: bf16 decode vs fresh forward, {SERVE_BF16_LAYERS} layers, steps 0..{n_new - 1}",
               _teacher_forced(m4, params4, prompts, out, S + n_new), _fresh(m4, params4, prompts, out),
               ENGINE_TOL)

    # gate 4: the card against the CPU (f32, TF32 off)
    nl4, n4, s4, k4 = SERVE_CPU
    cfg_c = replace(cfg, num_layers=nl4, compute_dtype="float32")
    m_c, params_c = Model(cfg_c), _layers_of(params, nl4)
    params_cpu = tree_map(lambda _, t: t.cpu(), params_c)
    p4 = _prompts(g, cfg, n4, s4)
    out_g, _ = gen("serve greedy card vs CPU",
                   lambda: ServeEngine(cfg_c, params_c, s4 + k4, device=DEV).generate({"tokens": p4}, k4))
    t0 = time.perf_counter()
    out_c = ServeEngine(cfg_c, params_cpu, s4 + k4, device="cpu").generate({"tokens": p4.cpu()}, k4)
    tf_c = _teacher_forced(m_c, params_cpu, p4.cpu(), out_c, s4 + k4)
    print(f"  gate 4: {n4} prompts of {s4}, {k4} new, {nl4} layers at full width, f32; CPU "
          f"{time.perf_counter() - t0:.1f} s")
    _tokens_agree("gate 4: card vs CPU tokens", out_g, out_c, tf_c, LOGIT_TOL_F32)
    _row_close("gate 4: card vs CPU decode logits, teacher-forced on the CPU's tokens",
               _teacher_forced(m_c, params_c, p4, out_c.to(DEV), s4 + k4).cpu(), tf_c, LOGIT_TOL_F32)
    del params_cpu, tf_c

    # gate 5: the blocked branch (attn_impl "auto", one prompt over 4096 tokens) against flash
    nl5, s5 = SERVE_BLOCKED
    params5, p5 = _layers_of(params, nl5), {"tokens": _prompts(g, cfg, 1, s5)}
    blocked, calls = attention.blocked_attention, []

    def counted(*a, **kw):
        calls.append(1)
        return blocked(*a, **kw)

    attention.blocked_attention = counted
    try:
        lg_auto, ms_a, launched = _timed(
            lambda: Model(replace(cfg, num_layers=nl5, attn_impl="auto")).prefill(params5, p5, s5)[0])
    finally:
        attention.blocked_attention = blocked
    _need(paths_launched, f"serve prefill {s5} auto (blocked)", launched, ())
    lg_flash, ms_f, launched = _timed(lambda: Model(replace(cfg, num_layers=nl5)).prefill(params5, p5, s5)[0])
    _need(paths_launched, f"serve prefill {s5} flash", launched, ("flash_fwd",))
    if len(calls) != nl5:
        raise AssertionError(f"gate 5: blocked_attention ran {len(calls)} times, not once a layer")
    print(f"  gate 5: one prompt of {s5} tokens, {nl5} layers: prefill blocked {ms_a:.1f} ms "
          f"({len(calls)} calls), flash {ms_f:.1f} ms")
    _row_close("gate 5: blocked vs flash prefill logits (bf16)", lg_auto, lg_flash, ENGINE_TOL)
    print(f"  peak device memory over the llama3-8b runs: {_peak_gb():.2f} GB")
    del params, params4, params5, params_c, eng, eng_long

    # item 3b: internlm2-20b and yi-9b at full width, 2 layers
    nl3, n3, s3, k3 = SERVE_3B
    for c in (internlm2, yi):
        c = replace(c, num_layers=nl3)
        m3 = Model(c)
        p = lm.init_params(c, torch.Generator(device=DEV).manual_seed(0), device=DEV)
        pr = _prompts(g, c, n3, s3)
        out, ms = gen(f"serve greedy {c.name}",
                      lambda: ServeEngine(c, p, s3 + k3, device=DEV).generate({"tokens": pr}, k3),
                      vocab=c.vocab_size)
        print(f"  {c.name} ({c.num_heads} heads on {c.num_kv_heads}, d={c.d_model}, {nl3} layers): "
              f"{n3} prompts of {s3}, {k3} new in {ms:.1f} ms")
        _row_close(f"{c.name}: bf16 decode vs fresh forward", _teacher_forced(m3, p, pr, out, s3 + k3),
                   _fresh(m3, p, pr, out), ENGINE_TOL)
        del p
    print(f"  peak device memory over the serve phase: {_peak_gb():.2f} GB")
    return {"launches": dict(common.LAUNCHES), "carry_ranks": dict(common.CARRY_RANKS),
            "per_path": paths_launched}


# ---------------------------------------------------------------- mixed serving

MIXED_BUCKETS = (32, 64, 128, 512)
MIXED_MAX_LEN, MIXED_CHUNK = 256, 8  # the scheduler's KV cache and decode chunk
MIXED_GEN = (8, 128, 32, 4)  # INTERACTIVE greedy: requests, tokens, new; the first 4 explain=True
MIXED_STREAM = (64, 4)  # one streamed request: tokens, new (attributions over 64–67 tokens)
MIXED_SAMPLED = (2, 128, 32, 0.8, 1234)  # BATCH sampled: requests, tokens, new, temperature, seed
MIXED_EXPLAIN = (8, 17, 128)  # explain-only: requests, shortest, longest
MIXED_LIME = (4, 2, 8)  # the LIME scheduler: explain requests, greedy generates, their new tokens


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def _mixed_traffic(cfg) -> list:
    """The mixed round: greedy INTERACTIVE generates (some with the donated
    endpoint), one streamed request, sampled BATCH generates and
    explain-only requests, in submission order."""
    import numpy as np

    from repro_torch.serve import BATCH, INTERACTIVE, GenerateRequest

    rng = np.random.default_rng(21)
    p = lambda n: rng.integers(1, cfg.vocab_size, n).astype(np.int32)
    n, S, new, n_exp = MIXED_GEN
    gens = [GenerateRequest(p(S), new, slo=INTERACTIVE, explain=i < n_exp) for i in range(n)]
    gens.append(GenerateRequest(p(MIXED_STREAM[0]), MIXED_STREAM[1], slo=INTERACTIVE, explain=True,
                                explain_stream=True))
    nb, Sb, newb, temp, seed = MIXED_SAMPLED
    gens += [GenerateRequest(p(Sb), newb, slo=BATCH, temperature=temp, seed=seed) for _ in range(nb)]
    return gens + _lm_traffic(cfg, (MIXED_EXPLAIN,), seed=3)


def _instrument(sched) -> dict:
    """Record around one scheduler's work items: each item kind's launches,
    the prefill and decode items' walls and tokens, every explain flush's
    entries (ticket, pos, request), each delivered result's raw scores and
    the deepest queue. ``_clear`` empties the record between rounds."""
    from repro_torch.kernels import common

    rec = {}
    run_item, flush, deliver, step = sched._run_item, sched._do_exp_flush, sched._deliver, sched.step

    def run_item_(kind, payload, fn):
        before, t0 = dict(common.LAUNCHES), time.perf_counter()
        n_tok = min(sched.decode_chunk, payload.remaining) if kind == "decode" else 1
        out = run_item(kind, payload, fn)
        wall = time.perf_counter() - t0
        got = rec["launches"].setdefault(kind, dict.fromkeys(before, 0))
        for k, n in _launched(before, common.LAUNCHES).items():
            got[k] += n
        if kind in ("prefill", "decode"):
            grp = payload if kind == "prefill" else payload.group
            rec["walls"].append((kind, grp.prompts.shape[0], wall, n_tok))
        return out

    def flush_(payload):
        rec["flushes"].append([(t, pos, r) for t, pos, _, r in sched._pending_exp])
        flush(payload)

    def deliver_(t, pos, token, r):
        if "raw_token_scores" in r:
            rec["raw"][(t.id, pos)] = r["raw_token_scores"]
        deliver(t, pos, token, r)

    def step_():
        rec["depth"] = max(rec["depth"], sched.queue_depth)
        return step()

    sched._run_item, sched._do_exp_flush, sched._deliver, sched.step = run_item_, flush_, deliver_, step_
    _clear(rec)
    return rec


def _clear(rec: dict) -> None:
    rec.update(launches={}, walls=[], flushes=[], raw={}, depth=0)


def _results_of(t) -> list:
    """A ticket's explain results as (pos, result): -1 for explain-only."""
    return [(-1, t.result)] if t.kind == "explain" else [(a["pos"], a) for a in t.attributions]


def _mixed_ok(name: str, tickets: list, traffic: list, rec: dict, vocab: int) -> None:
    """Every ticket done and not degraded; ids in [0, V), as many as asked;
    one attribution per explained position; finite scores of the request's
    length, exactly 0 past it."""
    import numpy as np

    for t, r in zip(tickets, traffic):
        if t.status != "done" or t.degraded:
            raise AssertionError(f"{name}: ticket {t.id} ({t.kind}) is {t.status}")
        if t.kind == "generate":
            if t.tokens.shape != (r.num_tokens,) or t.tokens.min() < 0 or t.tokens.max() >= vocab:
                raise AssertionError(f"{name}: ticket {t.id}: tokens {t.tokens} not {r.num_tokens} ids in "
                                     f"[0, {vocab})")
            want = list(range(r.num_tokens)) if r.explain_stream else [0] if r.explain else []
            if [a["pos"] for a in t.attributions] != want:
                raise AssertionError(f"{name}: ticket {t.id}: attributions at {[a['pos'] for a in t.attributions]}")
        for pos, res in _results_of(t):
            n, raw = len(r.tokens) + max(pos, 0), rec["raw"][(t.id, pos)]
            if not (np.isfinite(raw).all() and np.isfinite([res["delta"], res["f_x"], res["f_baseline"]]).all()):
                raise AssertionError(f"{name}: ticket {t.id} position {pos}: a non-finite result")
            if res["token_scores"].shape != (n,) or np.any(raw[n:] != 0.0):
                raise AssertionError(f"{name}: ticket {t.id} position {pos}: not exactly 0 past its {n} tokens")


def _same_bits(name: str, got: list, want: list, skip=frozenset()) -> None:
    """Tokens and every explain result equal bit for bit, but the (ticket
    index, pos) entries in ``skip``."""
    import numpy as np

    for i, (g, w) in enumerate(zip(got, want)):
        if g.kind == "generate" and not np.array_equal(g.tokens, w.tokens):
            raise AssertionError(f"{name}: request {i}: tokens {g.tokens} differ from {w.tokens}")
        for (pos, a), (_, b) in zip(_results_of(g), _results_of(w)):
            if (i, pos) not in skip and not all(np.array_equal(a[k], b[k]) for k in b):
                raise AssertionError(f"{name}: request {i} position {pos}: results differ")


def _same_decode(got: tuple, want: tuple) -> bool:
    """Two rounds' (decode logits by position, final cache leaves) equal bit
    for bit."""
    return all(len(g) == len(w) and all(torch.equal(a, b) for a, b in zip(g, w)) for g, w in zip(got, want))


def _latencies(sched) -> str:
    return ", ".join(f"{c} p50 {v['p50_s'] * 1e3:.1f} ms p99 {v['p99_s'] * 1e3:.1f} ms (n={v['n']})"
                     for c, v in sorted(sched.latency_summary().items()))


def _decode_ms(rec: dict, B: int) -> float:
    """Decode wall ms a token of the B-row groups' decode items."""
    walls = [(w, n) for kind, b, w, n in rec["walls"] if kind == "decode" and b == B]
    return sum(w for w, _ in walls) * 1e3 / sum(n for _, n in walls)


def mixed_phase() -> dict:
    """The port's ``MixedScheduler`` on llama3-8b at full width (4 layers,
    flash attention, bf16, weights drawn on the card) over one adaptive
    ``ig`` engine: a mixed round served cold and warm, against
    ``ServeEngine.generate`` and ``ExplainEngine.explain``, preemption,
    injected faults, and a forward-only (LIME) scheduler, with gates."""
    import numpy as np

    from repro_torch.kernels import common
    from repro_torch.models import lm
    from repro_torch.serve import (
        INTERACTIVE,
        ExplainEngine,
        ExplainRequest,
        GenerateRequest,
        MixedScheduler,
        ServeEngine,
    )

    cfg = _lm_config()
    common.reset_launches()  # the slice's own count starts here
    _reset_peak()
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    engine = ExplainEngine(cfg, params, method="ig", schedule="paper", m=M, n_int=N_INT, chunk=LM_CHUNK,
                           adaptive=True, tol=TOL, m_max=VIT_M_MAX, seq_buckets=MIXED_BUCKETS,
                           attn="flash", device=DEV)
    sched = MixedScheduler(engine, max_len=MIXED_MAX_LEN, decode_chunk=MIXED_CHUNK)
    rec = _instrument(sched)
    traffic = _mixed_traffic(cfg)
    V, riemann = cfg.vocab_size, PATH_KERNELS["riemann"][0] + FLASH
    print(f"mixed ({_card() if DEV == 'cuda' else DEV}): MixedScheduler(max_len={MIXED_MAX_LEN}, decode_chunk="
          f"{MIXED_CHUNK}) over ExplainEngine(ig, adaptive, tol={TOL}, m={M}..{VIT_M_MAX}, n_int={N_INT}, chunk="
          f"{LM_CHUNK}, seq_buckets={MIXED_BUCKETS}) on {cfg.name}, {cfg.num_layers} layers, {cfg.compute_dtype}, "
          f"flash; a round of {MIXED_GEN[0]} greedy generates of {MIXED_GEN[1]}+{MIXED_GEN[2]} ({MIXED_GEN[3]} "
          f"explained), 1 streamed of {MIXED_STREAM[0]}+{MIXED_STREAM[1]}, {MIXED_SAMPLED[0]} sampled "
          f"(T={MIXED_SAMPLED[3]}, seed {MIXED_SAMPLED[4]}) of {MIXED_SAMPLED[1]}+{MIXED_SAMPLED[2]}, "
          f"{MIXED_EXPLAIN[0]} explain-only of {MIXED_EXPLAIN[1]}–{MIXED_EXPLAIN[2]} tokens")
    paths_launched = {}

    def serve(s, reqs):
        tickets = [s.submit(r) for r in reqs]
        s.run_until_idle()
        return tickets

    # round 0 builds the callables; the warm replay adds no miss and gives the same bits
    clean, walls = {}, {}
    for rnd in ("round 0", "warm"):
        _clear(rec)
        sched.latencies = {}
        misses = engine.stats.misses
        clean[rnd], walls[rnd], launched = _timed(lambda: serve(sched, traffic))
        _need(paths_launched, f"mixed {rnd}", launched, riemann)
        _mixed_ok(f"mixed {rnd}", clean[rnd], traffic, rec, V)
        print(f"  {rnd}: {walls[rnd]:.1f} ms; misses {engine.stats.misses - misses}, hits {engine.stats.hits}; "
              f"deepest queue {rec['depth']}, preempted {engine.stats.preempted}, degraded "
              f"{engine.stats.degraded}; latency {_latencies(sched)}")
    if engine.stats.misses != misses:
        raise AssertionError(f"mixed warm: {engine.stats.misses - misses} new misses")
    _same_bits("mixed warm vs round 0", clean["warm"], clean["round 0"])
    for kind, names in (("prefill", ("flash_fwd",)), ("decode", ()), ("exp_start", riemann), ("hop", riemann)):
        _need(paths_launched, f"mixed {kind} items", rec["launches"][kind], names)
    warm, flushes = clean["warm"], rec["flushes"]
    decode_mix = _decode_ms(rec, MIXED_GEN[0])
    ast = engine.stats.adaptive
    print(f"  warm round: decode {decode_mix:.2f} ms a token at B={MIXED_GEN[0]} (items' walls); adaptive "
          f"over both rounds: m_used {dict(sorted(ast.m_used.items()))}, hop calls {ast.hop_calls}; "
          f"decode callables {sorted(k for k in sched.decode_stats)}")

    # gate: the greedy tokens are ServeEngine.generate's on the same batch
    n_gen, _, new, n_exp = MIXED_GEN
    prompts = torch.as_tensor(np.stack([r.tokens for r in traffic[:n_gen]]), device=DEV)
    gen_toks, ms, launched = _timed(lambda: ServeEngine(engine.cfg, engine.params, MIXED_MAX_LEN, device=DEV)
                                    .generate({"tokens": prompts}, new))
    _need(paths_launched, "mixed ServeEngine.generate", launched, ("flash_fwd",))
    if not np.array_equal(gen_toks.cpu().numpy(), np.stack([t.tokens for t in warm[:n_gen]])):
        raise AssertionError("mixed: the scheduler's greedy tokens are not ServeEngine.generate's")
    print(f"  gate: the {n_gen} greedy generates' {n_gen * new} tokens equal ServeEngine.generate's "
          f"({ms:.1f} ms there); the sampled ones equal across rounds")

    # gate: each donated f(x) against the engine's own, and the scheduler's
    # attributions are engine.explain's on the same request lists, bit for bit
    donated = [(t, r) for t, r in zip(warm, traffic) if t.kind == "generate" and r.explain]
    own, _, launched = _timed(lambda: engine.explain([ExplainRequest(r.tokens, int(t.tokens[0]))
                                                      for t, r in donated]))
    _need(paths_launched, "mixed engine.explain (own f(x))", launched, riemann)
    gaps = [abs(t.attributions[0]["f_x"] - o["f_x"]) for (t, _), o in zip(donated, own)]
    ratio = max(g / (ENGINE_TOL + ENGINE_TOL * abs(o["f_x"])) for g, o in zip(gaps, own))
    print(f"  donated f(x) vs the engine's own (padded bucket): |gap| {[f'{g:.3g}' for g in gaps]}, worst "
          f"{ratio:.3g} of rtol = atol = {ENGINE_TOL} (bf16)")
    if not ratio <= 1:
        raise AssertionError("mixed: a donated f(x) is beyond 2e-2 of the engine's own")
    climbed = []
    for flush in flushes:
        want, ms, launched = _timed(lambda: engine.explain([r for _, _, r in flush]))
        _need(paths_launched, "mixed engine.explain (the flush)", launched, riemann)
        for (t, pos, r), w in zip(flush, want):
            got = dict(_results_of(t))[pos]
            if not all(np.array_equal(got[k], w[k]) for k in w):
                raise AssertionError(f"mixed: ticket {t.id} position {pos} differs from engine.explain")
            climbed += [r] if w["hops"] else []
        print(f"  gate: {len(flush)} scheduled attributions equal engine.explain's bit for bit ({ms:.1f} ms "
              f"there); {len(climbed)} of them climbed the ladder")

    _profile("mixed warm round", lambda: serve(sched, traffic))

    # decode alone: the same greedy generates, nothing else queued
    _clear(rec)
    alone = serve(sched, [GenerateRequest(r.tokens, r.num_tokens) for r in traffic[:n_gen]])
    _same_bits("mixed alone vs mixed", alone, warm[:n_gen])
    decode_alone = _decode_ms(rec, n_gen)
    print(f"  decode ms a token at B={n_gen}: {decode_mix:.2f} in the mixed round, {decode_alone:.2f} alone "
          f"(ratio {decode_mix / decode_alone:.3f})")

    # preemption: the requests that climbed queue their hops, then generates arrive
    if not climbed:
        raise AssertionError("mixed: no request climbed the ladder, so no hop can be preempted")
    pre = MixedScheduler(engine, max_len=MIXED_MAX_LEN, decode_chunk=MIXED_CHUNK)
    p0 = engine.stats.preempted
    exp_t = [pre.submit(r) for r in climbed]
    while not any(k == "hop" for _, _, k, _ in pre._heap):
        if not pre.step():
            raise AssertionError("mixed preemption: the ladder converged before a hop was queued")
    gen_t = [pre.submit(GenerateRequest(r.tokens, MIXED_LIME[2])) for r in traffic[:2]]
    pre.run_until_idle()
    if any(t.status != "done" for t in exp_t + gen_t) or engine.stats.preempted == p0:
        raise AssertionError(f"mixed preemption: statuses {[t.status for t in exp_t + gen_t]}, preempted "
                             f"{engine.stats.preempted - p0}")
    print(f"  preemption: {len(gen_t)} generates behind {len(exp_t)} climbing requests' hops: preempted "
          f"{engine.stats.preempted - p0} items")

    # faults: a transient one at the first hop, an exhausted one at the first
    # exp_start bucket, one raised inside a sampled decode chunk's second decode_step
    fired, failed, armed, real_step = [], [], [], lm.decode_step

    def faulty_step(*a, **kw):
        if armed:
            armed[0] += 1
            if armed[0] == 2:
                armed.clear()
                fired.append("inside decode")
                raise RuntimeError("injected fault inside a decode chunk")
        return real_step(*a, **kw)

    def hook(kind, payload):
        if kind == "decode" and payload.group.seed is not None and "decode" not in fired:
            fired.append("decode")
            armed.append(0)
        if kind == "hop" and "hop" not in fired:
            fired.append("hop")
            raise RuntimeError("injected transient hop fault")
        if kind == "exp_start":
            failed.append(payload) if not failed else None
            if payload is failed[0]:
                raise RuntimeError("injected exhausted exp_start fault")

    _clear(rec)
    d0 = engine.stats.degraded
    sched.fault_hook, lm.decode_step = hook, faulty_step
    try:
        faulted, ms, launched = _timed(lambda: serve(sched, traffic))
    finally:
        sched.fault_hook, lm.decode_step = None, real_step
    _need(paths_launched, "mixed faults", launched, riemann)
    (flush,) = rec["flushes"]  # one flush a round: every decode item outranks it
    index = {t.id: i for i, t in enumerate(faulted)}
    lost = {(index[flush[j][0].id], flush[j][1]) for j in failed[0].bb.indices}
    bad = [i for i, t in enumerate(faulted)
           if (t.status == "degraded") != any(j == i for j, _ in lost)]
    if sorted(fired) != ["decode", "hop", "inside decode"] or bad or engine.stats.degraded - d0 != len(lost):
        raise AssertionError(f"mixed faults: fired {fired}, wrong statuses at {bad}, degraded "
                             f"{engine.stats.degraded - d0} for {len(lost)} lost")
    for i, pos in lost:
        res = dict(_results_of(faulted[i]))[pos]
        if not res["degraded"] or np.any(res["token_scores"] != 0):
            raise AssertionError(f"mixed faults: request {i} position {pos} is no zero fallback")
    _same_bits("mixed faults vs the clean round", faulted, warm, skip=lost)
    print(f"  faults ({ms:.1f} ms): the transient hop fault retried and the decode chunk's inner fault "
          f"retried to the clean bits and tokens; the exhausted exp_start bucket {failed[0].bb.bucket} "
          f"degraded exactly its {len(lost)} requests (degraded counter {engine.stats.degraded - d0})")
    print(f"  peak device memory over the gradient scheduler: {_peak_gb():.2f} GB")
    del engine, sched, pre

    # the forward-only scheduler: LIME mask batches wait at the hop rung, decode preempts them
    n_l, n_gen_l, new_l = MIXED_LIME
    lime = ExplainEngine(cfg, params, method="lime", n_masks=N_MASKS, chunk=LM_CHUNK,
                         seq_buckets=MIXED_BUCKETS, attn="flash", device=DEV)
    sl = MixedScheduler(lime, max_len=MIXED_MAX_LEN, decode_chunk=MIXED_CHUNK)
    rec_l = _instrument(sl)
    lime_traffic = _lm_traffic(cfg, ((n_l, MIXED_EXPLAIN[1], MIXED_EXPLAIN[2]),), seed=4) + [
        GenerateRequest(r.tokens, new_l, slo=INTERACTIVE, explain=i == 0) for i, r in enumerate(traffic[:n_gen_l])]

    def lime_round():
        ts = [sl.submit(r) for r in lime_traffic[:n_l]]
        sl.step()  # the explain flush: the mask batches now wait
        ts += [sl.submit(r) for r in lime_traffic[n_l:]]
        sl.run_until_idle()
        return ts

    lt, ms, launched = _timed(lime_round)
    _need(paths_launched, "mixed lime", launched, ("flash_fwd", "wls_solve"))
    for kind, names in (("exp_fwd", ("flash_fwd", "wls_solve")), ("prefill", ("flash_fwd",)), ("decode", ())):
        _need(paths_launched, f"mixed lime {kind} items", rec_l["launches"][kind], names)
    _mixed_ok("mixed lime", lt, lime_traffic, rec_l, V)
    if not lime.stats.preempted:
        raise AssertionError("mixed lime: no decode item preempted a waiting mask batch")
    for flush in rec_l["flushes"]:  # the donated request's f(x) is dropped: the masks probe both ends
        for (t, pos, _), w in zip(flush, lime.explain([r for _, _, r in flush])):
            if not all(np.array_equal(dict(_results_of(t))[pos][k], w[k]) for k in w):
                raise AssertionError(f"mixed lime: ticket {t.id} position {pos} differs from lime.explain")
    print(f"  lime scheduler ({N_MASKS} masks, f32 forward): {n_l} explain + {n_gen_l} generate requests in "
          f"{ms:.1f} ms, every attribution lime.explain's bit for bit; preempted {lime.stats.preempted}, degraded {lime.stats.degraded}; latency "
          f"{_latencies(sl)}")
    print(f"  peak device memory over the mixed phase: {_peak_gb():.2f} GB")
    return {"launches": dict(common.LAUNCHES), "carry_ranks": dict(common.CARRY_RANKS),
            "per_path": paths_launched}


# ------------------------------------------------------------------ gemma3-27b

# depth cuts keep the 6k + 2 form: k periods of 5 local + 1 global, then the (L, L) remainder
GEMMA_SERVE_LAYERS = 32  # 5 periods + (L, L): 14.6B parameters, 58.5 GB of f32 weights
GEMMA_ENGINE_LAYERS = 8  # 1 period + (L, L): 18.9 GB
# greedy groups (name, prompts, tokens, new): A prefills below w and wraps in decode, B rolls
# its prefill (shift 2000 mod 1024 = 976), C takes the blocked local path (4 blocks of w)
GEMMA_GROUPS = (("A", 2, 1000, 48), ("B", 2, 2000, 48), ("C", 2, 4096, 32))
GEMMA_GATED = 2048  # groups whose prompt + new fit here are gated against a fresh forward
GEMMA_CPU = (8, 128, 2, 256, 80)  # card vs CPU, f32, reduced widths: layers, seq (w = seq/2), prompts, tokens, new
GEMMA_PREFILL_ATTN = (2, 4096, 32, 16, 128)  # group C's global attention (B, S, NQ, NKV, D)
# (requests, shortest, longest); one request in the 2048 bucket, where 8 rows (2 requests at
# chunk 4) pass 80 GB and 4 rows peak at 65 GB
GEMMA_TRAFFIC = ((4, 17, 128), (2, 300, 512), (1, 1100, 2000))
GEMMA_CHUNK = 4  # engine steps a forward: rows = B · chunk
GEMMA_EXPLAIN_ATTN = (GEMMA_CHUNK, 2048, 32, 16, 128)  # the 2048 bucket's attention (B=1)
GEMMA_STAGE2 = (1, GEMMA_CHUNK, 2048 * 5376)  # the 2048 bucket's stage-2 shape: B, chunk, S·d (bf16)
GEMMA_STAGE2_KERNELS = ("interpolate", "ig_accum", "interp_add", "accum_cot")  # ig unfused and fused
GEMMA_ENGINE_CPU = (8, 16, (11, 30), 8)  # card vs CPU: layers, seq (w=8), prompt lengths, m
GEMMA_MIXED = (2, 1000, 48, 8, 2)  # generates: requests, tokens, new; decode chunk; explain-only requests
GEMMA_FAULT_STEP = 3  # the fault rises at this decode_step of the first chunk from position ≥ w


def _free_card() -> None:
    """Free what earlier phases left in reference cycles (an instrumented
    scheduler's closures hold it, its engine and that engine's weights),
    then the allocator's cached blocks."""
    import gc

    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()


def _gemma_config(layers: int):
    """gemma3-27b at full width and window, ``layers`` deep, flash attention
    for its global layers."""
    from repro_torch.configs import ARCHS

    return replace(ARCHS["gemma3-27b"], num_layers=layers, attn_impl="flash")


def _gemma_narrow(layers: int, seq: int):
    """gemma3-27b at ``reduced`` widths (window seq/2), ``layers`` deep, f32."""
    from repro_torch.configs import ARCHS, reduced

    return replace(reduced(ARCHS["gemma3-27b"], seq=seq), num_layers=layers, compute_dtype="float32",
                   attn_impl="flash")


def gemma_kernel_phase(records: list) -> None:
    """The flash forward at group C's prefill attention (2 × 4096, 32 query
    heads on 16, D=128, bf16, causal, every key) against its plain version,
    timed beside its bound and SDPA's forward; the trio at the engine's 2048
    bucket (B·chunk rows, ragged); and ``local_attention``'s blocked path
    at 2 × 4096 against the masked ``full_attention(window=1024)`` on the
    same bf16 tensors; then the stage-2 kernels of ``ig`` (unfused and
    fused, ``interp_add`` with its broadcast carry) at the 2048 bucket's
    shape against their plain versions. The flash records gain
    ``at_gemma_prefill`` and ``at_gemma_explain``, the stage-2 ones
    ``at_gemma_explain``."""
    import torch.nn.functional as tnf

    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr
    from repro_torch.models.attention import full_attention, local_attention

    g = torch.Generator(device=DEV).manual_seed(9)
    bf, tol = torch.bfloat16, FLASH_TOL[torch.bfloat16]
    by_name = {r["name"]: r for r in records}
    Bq, S, NQ, NKV, D = GEMMA_PREFILL_ATTN
    q, k, v, _, kvlen = _flash_inputs(g, Bq, S, NQ, NKV, D, bf, False)
    print(f"flash forward at gemma3-27b's prefill attention B={Bq} S={S} NQ={NQ} NKV={NKV} D={D} bf16, "
          "causal, every key:")
    o, lse = fk.flash_fwd_cuda(q, k, v, kvlen, causal=True)
    o_ref, lse_ref = fr.flash_fwd_ref(q, k, v, kvlen, causal=True)
    _sync()
    err_o, r_o = _flash_close("flash_fwd o", o, o_ref, tol)
    err_l, r_l = _flash_close("flash_fwd lse", lse, lse_ref, tol)
    del o, lse, o_ref, lse_ref
    ke, ve = (t.repeat_interleave(NQ // NKV, dim=1) for t in (k, v))
    work = _causal_pairs(S, kvlen) * NQ * D
    nbytes = 2 * (2 * Bq * NQ * S * D) + 2 * (2 * Bq * NKV * S * D) + 4 * Bq * NQ * S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 4 * work / BF16_FLOPS
    rec = {"max_abs_err": max(err_o, err_l), "worst_ratio": max(r_o, r_l), "tolerance": tol,
           "ms": _cold_ms(lambda: fk.flash_fwd_cuda(q, k, v, kvlen, causal=True)),
           "plain_ms": _cold_ms(lambda: fr.flash_fwd_ref(q, k, v, kvlen, causal=True)),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations (bf16)",
           "library_ms": _cold_ms(lambda: tnf.scaled_dot_product_attention(q, ke, ve, is_causal=True))}
    by_name["flash_fwd"]["at_gemma_prefill"] = rec
    print(f"  flash_fwd: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, SDPA forward "
          f"{rec['library_ms']:.4f} ms (its own backend choice, causal, K/V repeated), bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), {rec['bound_ms'] / rec['ms']:.3f} of it")
    del ke, ve

    # the local layers' attention (plain PyTorch on the card, as in repro): blocked vs masked
    w = _gemma_config(GEMMA_ENGINE_LAYERS).sliding_window
    ql, kl, vl = (t.transpose(1, 2) for t in (q, k, v))  # the model's (B, S, H, D) layout
    got = local_attention(ql, kl, vl, window=w)
    want = full_attention(ql, kl, vl, causal=True, window=w)
    _sync()
    _flash_close(f"local_attention blocked (S={S} > 2w, w={w}) vs full_attention(window={w}), bf16",
                 got, want, tol)
    print(f"  local_attention: blocked {_cold_ms(lambda: local_attention(ql, kl, vl, window=w)):.4f} ms, "
          f"masked full {_cold_ms(lambda: full_attention(ql, kl, vl, causal=True, window=w)):.4f} ms "
          "(plain PyTorch, no kernel of the port)")
    del q, k, v, ql, kl, vl, got, want
    _flash_trio_timed(g, GEMMA_EXPLAIN_ATTN, by_name, "at_gemma_explain",
                      "gemma3-27b's 2048-token explain bucket")
    _stage2_timed(g, GEMMA_STAGE2, by_name, "at_gemma_explain",
                  "gemma3-27b's 2048-token explain bucket (S=2048 · d=5376)", labels=GEMMA_STAGE2_KERNELS)


def gemma_serve_phase() -> dict:
    """``ServeEngine`` on gemma3-27b at full width and window, 32 layers
    (bf16, flash prefill for the global layers, weights drawn on the card):
    greedy groups A, B, C, gates against a fresh forward, a profiled decode
    chunk after C, then the card against the CPU on a narrow gemma3."""
    from repro_torch.kernels import common
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import Model
    from repro_torch.serve import ServeEngine, make_decode_chunk

    _free_card()
    cfg = _gemma_config(GEMMA_SERVE_LAYERS)
    model = Model(cfg)
    paths_launched = {}
    common.reset_launches()  # the slice's own count starts here
    _reset_peak()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    _sync()
    print(f"gemma serve ({_card() if DEV == 'cuda' else DEV}): {cfg.name} at full width, {cfg.num_layers} "
          f"layers of 62 ({cfg.num_periods} periods of {''.join(s.mixer[0].upper() for s in cfg.pattern)} + "
          f"{''.join(s.mixer[0].upper() for s in cfg.remainder_specs)}), d={cfg.d_model}, {cfg.num_heads} heads "
          f"on {cfg.num_kv_heads}, window {cfg.sliding_window}, vocabulary {cfg.vocab_size} tied, "
          f"{cfg.compute_dtype} compute, attn_impl {cfg.attn_impl} (global layers); "
          f"{cfg.param_count() / 1e9:.3f}B parameters drawn on the card in {time.perf_counter() - t0:.3f} s")

    def gen(path, fn, vocab=cfg.vocab_size, kernels=("flash_fwd",)):
        return _generated(paths_launched, path, fn, vocab, kernels)

    g = torch.Generator(device=DEV).manual_seed(8)
    for name, Bg, S, new in GEMMA_GROUPS:
        prompts = _prompts(g, cfg, Bg, S)
        batch = {"tokens": prompts}
        eng = ServeEngine(cfg, params, max_len=S + new, device=DEV)
        gen(f"gemma serve warm {name}", lambda: eng.generate(batch, 1))  # cuBLAS plans at these shapes
        _, prefill_ms = gen(f"gemma serve prefill {name} (1 token)", lambda: eng.generate(batch, 1))
        out, ms = gen(f"gemma serve greedy {name} {Bg}x{S}+{new}", lambda: eng.generate(batch, new))
        print(f"  group {name}: {Bg} prompts of {S}, {new} new: {ms:.1f} ms; prefill {prefill_ms:.1f} ms, "
              f"decode {(ms - prefill_ms) / (new - 1):.2f} ms a token (B={Bg}), "
              f"{Bg * new / ms * 1e3:.1f} tokens/s; the last position {S + new - 2} is "
              f"{(S + new - 2) // cfg.sliding_window} windows in")
        if S + new <= GEMMA_GATED:
            tf = _teacher_forced(model, params, prompts, out, S + new)
            fresh = _fresh(model, params, prompts, out)
            _row_close(f"group {name}: bf16 decode vs fresh forward, steps 0..{new - 1}", tf, fresh, ENGINE_TOL)
            if not torch.equal(tf.argmax(-1).to(torch.int32), out):
                raise AssertionError(f"group {name}: generate's tokens are not the argmax of its decode logits")
            _tokens_agree(f"group {name}: tokens vs the fresh forward's argmax", out, fresh.argmax(-1), fresh,
                          ENGINE_TOL)
            del tf, fresh
        else:  # timed: a decode chunk after the prefill, then one profiled
            chunk = make_decode_chunk(cfg)
            (_, cache), _, launched = _timed(lambda: model.prefill(params, batch, S + new))
            _need(paths_launched, f"gemma serve chunk prefill {name}", launched, ("flash_fwd",))
            gc = torch.Generator(device=DEV).manual_seed(7)
            (toks, _, cache), cms, launched = _timed(lambda: chunk(params, cache, out[:, :1], gc, 0.0, SERVE_CHUNK))
            _need(paths_launched, f"gemma serve decode chunk {name}", launched, ())
            if not torch.equal(toks, out[:, 1:1 + SERVE_CHUNK]):
                raise AssertionError(f"group {name}: the decode chunk at T=0 did not give generate's tokens")
            print(f"  group {name}: decode chunk of {SERVE_CHUNK} at B={Bg}: {cms:.1f} ms "
                  f"({cms / SERVE_CHUNK:.2f} a token), generate's greedy tokens")
            _profile(f"gemma decode chunk ({SERVE_CHUNK} tokens after {S}, B={Bg})",
                     lambda: chunk(params, cache, toks[:, -1:], gc, 0.0, SERVE_CHUNK))
            del cache
        del eng
    print(f"  peak device memory over the {cfg.num_layers}-layer runs: {_peak_gb():.2f} GB")
    del params

    # the card against the CPU on a narrow gemma3: f32, TF32 off, a prompt past 2w, decode wrapping
    nl, seq, n_p, S, new = GEMMA_CPU
    cfg_n = _gemma_narrow(nl, seq)
    m_n = Model(cfg_n)
    p_card = lm.init_params(cfg_n, torch.Generator(device=DEV).manual_seed(1), device=DEV)
    p_cpu = tree_map(lambda _, t: t.cpu(), p_card)
    prompts = _prompts(g, cfg_n, n_p, S)
    out_g, _ = gen("gemma serve card vs CPU",
                   lambda: ServeEngine(cfg_n, p_card, S + new, device=DEV).generate({"tokens": prompts}, new),
                   vocab=cfg_n.vocab_size)
    t0 = time.perf_counter()
    out_c = ServeEngine(cfg_n, p_cpu, S + new, device="cpu").generate({"tokens": prompts.cpu()}, new)
    tf_c = _teacher_forced(m_n, p_cpu, prompts.cpu(), out_c, S + new)
    print(f"  card vs CPU: narrow gemma3 (d={cfg_n.d_model}, {cfg_n.num_heads} heads on {cfg_n.num_kv_heads}, "
          f"window {cfg_n.sliding_window}, {nl} layers), {n_p} prompts of {S}, {new} new, f32; CPU "
          f"{time.perf_counter() - t0:.1f} s")
    _tokens_agree("gemma card vs CPU tokens", out_g, out_c, tf_c, LOGIT_TOL_F32)
    _row_close("gemma card vs CPU decode logits, teacher-forced on the CPU's tokens",
               _teacher_forced(m_n, p_card, prompts, out_c.to(DEV), S + new).cpu(), tf_c, LOGIT_TOL_F32)
    print(f"  peak device memory over the gemma serve phase: {_peak_gb():.2f} GB")
    return {"launches": dict(common.LAUNCHES), "carry_ranks": dict(common.CARRY_RANKS),
            "per_path": paths_launched}


def gemma_engine_phase() -> dict:
    """``ExplainEngine`` on gemma3-27b at full width, 8 layers (bf16, flash
    for the global layer, weights drawn on the card) over 7 seeded requests
    up to the 2048 bucket, where the window masks inside the gradient path:
    ``ig`` unfused and fused, each served twice, with gates."""
    import numpy as np

    from repro_torch.core import probes
    from repro_torch.kernels import common
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.serve import ExplainEngine, ExplainRequest
    from repro_torch.serve.batching import DEFAULT_SEQ_BUCKETS, plan_buckets

    _free_card()
    cfg = _gemma_config(GEMMA_ENGINE_LAYERS)
    common.reset_launches()  # the slice's own count starts here
    _reset_peak()
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    buckets = DEFAULT_SEQ_BUCKETS + (2048,)
    reqs = _lm_traffic(cfg, GEMMA_TRAFFIC, seed=5)
    kw = dict(method="ig", schedule="paper", m=M, n_int=N_INT, chunk=GEMMA_CHUNK, attn="flash",
              seq_buckets=buckets, device=DEV)
    engines = {"ig unfused": ExplainEngine(cfg, params, **kw),
               "ig fused": ExplainEngine(cfg, params, fused=True, **kw)}
    kernels = {"ig unfused": PATH_KERNELS["riemann"][0] + FLASH, "ig fused": PATH_KERNELS["riemann"][1] + FLASH}
    plan = plan_buckets(reqs, seq_buckets=buckets)
    print(f"gemma engine: {cfg.name} at full width, {cfg.num_layers} layers (1 period + "
          f"{''.join(s.mixer[0].upper() for s in cfg.remainder_specs)}), window {cfg.sliding_window}, "
          f"{cfg.compute_dtype}; {cfg.param_count() / 1e9:.3f}B parameters; {len(reqs)} requests of "
          f"{sorted(len(r.tokens) for r in reqs)} tokens in buckets (B×S) "
          f"{[f'{bb.bucket[0]}x{bb.bucket[1]}' for bb in plan]}; m={M}, n_int={N_INT}, chunk={GEMMA_CHUNK}")
    paths_launched, outs = {}, {}
    for name, eng in engines.items():
        out, ms0, launched = _timed(lambda: eng.explain(reqs, return_raw=True))
        _need(paths_launched, f"gemma engine {name}", launched, kernels[name])
        _served_ok(f"gemma {name}", out, reqs)
        misses, before = eng.stats.misses, {b: (s.total_s, s.calls) for b, s in eng.stats.buckets.items()}
        again, ms, launched = _timed(lambda: eng.explain(reqs, return_raw=True))
        _need(paths_launched, f"gemma engine {name} replay", launched, kernels[name])
        if eng.stats.misses != misses:
            raise AssertionError(f"gemma engine {name} replay: {eng.stats.misses - misses} new misses")
        for i, (a, b) in enumerate(zip(again, out)):
            if not all(np.array_equal(a[k], b[k]) for k in a):
                raise AssertionError(f"gemma engine {name} replay: request {i} not bit-identical")
        outs[name] = out
        per_bucket = ", ".join(
            f"{b[0]}x{b[1]} {(st.total_s - before[b][0]) * 1e3 / (st.calls - before[b][1]):.1f}"
            for b, st in sorted(eng.stats.buckets.items(), key=lambda kv: kv[0][1]))
        print(f"  {name}: {ms:.1f} ms for {len(reqs)} requests warm ({ms0:.1f} ms in round 0); replay "
              f"bit-identical, no new miss (misses {misses}, hits {eng.stats.hits}); warm ms per bucket call "
              f"(B×S): {per_bucket}; mean δ {np.mean([r['delta'] for r in out]):.4g}")
    print(f"  peak device memory over the paths: {_peak_gb():.2f} GB")
    _scores_close("gemma ig fused vs unfused", outs["ig fused"], outs["ig unfused"])
    _profile("gemma engine ig unfused (warm)", lambda: engines["ig unfused"].explain(reqs))
    del engines, params

    # the card against the CPU on a narrow gemma3: f32, TF32 off, the 32 bucket above 2w
    nl, seq, lens, m_cpu = GEMMA_ENGINE_CPU
    cfg_n = _gemma_narrow(nl, seq)
    p_card = lm.init_params(cfg_n, torch.Generator(device=DEV).manual_seed(1), device=DEV)
    p_cpu = tree_map(lambda _, t: t.cpu(), p_card)
    rng = np.random.default_rng(2)
    short = [ExplainRequest(rng.integers(1, cfg_n.vocab_size, s).astype("int32"),
                            int(rng.integers(0, cfg_n.vocab_size))) for s in lens]
    kw_n = dict(method="ig", schedule="paper", m=m_cpu, n_int=N_INT, attn="flash", seq_buckets=(16, 32))
    eng_g = ExplainEngine(cfg_n, p_card, device=DEV, **kw_n)
    eng_c = ExplainEngine(cfg_n, p_cpu, device="cpu", **kw_n)
    res_g, _, launched = _timed(lambda: eng_g.explain(short))
    _need(paths_launched, "gemma engine card vs CPU", launched, kernels["ig unfused"])
    t0 = time.perf_counter()
    res_c = eng_c.explain(short)
    cpu_s = time.perf_counter() - t0
    tied = []
    for bb in plan_buckets(short, seq_buckets=(16, 32)):
        vals = [probes.run_probe("boundary", e._explainer.f, *a[:3], n_int=N_INT, mask=a[3]).vals.cpu()
                for e in (eng_g, eng_c) for a in (e._bucket_inputs(bb),)]
        rows = (_near_tie_rows(vals[0], m_cpu) | _near_tie_rows(vals[1], m_cpu))[: len(bb.indices)]
        tied += [i for i, t in zip(bb.indices, rows.tolist()) if t]
    print(f"  card vs CPU: narrow gemma3 (window {cfg_n.sliding_window}, {nl} layers), prompts of {list(lens)} "
          f"tokens in buckets 16 and 32, m={m_cpu}, f32 (CPU {cpu_s:.1f} s); near-tie requests {tied}, f(x) gap "
          f"{max(abs(a['f_x'] - b['f_x']) for a, b in zip(res_g, res_c)):.3g}")
    for i, (a, b) in enumerate(zip(res_g, res_c)):
        if i not in tied:
            _attr_close(f"gemma card vs CPU token scores, request {i}", torch.from_numpy(a["token_scores"])[None],
                        torch.from_numpy(b["token_scores"])[None])
    print(f"  peak device memory over the gemma engine phase: {_peak_gb():.2f} GB")
    return {"launches": dict(common.LAUNCHES), "carry_ranks": dict(common.CARRY_RANKS),
            "per_path": paths_launched}


def gemma_mixed_phase() -> dict:
    """``MixedScheduler(decode_chunk=8)`` over an ``ig`` engine on the
    8-layer gemma3-27b: 2 greedy generates of 1000 + 48 (decode wraps the
    rings at position 1024) and 2 explain-only requests, a clean round, then
    the round with a fault raised inside ``decode_step`` at the third step of
    the first chunk from position 1024; the retry must give the clean
    tokens and bits, every decode step's logits and the final cache bit for
    bit, and nothing degrades. A control round with the rings' snapshot
    saving nothing must fail that comparison."""
    import numpy as np

    from repro_torch.kernels import common
    from repro_torch.models import blocks, lm
    from repro_torch.serve import ExplainEngine, GenerateRequest, MixedScheduler, ServeEngine
    from repro_torch.serve.batching import DEFAULT_SEQ_BUCKETS

    _free_card()
    cfg = _gemma_config(GEMMA_ENGINE_LAYERS)
    common.reset_launches()  # the slice's own count starts here
    _reset_peak()
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    engine = ExplainEngine(cfg, params, method="ig", schedule="paper", m=M, n_int=N_INT, chunk=GEMMA_CHUNK,
                           seq_buckets=DEFAULT_SEQ_BUCKETS + (2048,), attn="flash", device=DEV)
    n_gen, S, new, dchunk, n_exp = GEMMA_MIXED
    max_len = S + new
    sched = MixedScheduler(engine, max_len=max_len, decode_chunk=dchunk)
    rec = _instrument(sched)
    rng = np.random.default_rng(22)
    traffic = [GenerateRequest(rng.integers(1, cfg.vocab_size, S).astype(np.int32), new)
               for _ in range(n_gen)] + _lm_traffic(cfg, ((n_exp, 17, 128),), seed=6)
    V, riemann = cfg.vocab_size, PATH_KERNELS["riemann"][0] + FLASH
    print(f"gemma mixed: MixedScheduler(max_len={max_len}, decode_chunk={dchunk}) over ExplainEngine(ig, m={M}, "
          f"chunk={GEMMA_CHUNK}) on {cfg.name}, {cfg.num_layers} layers, {cfg.compute_dtype}; {n_gen} greedy "
          f"generates of {S}+{new} (decode wraps the {cfg.sliding_window}-slot rings), {n_exp} explain-only")
    paths_launched = {}

    def serve(reqs):
        tickets = [sched.submit(r) for r in reqs]
        sched.run_until_idle()
        return tickets

    # every decode step's logits by position (a retried step replaces its
    # first attempt's) and the cache the last step returned
    real_step, seen = lm.decode_step, {"logits": {}, "cache": None}

    def recording(*a, **kw):
        out = real_step(*a, **kw)
        seen["logits"][int(a[2]["len"])], seen["cache"] = out
        return out

    def _decoded():
        lg = [seen["logits"][p] for p in sorted(seen["logits"])]
        leaves = [t for e in seen["cache"]["layers"] + seen["cache"]["rem"] for t in (e["k"], e["v"])]
        seen.update(logits={}, cache=None)
        return lg, leaves

    _clear(rec)
    lm.decode_step = recording
    try:
        clean, ms, launched = _timed(lambda: serve(traffic))
    finally:
        lm.decode_step = real_step
    decoded = _decoded()
    _need(paths_launched, "gemma mixed round", launched, riemann)
    _mixed_ok("gemma mixed round", clean, traffic, rec, V)
    for kind, names in (("prefill", ("flash_fwd",)), ("decode", ()), ("exp_fixed", riemann)):
        _need(paths_launched, f"gemma mixed {kind} items", rec["launches"][kind], names)
    print(f"  clean round: {ms:.1f} ms; decode {_decode_ms(rec, n_gen):.2f} ms a token at B={n_gen} (items' "
          f"walls); latency {_latencies(sched)}")
    prompts = torch.as_tensor(np.stack([r.tokens for r in traffic[:n_gen]]), device=DEV)
    want, gms, launched = _timed(lambda: ServeEngine(cfg, params, max_len, device=DEV)
                                 .generate({"tokens": prompts}, new))
    _need(paths_launched, "gemma mixed ServeEngine.generate", launched, ("flash_fwd",))
    if not np.array_equal(want.cpu().numpy(), np.stack([t.tokens for t in clean[:n_gen]])):
        raise AssertionError("gemma mixed: the scheduler's greedy tokens are not ServeEngine.generate's")
    for flush in rec["flushes"]:
        for (t, pos, _), w in zip(flush, engine.explain([r for _, _, r in flush])):
            if not all(np.array_equal(dict(_results_of(t))[pos][k], w[k]) for k in w):
                raise AssertionError(f"gemma mixed: ticket {t.id} differs from engine.explain")
    print(f"  gate: the {n_gen * new} greedy tokens equal ServeEngine.generate's ({gms:.1f} ms there); the "
          f"attributions engine.explain's bit for bit")

    # a fault inside decode_step at the third step of the first chunk from position ≥ w:
    # its first two steps overwrote ring slots that the retried steps attend to
    def faulted_round(name: str):
        """The round with the fault; returns its tickets and decode record."""
        fired, armed = [], []

        def faulty_step(*a, **kw):
            if armed:
                armed[0] += 1
                if armed[0] == GEMMA_FAULT_STEP:
                    armed.clear()
                    fired.append(int(a[2]["len"]))
                    raise RuntimeError("injected fault inside a decode chunk past the ring's wrap")
            return recording(*a, **kw)

        def hook(kind, payload):
            if kind == "decode" and not fired and not armed and int(payload.cache["len"]) >= cfg.sliding_window:
                armed.append(0)

        _clear(rec)
        d0 = engine.stats.degraded
        sched.fault_hook, lm.decode_step = hook, faulty_step
        try:
            tickets, ms, launched = _timed(lambda: serve(traffic))
        finally:
            sched.fault_hook, lm.decode_step = None, real_step
        _need(paths_launched, name, launched, riemann)
        if not fired or engine.stats.degraded != d0:
            raise AssertionError(f"{name}: fired at {fired}, degraded {engine.stats.degraded - d0}")
        _mixed_ok(name, tickets, traffic, rec, V)
        return tickets, _decoded(), ms, fired[0]

    faulted, got, ms, at = faulted_round("gemma mixed faults")
    _same_bits("gemma mixed faults vs the clean round", faulted, clean)
    if not _same_decode(got, decoded):
        raise AssertionError("gemma mixed faults: the retried round's decode logits or cache are not the clean "
                             "round's bit for bit")
    print(f"  fault round ({ms:.1f} ms): the fault at decode position {at} (ring slot "
          f"{at % cfg.sliding_window}, step {GEMMA_FAULT_STEP} of its chunk) retried to the clean "
          f"tokens and bits, and to its {len(decoded[0])} steps' logits and every cache leaf bit for bit; "
          "nothing degraded")
    # the gate's power on the card: the same fault with the rings' snapshot saving nothing
    real_snapshot = blocks.decode_snapshot
    blocks.decode_snapshot = lambda *a, **kw: lambda: None
    try:
        unsaved, got, ms, at = faulted_round("gemma mixed faults, rings unsaved")
    finally:
        blocks.decode_snapshot = real_snapshot
    if _same_decode(got, decoded):
        raise AssertionError("gemma mixed faults: with the rings unsaved the retry still gave the clean "
                             "round's logits and cache, so the gate above cannot fail")
    differ = sum(not np.array_equal(a.tokens, b.tokens) for a, b in zip(unsaved[:n_gen], clean[:n_gen]))
    print(f"  control ({ms:.1f} ms): the same fault with the rings unsaved gives other logits and cache "
          f"({differ} of {n_gen} generates' tokens differ), so the gate above can fail")
    print(f"  peak device memory over the gemma mixed phase: {_peak_gb():.2f} GB")
    return {"launches": dict(common.LAUNCHES), "carry_ranks": dict(common.CARRY_RANKS),
            "per_path": paths_launched}


# ------------------------------------------- MoE and Mamba-2 (SSD): qwen3-moe, mamba2, jamba

MOE_ENGINE_LAYERS = 4  # qwen3-moe-30b-a3b at full width, 4 of 48 layers: 12.5 GB of f32 weights
MOE_SERVE_LAYERS = 16  # 42.4 GB of f32 weights
MOE_CPU = (2, 16, 8)  # card vs CPU, f32: prompts, most tokens, m
MOE_SERVE_CPU = (2, 2, 16, 8)  # card vs CPU, f32: layers, prompts, tokens, new
NEAR_TIE = 1e-5  # router probabilities this close (k-th less (k+1)-th) may route apart on two devices
PEAK_BUDGET = 70e9  # the predicted peak (hotpath_cost) a chunk must fit
SSM_SERVE = ((16, 128, 64), (2, 997, 32))  # prompts, tokens, new: 997 is prime, so the prefill's chunk is 1
SSM_F32 = (2, 509, 16)  # f32 at full depth, decode against a fresh forward: prompts, tokens (prime), new
SSM_PROFILE_M = 8  # the profiled warm call: the 512 bucket's requests at this m
SSM_MIXED = (2, 128, 24, 8, 1, 8)  # generates: requests, tokens, new; decode chunk; explain-only requests, m
SSM_FAULT = (136, 3)  # the fault rises at this decode_step of the first chunk from this position on
HYBRID_LAYERS = 5  # jamba-v0.1-52b: no whole period, the remainder M_D M_E M_D M_E A_D (28.6 GB)
HYBRID_TRAFFIC = (6, 17, 128)  # engine requests: count, shortest, longest
HYBRID_GEN = (2, 128, 32)  # greedy: prompts, tokens, new


def _arch(name: str, layers: int, **kw):
    """An architecture of the port's ``ARCHS`` at full width, ``layers`` deep."""
    from repro_torch.configs import ARCHS

    return replace(ARCHS[name], num_layers=layers, **kw)


def _fitting_chunk(cfg, plan) -> int:
    """The largest chunk dividing M whose predicted peak
    (``roofline.hotpath_cost``, the engine's own count) fits PEAK_BUDGET at
    every bucket of ``plan``."""
    from repro_torch.roofline import hotpath_cost

    for c in sorted((c for c in range(1, M + 1) if M % c == 0), reverse=True):
        if all(hotpath_cost(cfg, bb.bucket, M, c, cfg.compute_dtype)["peak bytes"] <= PEAK_BUDGET
               for bb in plan):
            return c
    raise AssertionError(f"{cfg.name}: no chunk fits {PEAK_BUDGET / 1e9:.0f} GB")


@contextmanager
def _moe_calls(routes: bool = False):
    """Record each call of ``models.moe.moe`` beside the model (its output is
    unchanged): the input's (B, S), the share of (token, choice) slots the
    capacity dropped and, with ``routes``, each token's chosen experts
    (sorted) and router margin, the k-th less the (k+1)-th probability, on
    the CPU."""
    from repro_torch.models import moe

    real, calls = moe.moe, []

    def recorded(p, x, cfg):
        with torch.no_grad():
            r = moe.route(p["router"], x.detach().reshape(-1, x.shape[-1]), cfg)
            call = {"shape": tuple(x.shape[:2]), "dropped": float((~r.keep).float().mean())}
            if routes:
                top = r.probs.topk(cfg.experts_per_tok + 1, dim=-1).values
                call.update(experts=r.eid.sort(-1).values.cpu(), margin=(top[:, -2] - top[:, -1]).cpu())
            calls.append(call)
        return real(p, x, cfg)

    moe.moe = recorded
    try:
        yield calls
    finally:
        moe.moe = real


def _routed_apart(name: str, got: list, want: list) -> bool:
    """Whether two runs' MoE calls (``_moe_calls(routes=True)``) sent a token
    to other experts. Raises unless the first call where they part does so
    only at tokens whose router margin is below NEAR_TIE on both devices
    (later calls then see other inputs)."""
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} MoE calls against {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        apart = (a["experts"] != b["experts"]).any(-1)
        if bool(apart.any()):
            margin = float(torch.maximum(a["margin"][apart], b["margin"][apart]).max())
            print(f"  {name}: MoE call {i} of {len(got)} routes {int(apart.sum())} of {apart.numel()} tokens "
                  f"apart, at router margins up to {margin:.3g}")
            if not margin < NEAR_TIE:
                raise AssertionError(f"{name}: tokens routed apart at a router margin of {margin:.3g}")
            return True
    return False


def _peak_gate(name: str, eng, measured_gb: float) -> None:
    """The measured peak at or below the engine's predicted one (the largest
    ``hotpath_cost`` peak of its buckets)."""
    predicted = max(st.peak_bytes for st in eng.stats.buckets.values()) / 1e9
    print(f"  {name}: peak {measured_gb:.2f} GB measured, {predicted:.2f} GB predicted by hotpath_cost "
          f"({measured_gb / predicted:.3f} of it)")
    if not measured_gb <= predicted:
        raise AssertionError(f"{name}: the measured peak {measured_gb:.2f} GB is above the predicted "
                             f"{predicted:.2f} GB")


def _served_twice(name: str, eng, reqs: list, paths_launched: dict, kernels) -> tuple[list, float]:
    """Round 0, then the same traffic again: the launches of both, no new
    miss, the same bits, the measured peak of the warm round against the
    prediction. Returns (the results, the warm round's ms)."""
    import numpy as np

    out, ms0, launched = _timed(lambda: eng.explain(reqs, return_raw=True))
    _need(paths_launched, name, launched, kernels)
    _served_ok(name, out, reqs)
    misses, before = eng.stats.misses, {b: (s.total_s, s.calls) for b, s in eng.stats.buckets.items()}
    _reset_peak()
    again, ms, launched = _timed(lambda: eng.explain(reqs, return_raw=True))
    peak = _peak_gb()
    _need(paths_launched, f"{name} replay", launched, kernels)
    if eng.stats.misses != misses:
        raise AssertionError(f"{name} replay: {eng.stats.misses - misses} new misses")
    for i, (a, b) in enumerate(zip(again, out)):
        if not all(np.array_equal(a[k], b[k]) for k in a):
            raise AssertionError(f"{name} replay: request {i} not bit-identical")
    per_bucket = ", ".join(
        f"{b[0]}x{b[1]} {(st.total_s - before[b][0]) * 1e3 / (st.calls - before[b][1]):.1f}"
        for b, st in sorted(eng.stats.buckets.items(), key=lambda kv: kv[0][1]))
    print(f"  {name}: {ms:.1f} ms for {len(reqs)} requests warm ({ms0:.1f} ms in round 0); replay "
          f"bit-identical, no new miss (misses {misses}, hits {eng.stats.hits}); warm ms per bucket call "
          f"(B×S): {per_bucket}; mean δ {np.mean([r['delta'] for r in out]):.4g}, mean |δ| / |f(x) − f(x′)| "
          f"{np.mean([abs(r['delta']) / max(abs(r['f_x'] - r['f_baseline']), 1e-12) for r in out]):.4g}")
    _peak_gate(name, eng, peak)
    return out, ms


def moe_engine_phase() -> dict:
    """``ExplainEngine`` on qwen3-moe-30b-a3b at full width, 4 layers (bf16,
    flash attention, 128 experts top-8) over the LM engine phase's 20
    requests: ``ig`` unfused and fused, each served twice, the capacity's
    drop shares, the peak against ``hotpath_cost``'s, the card against
    the CPU."""
    from repro_torch.core import probes
    from repro_torch.kernels import common
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.serve import ExplainEngine
    from repro_torch.serve.batching import plan_buckets

    _free_card()
    cfg = _arch("qwen3-moe-30b-a3b", MOE_ENGINE_LAYERS, attn_impl="flash")
    common.reset_launches()  # the slice's own count starts here
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    reqs = _lm_traffic(cfg, (LM_SHORT, LM_LONG), seed=0)
    plan = plan_buckets(reqs)
    chunk = _fitting_chunk(cfg, plan)
    print(f"moe engine: {cfg.name} at full width, {cfg.num_layers} layers (of 48), d={cfg.d_model}, "
          f"{cfg.num_heads} heads on {cfg.num_kv_heads}, {cfg.num_experts} experts top-{cfg.experts_per_tok} of "
          f"{cfg.moe_d_ff}, capacity factor {cfg.capacity_factor}, {cfg.compute_dtype}; "
          f"{cfg.param_count() / 1e9:.3f}B parameters ({cfg.active_param_count() / 1e9:.3f}B active); "
          f"{len(reqs)} requests in buckets (B×S) {[f'{bb.bucket[0]}x{bb.bucket[1]}' for bb in plan]}; "
          f"m={M}, n_int={N_INT}, chunk {chunk} (the largest whose predicted peak fits "
          f"{PEAK_BUDGET / 1e9:.0f} GB)")
    kw = dict(method="ig", schedule="paper", m=M, n_int=N_INT, chunk=chunk, attn="flash", device=DEV)
    engines = {"moe ig unfused": ExplainEngine(cfg, params, **kw),
               "moe ig fused": ExplainEngine(cfg, params, fused=True, **kw)}
    kernels = {"moe ig unfused": PATH_KERNELS["riemann"][0] + FLASH,
               "moe ig fused": PATH_KERNELS["riemann"][1] + FLASH}
    paths_launched, outs = {}, {}
    for name, eng in engines.items():
        outs[name], _ = _served_twice(name, eng, reqs, paths_launched, kernels[name])
    _scores_close("moe ig fused vs unfused (printed: a near-tie routing may part between two bf16 paths)",
                  outs["moe ig fused"], outs["moe ig unfused"], gate=False)
    # the capacity's drops, recorded beside the model over one more (untimed) round
    eng = engines["moe ig unfused"]
    with _moe_calls() as calls:
        _, _, launched = _timed(lambda: eng.explain(reqs))
    _need(paths_launched, "moe ig unfused, routing recorded", launched, kernels["moe ig unfused"])
    shares = []
    for bb in plan:
        Bb, S = bb.bucket
        stage2 = [c["dropped"] for c in calls if c["shape"] == (Bb * chunk, S)]
        probe = [c["dropped"] for c in calls if c["shape"][1] == S and c["shape"][0] != Bb * chunk]
        shares.append(f"{Bb}x{S}: {stage2[0]:.4f} of the stage-2 call's (rows {Bb * chunk}, "
                      f"{Bb * chunk * S} tokens), {max(probe):.4f} at most of the probe's and endpoints'")
    print(f"  dropped (token, choice) slots, layer 0 of one call per bucket: " + "; ".join(shares))
    _profile("moe engine ig unfused (warm)", lambda: eng.explain(reqs))
    del engines, eng

    # the card against the port on the CPU: f32, TF32 off, 2 short prompts
    n_cpu, most, m_cpu = MOE_CPU
    cfg32 = replace(cfg, compute_dtype="float32")
    short = _lm_traffic(cfg, ((n_cpu, most // 2, most),), seed=1)
    params_cpu = tree_map(lambda _, t: t.cpu(), params)
    kw32 = dict(method="ig", schedule="paper", m=m_cpu, n_int=N_INT, attn="flash", seq_buckets=(most,))
    eng_g = ExplainEngine(cfg32, params, device=DEV, **kw32)
    eng_c = ExplainEngine(cfg32, params_cpu, device="cpu", **kw32)
    with _moe_calls(routes=True) as calls_g:
        res_g, _, launched = _timed(lambda: eng_g.explain(short))
    _need(paths_launched, "moe card vs CPU", launched, kernels["moe ig unfused"])
    t0 = time.perf_counter()
    with _moe_calls(routes=True) as calls_c:
        res_c = eng_c.explain(short)
    cpu_s = time.perf_counter() - t0
    apart = _routed_apart("moe card vs CPU", calls_g, calls_c)
    bb32 = plan_buckets(short, seq_buckets=(most,))[0]
    vals = [probes.run_probe("boundary", e._explainer.f, *a[:3], n_int=N_INT, mask=a[3]).vals.cpu()
            for e in (eng_g, eng_c) for a in (e._bucket_inputs(bb32),)]
    tied = (_near_tie_rows(vals[0], m_cpu) | _near_tie_rows(vals[1], m_cpu))[: n_cpu]
    if apart:
        tied[:] = True  # one bucket: a routing apart reaches every row through the capacity
    print(f"  card vs CPU ({n_cpu} prompts of {[len(r.tokens) for r in short]} tokens, m={m_cpu}, f32, TF32 off; "
          f"CPU run {cpu_s:.1f} s): {len(calls_g)} MoE calls, routed alike: {not apart}; exempt rows "
          f"{torch.nonzero(tied).flatten().tolist()} (near ties of the router or the schedule), f(x) gap "
          f"{max(abs(g['f_x'] - c['f_x']) for g, c in zip(res_g, res_c)):.3g}")
    got = torch.nn.utils.rnn.pad_sequence([torch.from_numpy(r["token_scores"]) for r in res_g], True)
    want = torch.nn.utils.rnn.pad_sequence([torch.from_numpy(r["token_scores"]) for r in res_c], True)
    if not bool(tied.all()):
        _attr_close("moe card vs CPU token scores", got, want, ~tied)
    print(f"  peak device memory over the moe engine phase: {_peak_gb():.2f} GB")
    return {"launches": dict(common.LAUNCHES), "carry_ranks": dict(common.CARRY_RANKS),
            "per_path": paths_launched}


def moe_serve_phase() -> dict:
    """``ServeEngine`` on qwen3-moe-30b-a3b at full width, 16 layers (bf16,
    flash prefill): 16 prompts of 128 with 64 new, greedy, and one decode
    chunk; bf16 decode against a fresh forward (printed); the card against
    the CPU at 2 layers, f32."""
    from repro_torch.kernels import common
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import Model
    from repro_torch.serve import ServeEngine, make_decode_chunk

    _free_card()
    cfg = _arch("qwen3-moe-30b-a3b", MOE_SERVE_LAYERS, attn_impl="flash")
    model, V = Model(cfg), cfg.vocab_size
    common.reset_launches()  # the slice's own count starts here
    _reset_peak()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    _sync()
    print(f"moe serve: {cfg.name} at full width, {cfg.num_layers} layers, {cfg.compute_dtype}, flash prefill; "
          f"{cfg.param_count() / 1e9:.3f}B parameters drawn on the card in {time.perf_counter() - t0:.1f} s")
    paths_launched = {}
    g = torch.Generator(device=DEV).manual_seed(5)
    Bs, S, n_new = SERVE_TRAFFIC
    prompts = _prompts(g, cfg, Bs, S)
    batch = {"tokens": prompts}
    eng = ServeEngine(cfg, params, max_len=S + n_new, device=DEV)
    eng.generate(batch, 2)  # warm: cuBLAS handles and plans
    with _moe_calls() as calls:
        _, prefill_ms = _generated(paths_launched, "moe serve prefill (1 token)", lambda: eng.generate(batch, 1), V)
    greedy, ms = _generated(paths_launched, f"moe serve greedy {Bs}x{S}+{n_new}",
                            lambda: eng.generate(batch, n_new), V)
    print(f"  greedy, {Bs} prompts of {S}, {n_new} new: {ms:.1f} ms; prefill {prefill_ms:.1f} ms (dropped "
          f"{max(c['dropped'] for c in calls):.4f} of its slots at most, a layer), decode "
          f"{(ms - prefill_ms) / (n_new - 1):.2f} ms a token (B={Bs}), {Bs * n_new / ms * 1e3:.0f} tokens/s")
    chunk = make_decode_chunk(cfg)
    (_, cache), _, launched = _timed(lambda: model.prefill(params, batch, S + n_new))
    _need(paths_launched, "moe serve chunk prefill", launched, ("flash_fwd",))
    gc = torch.Generator(device=DEV).manual_seed(7)
    (toks, lps, cache), ms, launched = _timed(lambda: chunk(params, cache, greedy[:, :1], gc, 0.0, SERVE_CHUNK))
    _need(paths_launched, "moe serve decode chunk", launched, ())
    if not torch.equal(toks, greedy[:, 1:1 + SERVE_CHUNK]):
        raise AssertionError("moe serve: the decode chunk at T=0 did not give generate's greedy tokens")
    print(f"  decode chunk of {SERVE_CHUNK} at B={Bs}, T=0: {ms:.1f} ms ({ms / SERVE_CHUNK:.2f} a token), "
          f"generate's greedy tokens")
    _profile(f"moe serve decode chunk ({SERVE_CHUNK} tokens, B={Bs})",
             lambda: chunk(params, cache, toks[:, -1:], gc, 0.0, SERVE_CHUNK))
    del cache
    # a MoE prefill routes all B·S tokens together, decode B at a time: printed, not gated
    _row_close(f"moe bf16 decode vs fresh forward, {cfg.num_layers} layers, steps 0..{n_new - 1}",
               _teacher_forced(model, params, prompts, greedy, S + n_new),
               _fresh(model, params, prompts, greedy), ENGINE_TOL, gate=False)
    print(f"  peak device memory over the 16-layer runs: {_peak_gb():.2f} GB")
    del eng

    # the card against the CPU (f32, TF32 off) at 2 layers
    nl, n4, s4, k4 = MOE_SERVE_CPU
    cfg_c = replace(cfg, num_layers=nl, compute_dtype="float32")
    m_c, params_c = Model(cfg_c), _layers_of(params, nl)
    params_cpu = tree_map(lambda _, t: t.cpu(), params_c)
    p4 = _prompts(g, cfg, n4, s4)
    out_g, _ = _generated(paths_launched, "moe serve greedy card vs CPU",
                          lambda: ServeEngine(cfg_c, params_c, s4 + k4, device=DEV).generate({"tokens": p4}, k4), V)
    t0 = time.perf_counter()
    out_c = ServeEngine(cfg_c, params_cpu, s4 + k4, device="cpu").generate({"tokens": p4.cpu()}, k4)
    with _moe_calls(routes=True) as calls_c:
        tf_c = _teacher_forced(m_c, params_cpu, p4.cpu(), out_c, s4 + k4)
    with _moe_calls(routes=True) as calls_g:
        tf_g = _teacher_forced(m_c, params_c, p4, out_c.to(DEV), s4 + k4).cpu()
    print(f"  card vs CPU: {n4} prompts of {s4}, {k4} new, {nl} layers at full width, f32; CPU "
          f"{time.perf_counter() - t0:.1f} s")
    if _routed_apart("moe serve card vs CPU", calls_g, calls_c):
        print("  card vs CPU: a near-tie routing parts the two devices; logits and tokens not compared")
    else:
        _tokens_agree("moe serve card vs CPU tokens", out_g, out_c, tf_c, LOGIT_TOL_F32)
        _row_close("moe serve card vs CPU decode logits, teacher-forced on the CPU's tokens", tf_g, tf_c,
                   LOGIT_TOL_F32)
    print(f"  peak device memory over the moe serve phase: {_peak_gb():.2f} GB")
    return {"launches": dict(common.LAUNCHES), "carry_ranks": dict(common.CARRY_RANKS),
            "per_path": paths_launched}


def _cache_tensors(cache: dict) -> list:
    return [t for e in cache["layers"] + cache["rem"] for t in e.values()]


def ssm_phase() -> dict:
    """mamba2-780m at full width and depth (48 layers, bf16): generation
    (16 × 128 + 64, 2 × 997 + 32 with a chunk-1 prefill, a decode chunk; f32
    decode against a fresh forward), ``ExplainEngine`` ``ig`` over the LM
    engine phase's 20 requests served twice (every score finite at buckets
    128 and 512, the peak against ``hotpath_cost``'s), and a
    ``MixedScheduler`` round with a fault inside a decode chunk."""
    import numpy as np

    from repro_torch.kernels import common
    from repro_torch.models import blocks, lm
    from repro_torch.models.registry import Model
    from repro_torch.models.ssm import chunk_len
    from repro_torch.serve import ExplainEngine, GenerateRequest, MixedScheduler, ServeEngine, make_decode_chunk
    from repro_torch.serve.batching import plan_buckets

    _free_card()
    cfg = _arch("mamba2-780m", 48)
    model, V = Model(cfg), cfg.vocab_size
    common.reset_launches()  # the slice's own count starts here
    _reset_peak()
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    print(f"ssm: {cfg.name} at full width and depth, {cfg.num_layers} layers, d={cfg.d_model}, d_inner "
          f"{cfg.d_inner} in {cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, conv "
          f"{cfg.ssm_conv}, chunk {cfg.ssm_chunk}, vocabulary {V} tied, {cfg.compute_dtype}; "
          f"{cfg.param_count() / 1e9:.3f}B parameters")
    paths_launched = {}
    g = torch.Generator(device=DEV).manual_seed(5)
    for i, (Bs, S, n_new) in enumerate(SSM_SERVE):
        prompts = _prompts(g, cfg, Bs, S)
        batch = {"tokens": prompts}
        eng = ServeEngine(cfg, params, max_len=S + n_new, device=DEV)
        if not i:
            eng.generate(batch, 2)  # warm: cuBLAS handles and plans
        _, prefill_ms = _generated(paths_launched, f"ssm prefill {Bs}x{S} (1 token)",
                                   lambda: eng.generate(batch, 1), V, ())
        out, ms = _generated(paths_launched, f"ssm greedy {Bs}x{S}+{n_new}", lambda: eng.generate(batch, n_new),
                             V, ())
        print(f"  greedy, {Bs} prompts of {S} (prefill chunk {chunk_len(S, cfg.ssm_chunk)}), {n_new} new: "
              f"{ms:.1f} ms; prefill {prefill_ms:.1f} ms, decode {(ms - prefill_ms) / (n_new - 1):.2f} ms a "
              f"token (B={Bs}), {Bs * n_new / ms * 1e3:.0f} tokens/s")
        _row_close(f"ssm bf16 decode vs fresh forward, {Bs}x{S}", _teacher_forced(model, params, prompts, out,
                   S + n_new), _fresh(model, params, prompts, out), ENGINE_TOL, gate=False)
        if not i:
            chunk_fn = make_decode_chunk(cfg)
            (_, cache), _, launched = _timed(lambda: model.prefill(params, batch, S + n_new))
            _need(paths_launched, "ssm chunk prefill", launched, ())
            gc = torch.Generator(device=DEV).manual_seed(7)
            (toks, _, cache), cms, launched = _timed(lambda: chunk_fn(params, cache, out[:, :1], gc, 0.0,
                                                                      SERVE_CHUNK))
            _need(paths_launched, "ssm decode chunk", launched, ())
            if not torch.equal(toks, out[:, 1:1 + SERVE_CHUNK]):
                raise AssertionError("ssm: the decode chunk at T=0 did not give generate's greedy tokens")
            print(f"  decode chunk of {SERVE_CHUNK} at B={Bs}, T=0: {cms:.1f} ms, generate's greedy tokens")
            del cache
    # f32 at full depth: the chunk-1 prefill and the recurrence against one chunked forward
    n2, s2, k2 = SSM_F32
    cfg32 = replace(cfg, compute_dtype="float32")
    m32, p2 = Model(cfg32), _prompts(g, cfg, n2, s2)
    out, _ = _generated(paths_launched, "ssm greedy f32 full depth",
                        lambda: ServeEngine(cfg32, params, s2 + k2, device=DEV).generate({"tokens": p2}, k2), V, ())
    tf, fresh = _teacher_forced(m32, params, p2, out, s2 + k2), _fresh(m32, params, p2, out)
    _row_close(f"ssm f32 decode vs fresh forward, {cfg.num_layers} layers, prefill chunk "
               f"{chunk_len(s2, cfg.ssm_chunk)}, fresh chunk {chunk_len(s2 + k2 - 1, cfg.ssm_chunk)}", tf, fresh,
               LOGIT_TOL_F32)
    _tokens_agree("ssm f32 tokens vs the fresh forward's argmax", out, fresh.argmax(-1), fresh, LOGIT_TOL_F32)
    print(f"  peak device memory over generation: {_peak_gb():.2f} GB")
    del tf, fresh

    # the engine: stage 2 through the Triton kernels, no attention
    reqs = _lm_traffic(cfg, (LM_SHORT, LM_LONG), seed=0)
    plan = plan_buckets(reqs)
    chunk = _fitting_chunk(cfg, plan)
    print(f"  engine: {len(reqs)} requests in buckets (B×S) {[f'{bb.bucket[0]}x{bb.bucket[1]}' for bb in plan]} "
          f"(SSD chunks {[chunk_len(bb.bucket[1], cfg.ssm_chunk) for bb in plan]}); m={M}, n_int={N_INT}, "
          f"chunk {chunk} (the largest whose predicted peak fits {PEAK_BUDGET / 1e9:.0f} GB)")
    riemann = PATH_KERNELS["riemann"][0]
    eng = ExplainEngine(cfg, params, method="ig", schedule="paper", m=M, n_int=N_INT, chunk=chunk, device=DEV)
    out, _ = _served_twice("ssm ig unfused", eng, reqs, paths_launched, riemann)
    n_long = sum(len(bb.indices) for bb in plan if bb.bucket[1] >= 128)
    print(f"  every score finite, at buckets 128 and 512 too ({n_long} requests, SSD chunks of 128 and 256, "
          f"where an unmasked exponential's gradient would be NaN)")
    big = next(bb for bb in plan if bb.bucket[1] == max(b.bucket[1] for b in plan))
    eng_p = ExplainEngine(cfg, params, method="ig", schedule="paper", m=SSM_PROFILE_M, n_int=N_INT, chunk=chunk,
                          device=DEV)
    few = [reqs[i] for i in big.indices]
    eng_p.explain(few)
    _profile(f"ssm engine ig (warm, m={SSM_PROFILE_M}, the {big.bucket[0]}x{big.bucket[1]} bucket's requests)",
             lambda: eng_p.explain(few))
    del eng_p

    # MixedScheduler with a fault inside a decode chunk: the retry restores the SSM state and conv tail
    n_gen, S, new, dchunk, n_exp, m_mix = SSM_MIXED
    eng = ExplainEngine(cfg, params, method="ig", schedule="paper", m=m_mix, n_int=N_INT, chunk=chunk, device=DEV)
    sched = MixedScheduler(eng, max_len=S + new, decode_chunk=dchunk)
    rec = _instrument(sched)
    rng = np.random.default_rng(23)
    traffic = [GenerateRequest(rng.integers(1, V, S).astype(np.int32), new) for _ in range(n_gen)] + \
        _lm_traffic(cfg, ((n_exp, 17, 128),), seed=6)
    real_step, seen = lm.decode_step, {"logits": {}, "cache": None}

    def recording(*a, **kw):
        out = real_step(*a, **kw)
        seen["logits"][int(a[2]["len"])], seen["cache"] = out
        return out

    def decoded():
        lg = [seen["logits"][p] for p in sorted(seen["logits"])]
        leaves = _cache_tensors(seen["cache"])
        seen.update(logits={}, cache=None)
        return lg, leaves

    def serve(reqs_):
        tickets = [sched.submit(r) for r in reqs_]
        sched.run_until_idle()
        return tickets

    _clear(rec)
    lm.decode_step = recording
    try:
        clean, ms, launched = _timed(lambda: serve(traffic))
    finally:
        lm.decode_step = real_step
    clean_decode = decoded()
    _need(paths_launched, "ssm mixed round", launched, riemann)
    _mixed_ok("ssm mixed round", clean, traffic, rec, V)
    prompts = torch.as_tensor(np.stack([r.tokens for r in traffic[:n_gen]]), device=DEV)
    want = ServeEngine(cfg, params, S + new, device=DEV).generate({"tokens": prompts}, new)
    if not np.array_equal(want.cpu().numpy(), np.stack([t.tokens for t in clean[:n_gen]])):
        raise AssertionError("ssm mixed: the scheduler's greedy tokens are not ServeEngine.generate's")
    print(f"  mixed: MixedScheduler(decode_chunk={dchunk}) over ig at m={m_mix}, {n_gen} greedy generates of "
          f"{S}+{new} and {n_exp} explain-only: {ms:.1f} ms, decode {_decode_ms(rec, n_gen):.2f} ms a token at B={n_gen}; tokens "
          f"ServeEngine.generate's")

    def faulted_round(name: str):
        fired, armed = [], []

        def faulty_step(*a, **kw):
            if armed:
                armed[0] += 1
                if armed[0] == SSM_FAULT[1]:
                    armed.clear()
                    fired.append(int(a[2]["len"]))
                    raise RuntimeError("injected fault inside a decode chunk")
            return recording(*a, **kw)

        def hook(kind, payload):
            if kind == "decode" and not fired and not armed and int(payload.cache["len"]) >= SSM_FAULT[0]:
                armed.append(0)

        _clear(rec)
        d0 = eng.stats.degraded
        sched.fault_hook, lm.decode_step = hook, faulty_step
        try:
            tickets, ms_, launched_ = _timed(lambda: serve(traffic))
        finally:
            sched.fault_hook, lm.decode_step = None, real_step
        _need(paths_launched, name, launched_, riemann)
        if not fired or eng.stats.degraded != d0:
            raise AssertionError(f"{name}: fired at {fired}, degraded {eng.stats.degraded - d0}")
        _mixed_ok(name, tickets, traffic, rec, V)
        return tickets, decoded(), ms_, fired[0]

    faulted, got, ms, at = faulted_round("ssm mixed faults")
    _same_bits("ssm mixed faults vs the clean round", faulted, clean)
    if not _same_decode(got, clean_decode):
        raise AssertionError("ssm mixed faults: the retried round's decode logits or SSM states are not the clean "
                             "round's bit for bit")
    print(f"  fault round ({ms:.1f} ms): the fault at decode position {at} (step {SSM_FAULT[1]} of its chunk) "
          f"retried to the clean tokens and bits, its {len(clean_decode[0])} steps' logits and every state and "
          "conv tail bit for bit; nothing degraded")
    real_snapshot = blocks.decode_snapshot
    blocks.decode_snapshot = lambda *a, **kw: lambda: None
    try:
        _, got, ms, _ = faulted_round("ssm mixed faults, states unsaved")
    finally:
        blocks.decode_snapshot = real_snapshot
    if _same_decode(got, clean_decode):
        raise AssertionError("ssm mixed faults: with the states unsaved the retry still gave the clean round's "
                             "logits and states, so the gate above cannot fail")
    print(f"  control ({ms:.1f} ms): the same fault with the SSM states unsaved gives other logits and states")
    print(f"  peak device memory over the ssm phase: {_peak_gb():.2f} GB")
    return {"launches": dict(common.LAUNCHES), "carry_ranks": dict(common.CARRY_RANKS),
            "per_path": paths_launched}


def hybrid_phase() -> dict:
    """jamba-v0.1-52b at full width, 5 layers (M_D M_E M_D M_E A_D: no
    whole period; bf16, flash attention): ``ExplainEngine`` ``ig`` over 6
    requests of 17–128 tokens served twice, and a greedy generate."""
    from repro_torch.kernels import common
    from repro_torch.models import lm
    from repro_torch.models.registry import Model
    from repro_torch.serve import ExplainEngine, ServeEngine
    from repro_torch.serve.batching import plan_buckets

    _free_card()
    cfg = _arch("jamba-v0.1-52b", HYBRID_LAYERS, attn_impl="flash")
    common.reset_launches()  # the slice's own count starts here
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    reqs = _lm_traffic(cfg, (HYBRID_TRAFFIC,), seed=7)
    plan = plan_buckets(reqs)
    chunk = _fitting_chunk(cfg, plan)
    print(f"hybrid: {cfg.name} at full width, {cfg.num_layers} layers ({cfg.num_periods} periods; "
          f"{' '.join(s.mixer[0].upper() + '_' + {'dense': 'D', 'moe': 'E'}[s.ffn] for s in cfg.layer_specs)}), "
          f"d={cfg.d_model}, "
          f"{cfg.num_experts} experts top-{cfg.experts_per_tok} of {cfg.moe_d_ff}, SSD {cfg.ssm_heads} heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, {cfg.compute_dtype}; {cfg.param_count() / 1e9:.3f}B "
          f"parameters; {len(reqs)} requests in buckets (B×S) {[f'{bb.bucket[0]}x{bb.bucket[1]}' for bb in plan]}; "
          f"m={M}, chunk {chunk} (the largest whose predicted peak fits {PEAK_BUDGET / 1e9:.0f} GB)")
    paths_launched = {}
    eng = ExplainEngine(cfg, params, method="ig", schedule="paper", m=M, n_int=N_INT, chunk=chunk, attn="flash",
                        device=DEV)
    _served_twice("hybrid ig unfused", eng, reqs, paths_launched, PATH_KERNELS["riemann"][0] + FLASH)
    _profile("hybrid engine ig unfused (warm)", lambda: eng.explain(reqs))
    del eng
    Bs, S, n_new = HYBRID_GEN
    g = torch.Generator(device=DEV).manual_seed(5)
    prompts = _prompts(g, cfg, Bs, S)
    model, seng = Model(cfg), ServeEngine(cfg, params, S + n_new, device=DEV)
    seng.generate({"tokens": prompts}, 2)  # warm
    out, ms = _generated(paths_launched, f"hybrid greedy {Bs}x{S}+{n_new}",
                         lambda: seng.generate({"tokens": prompts}, n_new), cfg.vocab_size)
    print(f"  greedy, {Bs} prompts of {S}, {n_new} new: {ms:.1f} ms")
    with _moe_calls() as tf_calls:
        tf = _teacher_forced(model, params, prompts, out, S + n_new)
    with _moe_calls() as fresh_calls:
        fresh = _fresh(model, params, prompts, out)
    # printed only: the prefill and the fresh forward route all their tokens together and decode B
    # at a time, so capacity drops differ, and a router's near tie may part two bf16 paths
    _row_close("hybrid bf16 decode vs fresh forward (dropped at most "
               f"{max(c['dropped'] for c in tf_calls):.4f} of a prefill's or decode step's slots, "
               f"{max(c['dropped'] for c in fresh_calls):.4f} of the fresh forward's, a layer)",
               tf, fresh, ENGINE_TOL, gate=False)
    print(f"  peak device memory over the hybrid phase: {_peak_gb():.2f} GB")
    return {"launches": dict(common.LAUNCHES), "carry_ranks": dict(common.CARRY_RANKS),
            "per_path": paths_launched}


def _setup() -> None:
    """The checkout's package on the path and the numerics every run of
    this script takes (the warm-state children too: their bits are held to
    this process's)."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # fixed cuDNN algorithms: a resumed rung must see the same gradients as
    # the fixed run it is compared with, bit for bit
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    _setup()
    from repro_torch.kernels import common  # fails, printing nothing, outside a checkout

    if sys.argv[1:2] == ["--warm-child"]:
        mode, directory = sys.argv[2:4]
        return warm_child(mode, directory)
    print(_card())
    triton, _ = common.import_triton()  # sets the compile cache first
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton {triton.__version__}")

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.lstsq import kernel as lk

    t0 = time.perf_counter()
    built = lambda load: (load(), time.perf_counter() - t0)[1]
    with ThreadPoolExecutor(2) as pool:  # one nvcc per CUDA source, while Triton compiles
        builds = [pool.submit(built, load) for load in (fk.load_library, lk.load_library)]
        records = kernel_phase()
        build_s = [b.result() for b in builds]
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s (Triton builds included); CUDA libraries "
          f"(flash, solve) built in {build_s[0]:.1f} and {build_s[1]:.1f} s beside it")
    t0 = time.perf_counter()
    records += flash_kernel_phase()
    records.append(solve_kernel_phase())
    print(f"CUDA kernel phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_kernel_phase(records)
    print(f"LM-shape kernel phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_kernel_phase(records)
    print(f"prefill-shape flash phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gemma_kernel_phase(records)
    print(f"gemma3-shape kernel phase: {time.perf_counter() - t0:.1f} s")
    slices = {}
    for name, phase in (("cnn", slice_phase), ("cnn_zoo", zoo_phase), ("vit", lambda: vit_phase("ig")),
                        ("vit_idgi", lambda: vit_phase("idgi")), ("vit_fwd", vit_fwd_phase),
                        ("lm_engine", engine_phase), ("cache", cache_phase), ("serve", serve_phase),
                        ("mixed", mixed_phase),
                        ("gemma_serve", gemma_serve_phase), ("gemma_engine", gemma_engine_phase),
                        ("gemma_mixed", gemma_mixed_phase), ("moe_engine", moe_engine_phase),
                        ("moe_serve", moe_serve_phase), ("ssm", ssm_phase), ("hybrid", hybrid_phase)):
        t0 = time.perf_counter()
        slices[name] = phase()
        print(f"{name} slice phase: {time.perf_counter() - t0:.1f} s")
        print(f"{name} launches per path (one call each):", json.dumps(slices[name]["per_path"]))
    for r in records:
        r["launches_by_slice"] = {n: out["launches"][r["name"]] for n, out in slices.items()}
        r["launches"] = sum(r["launches_by_slice"].values())
    # interp_add's launches by carry rank: the riemann class's fused paths
    # broadcast a (B, F) carry, IDGI's fused path takes a (B, K, F) one
    ia = next(r for r in records if r["name"] == "interp_add")
    ia["launches_by_carry"] = {n: {"broadcast": out["carry_ranks"][2], "per_step": out["carry_ranks"][3]}
                               for n, out in slices.items()}
    print("interp_add launches by carry rank, per slice:", json.dumps(ia["launches_by_carry"]))
    for name, out in slices.items():
        if sum(out["carry_ranks"].values()) != out["launches"]["interp_add"]:
            raise AssertionError(f"slice {name}: interp_add's carry ranks {out['carry_ranks']} do not add "
                                 f"up to its {out['launches']['interp_add']} launches")
    for name, rank in (("cnn", 3), ("vit", 3), ("vit_idgi", 2), ("gemma_engine", 3), ("moe_engine", 3),
                       ("ssm", 3), ("hybrid", 3)):
        if slices[name]["carry_ranks"][rank]:
            raise AssertionError(f"slice {name} launched interp_add with a rank-{rank} carry: "
                                 f"{slices[name]['carry_ranks']}")
    # each slice launched every kernel of its paths, and the IDGI slice no riemann kernel
    for name, out in slices.items():
        want = {k for path in out["per_path"].values() for k, n in path.items() if n}
        missing = [k for k in want if not out["launches"][k]]
        if missing or not want:
            raise AssertionError(f"slice {name}: kernels not launched {missing}")
    if slices["vit_idgi"]["launches"]["ig_accum"] or slices["vit_idgi"]["launches"]["accum_cot"]:
        raise AssertionError(f"the IDGI slice launched a riemann kernel: {slices['vit_idgi']['launches']}")
    for name in ("serve", "gemma_serve", "moe_serve"):
        if slices[name]["launches"]["flash_bwd_dq"] or slices[name]["launches"]["flash_bwd_dkv"]:
            raise AssertionError(f"the {name} slice launched a backward kernel: {slices[name]['launches']}")
    for name, fused in (("gemma_engine", True), ("moe_engine", True), ("hybrid", False)):
        missing = [k for k in FLASH + PATH_KERNELS["riemann"][0] + (PATH_KERNELS["riemann"][1] if fused else ())
                   if not slices[name]["launches"][k]]
        if missing:
            raise AssertionError(f"the {name} slice did not launch {missing}")
    if any(slices["ssm"]["launches"][k] for k in FLASH):  # mamba2 has no attention
        raise AssertionError(f"the ssm slice launched a flash kernel: {slices['ssm']['launches']}")
    fwd_only = {k: n for k, n in slices["vit_fwd"]["launches"].items() if n}
    if set(fwd_only) != {"flash_fwd", "wls_solve"}:
        raise AssertionError(f"the forward-only slice launched {fwd_only}, not only flash_fwd and wls_solve")
    for r in records:
        if not r["launches"]:
            raise AssertionError(f"kernel {r['name']} not launched on any slice: {r['launches_by_slice']}")
    print(json.dumps({"kernels": records}))
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
