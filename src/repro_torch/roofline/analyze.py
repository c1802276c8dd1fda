"""Hardware models and the stage-2 cost model: ``repro.roofline.analyze``.

``Hardware``, the ``HW_*`` rows, ``hardware_for`` and ``hotpath_terms`` are
``repro``'s, plus ``HW_H100``, matched by ``"h100"`` ahead of the generic
GPU rows (ROADMAP.md queue 3: a deliberate difference). ``repro`` prices a
candidate from the compiled program's ``cost_analysis``; the port has no
compiler to ask, so ``hotpath_cost`` counts one fixed-m bucket call of the
LM from its config and shapes instead. The autotuner
(``serve.autotune``) ranks candidates with these numbers before it measures
any, and the engine reports them on ``BucketStats``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models.moe import capacity
from repro_torch.models.ssm import chunk_len


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float  # per chip, bf16 dense
    hbm_bw: float  # bytes/s per chip
    link_bw: float  # bytes/s per link and direction
    hbm_bytes: float  # capacity per chip


HW_V5E = Hardware(name="tpu_v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9, hbm_bytes=16e9)
# round generic-class figures: they only rank candidates before the measured sweep
HW_GENERIC_GPU = Hardware(name="generic_gpu", peak_flops=300e12, hbm_bw=2000e9, link_bw=300e9,
                          hbm_bytes=80e9)
HW_CPU_HOST = Hardware(name="cpu_host", peak_flops=2e12, hbm_bw=100e9, link_bw=25e9, hbm_bytes=64e9)
# NVIDIA's H100 SXM data sheet: bf16 dense, HBM3, NVLink 4 (900 GB/s both ways), 80 GB
HW_H100 = Hardware(name="h100", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9, hbm_bytes=80e9)

# substring of the lowercased device kind -> hardware model; the first hit wins
HW_BY_KIND: tuple[tuple[str, Hardware], ...] = (
    ("h100", HW_H100),
    ("tpu v5 lite", HW_V5E),
    ("tpu", HW_V5E),
    ("cpu", HW_CPU_HOST),
    ("gpu", HW_GENERIC_GPU),
    ("cuda", HW_GENERIC_GPU),
    ("nvidia", HW_GENERIC_GPU),
)


def hardware_for(device_kind: str) -> Hardware:
    """A device kind -> its hardware model; an unknown kind is GPU-class.

        >>> hardware_for("cpu").name, hardware_for("TPU v5 lite").name
        ('cpu_host', 'tpu_v5e')
        >>> hardware_for("nvidia_h100_80gb_hbm3").name
        'h100'
    """
    kind = device_kind.lower()
    for sub, hw in HW_BY_KIND:
        if sub in kind:
            return hw
    return HW_GENERIC_GPU


def hotpath_terms(cost: dict, hw: Hardware) -> dict:
    """Roofline terms of one stage-2 call's cost dict (``"bytes accessed"``,
    ``"flops"``): ``{bytes_accessed, flops, memory_s, compute_s, bound_s,
    dominant}``, ``bound_s`` the larger of the two times."""
    nbytes = float(cost.get("bytes accessed", 0.0))
    flops = float(cost.get("flops", 0.0))
    memory_s = nbytes / hw.hbm_bw
    compute_s = flops / hw.peak_flops
    return {
        "bytes_accessed": nbytes,
        "flops": flops,
        "memory_s": memory_s,
        "compute_s": compute_s,
        "bound_s": max(memory_s, compute_s),
        "dominant": "memory" if memory_s >= compute_s else "compute",
    }


def _itemsize(dtype: Any) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def _causal_pairs(S: int, window: int) -> int:
    """(query, key) pairs of one causal sequence of S, keys within
    ``window`` of their query when it is set."""
    if window and window < S:
        return window * (window + 1) // 2 + (S - window) * window
    return S * (S + 1) // 2


def _slots_per_token(cfg: Any, tokens: int) -> float:
    """Expert slots a MoE layer computes per routed token: E·C over the
    call's tokens, C the capacity, about k times the capacity factor."""
    return cfg.num_experts * capacity(tokens, cfg) / tokens


def _saved_per_token_layer(cfg: Any, spec: Any, cs: int, S: int, slots: float) -> float:
    """Bytes autograd keeps per token of a layer of kind ``spec`` for the
    backward, counted from the block's tensors (an upper count: not every
    one is saved). ``slots`` is ``_slots_per_token`` of the call."""
    d = cfg.d_model
    norms = (1 if spec.ffn == "none" else 2) * d * (4 + cs)  # RMSNorms: f32 upcast and normed output
    residual = (1 if spec.ffn == "none" else 2) * d * cs
    if spec.mixer == "mamba":
        di, H, P, N, GN = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups * cfg.ssm_state
        cl = chunk_len(S, cfg.ssm_chunk)
        steps = max(S // cl - 1, 0).bit_length()  # the chunk scan's doubling steps
        mixer = (cs * (2 * di + 2 * GN + H)  # the projections z, x, B, C, dt
                 + 2 * cs * (di + 2 * GN)  # the conv's output and its silu
                 + 4 * (7 * di + 4 * GN + 8 * H)  # f32 x, x·dt and its products, B, C, the norm's; dt, cum
                 + 4 * cl * (3 * H + cfg.ssm_groups)  # L, L∘C·Bᵀ and its product; C·Bᵀ per group
                 + 4 * H * P * N * (2 + steps) / cl  # chunk states, the scan's steps, the states entering
                 + 4 * cs * di)  # the gated norm's inputs and the out projection's
    else:
        D = cfg.resolved_head_dim
        q, kv = cfg.num_heads * D, cfg.num_kv_heads * D
        mixer = (q + 2 * kv) * cs + (q + kv) * cs + q * cs + 4 * cfg.num_heads  # q k v, RoPE'd q k, out, lse
    if spec.ffn == "moe":
        f, E, k = cfg.moe_d_ff or cfg.d_ff, cfg.num_experts, cfg.experts_per_tok
        # the (E, C, d) buffer and gate, up, act and act·up (E, C, f) per slot; the k
        # gathered outputs (T, k, d) the gates' gradient reads; the f32 router
        ffn = slots * (d + 4 * f) * cs + k * d * cs + 4 * 3 * E + 8 * k
    elif spec.ffn == "dense":
        ffn = 4 * cfg.d_ff * cs  # gate, up, act(gate), act(gate)·up
    else:
        ffn = 0
    return norms + mixer + ffn + residual


def _layer_flops(cfg: Any, spec: Any, S: int, slots: float) -> tuple[float, float]:
    """(forward, activations-only backward) FLOPs of one sequence of S
    tokens through a layer beyond its dense weights' 2 per weight and
    token: the attention's QKᵀ and PV over its causal (windowed) pairs, an
    SSD's intra- and inter-chunk products, a MoE layer's expert slots
    (all E·C of them, computed whether filled or not) in place of the k
    experts a token reaches."""
    if spec.mixer == "mamba":
        di, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
        cl = chunk_len(S, cfg.ssm_chunk)
        # C·Bᵀ per group, (C·Bᵀ ∘ L)·x·dt, the chunk states and C·state per token
        mixer = S * (2 * cl * (G * N + di) + 4 * di * N)
        fwd, bwd = mixer, 2 * mixer
    elif spec.mixer in ("attn", "local"):
        pairs = _causal_pairs(S, cfg.sliding_window if spec.mixer == "local" else 0)
        fwd, bwd = 4 * cfg.num_heads * cfg.resolved_head_dim * pairs, 8 * cfg.num_heads * cfg.resolved_head_dim * pairs
    else:
        fwd = bwd = 0
    if spec.ffn == "moe":
        f = cfg.moe_d_ff or cfg.d_ff
        extra = 2 * S * (slots - cfg.experts_per_tok) * 3 * cfg.d_model * f  # the padded slots
        fwd, bwd = fwd + extra, bwd + extra
    return fwd, bwd


def hotpath_cost(cfg: Any, bucket: tuple[int, int], m: int, chunk: int, dtype: Any, *,
                 probe_forwards: int = 0, fused: bool = False) -> dict:
    """Cost of one fixed-m bucket call of the LM (``ArchConfig``) explainer:
    ``{"flops", "bytes accessed", "peak bytes"}``.

    ``bucket`` is (B, S), ``m`` the steps a row, ``chunk`` the steps a model
    call (0: all m), ``dtype`` the compute dtype (the weights are
    ``cfg.param_dtype``), ``probe_forwards`` the forwards a row runs
    besides stage 2 (stage 1's probe and the endpoints).

      * FLOPs: the forward and the activations-only backward (the weights
        take no gradient) of B·m interpolants, plus B·probe_forwards
        forwards: 2 per weight a token reaches (``active_param_count``: a
        MoE token reaches k experts) for the projections (not the SSM's
        depthwise conv, A and D, whose work is elementwise), each layer's own
        work (``_layer_flops``: the attention's QKᵀ and PV over its causal
        (windowed) pairs, twice that backward; the SSD's chunk products;
        the MoE buffer's padded slots, whose count follows the capacity of
        the call's tokens, B·chunk·S in stage 2 (the one place the chunk
        enters) and B·probe_forwards·S for the probe's forwards, priced as
        one call where the engine makes two, the points' and the
        endpoints'), and the logits at one position a row. (The flash kernels skip the pairs a causal mask
        drops; the plain attention computes all S² of them.)
      * Bytes: the weights read once per model call (m/chunk of them, and
        one for the probe; a MoE call reads every expert) and the riemann
        stage-2 kernels' bytes (interpolate + ig_accum unfused, interp_add
        + accum_cot fused: each input read and output written once),
        counted as ``chip_smoke.py``'s bound specs count them.
      * Peak: the weights, their compute-dtype copies (each layer's is
        saved for the backward: every expert's), the activations saved per
        token and layer for B·chunk·S tokens (``_saved_per_token_layer``, by
        the layer's kind), the logits the target reads (compute dtype, f32
        upcast, f32 log-softmax) and the stage-2 buffers.

        >>> from repro_torch.configs import ARCHS
        >>> from dataclasses import replace
        >>> cfg = replace(ARCHS["llama3-8b"], num_layers=4)
        >>> c = hotpath_cost(cfg, (16, 128), 64, 64, "bfloat16")
        >>> c["peak bytes"] > 80e9 > hotpath_cost(cfg, (16, 128), 64, 16, "bfloat16")["peak bytes"]
        True
    """
    B, S = bucket
    chunk = chunk or m
    if m % chunk:
        raise ValueError(f"chunk {chunk} must divide m {m}")
    cs, ps = _itemsize(dtype), _itemsize(cfg.param_dtype)
    d, V = cfg.d_model, cfg.vocab_size
    embed = V * d  # the input table: stage 2 starts from embeddings
    n_embed = 1 if cfg.tie_embeddings else 2
    p_all = cfg.param_count()
    p_read = p_all - (0 if cfg.tie_embeddings else embed)
    # the weights of products: every layer weight a token reaches but the SSM's conv, A and D
    p_active = (cfg.active_param_count() - embed * n_embed
                - sum(cfg.d_inner * cfg.ssm_conv + 2 * cfg.ssm_heads
                      for s in cfg.layer_specs if s.mixer == "mamba"))
    rows = B * chunk
    mm = 2 * S * p_active + 2 * d * V  # projections of every token, one logits row

    def per_row(call_rows: int) -> tuple[float, float]:
        """(forward, backward) FLOPs a row in a call of ``call_rows`` rows."""
        slots = _slots_per_token(cfg, call_rows * S) if cfg.num_experts else 0.0
        extra = [_layer_flops(cfg, s, S, slots) for s in cfg.layer_specs]
        return mm + sum(f for f, _ in extra), mm + sum(b for _, b in extra)

    fwd, bwd = per_row(rows)
    flops = B * m * (fwd + bwd) + (B * probe_forwards * per_row(B * probe_forwards)[0] if probe_forwards else 0)

    calls = m // chunk
    F = S * d
    if fused:  # interp_add (x, b, alphas, the f32 carry) + accum_cot
        stage2 = cs * (2 * B * F + B * chunk * F) + 4 * (B * chunk + B * F) + cs * B * chunk * F + 4 * B * F
    else:  # interpolate (x, b, alphas) + ig_accum (grads, weights, the f32 acc read and written)
        stage2 = cs * (2 * B * F + B * chunk * F) + 4 * B * chunk + cs * B * chunk * F + 4 * B * chunk + 8 * B * F
    nbytes = (calls + (1 if probe_forwards else 0)) * p_read * ps + calls * stage2

    slots = _slots_per_token(cfg, rows * S) if cfg.num_experts else 0.0
    saved = sum(_saved_per_token_layer(cfg, s, cs, S, slots) for s in cfg.layer_specs)
    peak = (p_all * ps
            + (p_read * cs if cs != ps else 0)
            + saved * rows * S
            + rows * V * (cs + 8)
            + 2 * cs * rows * F + 12 * B * F)
    return {"flops": float(flops), "bytes accessed": float(nbytes), "peak bytes": float(peak)}


__all__ = ["Hardware", "HW_V5E", "HW_GENERIC_GPU", "HW_CPU_HOST", "HW_H100", "HW_BY_KIND",
           "hardware_for", "hotpath_terms", "hotpath_cost"]
