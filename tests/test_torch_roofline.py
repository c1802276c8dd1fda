"""``roofline.hotpath_cost`` on the MoE, SSM and hybrid LMs, on the CPU.

The analytic cost of one fixed-m bucket call of the explain engine is held
to what the port's own call does on reduced configs (qwen3-moe-30b-a3b,
mamba2-780m, jamba-v0.1-52b at 5 layers; f32):

  * FLOPs against ``torch.utils.flop_counter`` over the call, within 1%
    (the rest is the norms' weights, which the count takes as
    projections), and within 2% for MoE at m=8: the count prices the
    probe's forwards as one call of B·probe_forwards rows, where the
    engine makes two (the probe's points, then the endpoints), whose
    smaller capacities pad more (1.3% measured);
  * the activations saved per token and layer against the bytes autograd
    saves (``saved_tensors_hooks``, each storage once), as the slope
    between two token counts, so the weights' casts cancel: never below,
    and within 2× (an upper count);
  * the per-token counts against a hand count of the reduced shapes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import roofline
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import lm
from repro_torch.models.registry import Model
from repro_torch.roofline import analyze
from repro_torch.serve import ExplainEngine, ExplainRequest
from repro_torch.serve.batching import plan_buckets

torch.set_num_threads(1)

MODELS = {"qwen3": ("qwen3-moe-30b-a3b", 2), "mamba2": ("mamba2-780m", 2), "jamba": ("jamba-v0.1-52b", 5)}


def _cfg(key, **kw):
    name, layers = MODELS[key]
    return dataclasses.replace(reduced(ARCHS[name]), num_layers=layers, compute_dtype="float32", **kw)


def _params(cfg):
    return lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def _req(S, seed=0):
    rng = np.random.default_rng(seed)
    return ExplainRequest(rng.integers(1, 512, S).astype(np.int32), int(rng.integers(0, 512)))


@pytest.mark.parametrize("key,S,m,chunk", [("qwen3", 16, 8, 4), ("qwen3", 32, 8, 8), ("mamba2", 32, 8, 4),
                                           ("mamba2", 37, 4, 2), ("jamba", 32, 8, 4)])
def test_hotpath_flops_match_the_flop_counter(key, S, m, chunk, monkeypatch):
    """MoE layers priced by their expert slots (the active parameters plus
    the capacity's padding), SSD layers by their chunk products (37 tokens:
    chunk 1), attention over all S² pairs (the plain attention's)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = _cfg(key)
    eng = ExplainEngine(cfg, _params(cfg), method="ig", m=m, chunk=chunk, n_int=4, seq_buckets=(S,),
                        device="cpu")
    bb = plan_buckets([_req(S), _req(S, seed=1)], seq_buckets=(S,))[0]
    with FlopCounterMode(display=False) as fc:
        eng._attr_fn_at(eng._cfg_for(bb.bucket))(*eng._bucket_inputs(bb))
    monkeypatch.setattr(analyze, "_causal_pairs", lambda S, window: S * S)
    want = roofline.hotpath_cost(eng.cfg, bb.bucket, m, chunk, "float32",
                                 probe_forwards=eng._forwards_a_row(with_fx=False))["flops"]
    assert abs(fc.get_total_flops() / want - 1) < (0.02 if key == "qwen3" and m == 8 else 0.01)


def test_moe_flops_use_the_active_parameters():
    """Full width: 2 FLOPs per active weight and token (k of E experts) plus
    the buffer's padded slots, not 2 per weight of every expert."""
    cfg = dataclasses.replace(ARCHS["qwen3-moe-30b-a3b"], num_layers=4)
    B, S, m = 4, 128, 8
    got = roofline.hotpath_cost(cfg, (B, S), m, m, "bfloat16")["flops"]
    d, f, V, E, k = cfg.d_model, cfg.moe_d_ff, cfg.vocab_size, cfg.num_experts, cfg.experts_per_tok
    attn = d * 128 * (32 + 2 * 4) + 32 * 128 * d  # wq, wk, wv, wo
    layer = 2 * d + attn + d * E + k * 3 * d * f  # norms, attention, router, the k experts reached
    assert cfg.active_param_count() - 2 * V * d == 4 * layer
    C = 8 * (B * m * S * k * 5 // 4 // E // 8)  # capacity of the call's tokens: 1.25·k/E of them, a multiple of 8
    padded = 2 * 3 * d * f * (E * C - B * m * S * k)  # slots computed beyond the tokens' choices
    pairs = S * (S + 1) // 2
    fwd = 2 * S * 4 * layer + 2 * d * V + 4 * (4 * 32 * 128 * pairs)
    bwd = 2 * S * 4 * layer + 2 * d * V + 4 * (8 * 32 * 128 * pairs)
    assert got == B * m * (fwd + bwd) + 2 * 4 * padded
    dense = 2 * S * (cfg.param_count() - 2 * V * d)
    assert got < 0.2 * B * m * 2 * dense  # all 128 experts would cost over 5 times as much


def test_an_ssm_layer_has_no_attention_pairs(monkeypatch):
    costs = lambda key: [roofline.hotpath_cost(_cfg(key), (2, 32), 8, 4, "float32")["flops"] for _ in (0, 1)]
    before = {k: costs(k) for k in MODELS}
    monkeypatch.setattr(analyze, "_causal_pairs", lambda S, window: 10**9)
    after = {k: costs(k) for k in MODELS}
    assert after["mamba2"] == before["mamba2"]  # attention-free
    assert after["qwen3"] > before["qwen3"] and after["jamba"] > before["jamba"]
    # jamba's one attention layer of five: a fifth of qwen3's two of two, per pair
    jump = {k: after[k][0] - before[k][0] for k in ("qwen3", "jamba")}
    assert jump["qwen3"] == 2 * jump["jamba"]


def _saved_bytes(cfg, params, B, S):
    """Bytes of the distinct storages autograd saves in one forward of the
    backbone over (B, S) embeddings that require grad."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t

    e = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(1), requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        lm.hidden_from_embeds(cfg, params, e)
    return sum(seen.values())


@pytest.mark.parametrize("key", ["qwen3", "mamba2", "jamba"])
def test_saved_bytes_bound_what_autograd_saves(key):
    """Per token, over every layer: the slope between 16 and 32 rows of 16
    tokens (MoE capacities 64 and 128 slots, exact, so the slots per token
    stay 2.5)."""
    cfg = _cfg(key)
    params = _params(cfg)
    S, rows = 16, (16, 32)
    measured = [_saved_bytes(cfg, params, B, S) for B in rows]
    per_token = (measured[1] - measured[0]) / ((rows[1] - rows[0]) * S)
    slots = analyze._slots_per_token(cfg, rows[0] * S) if cfg.num_experts else 0.0
    assert not cfg.num_experts or slots == analyze._slots_per_token(cfg, rows[1] * S) == 2.5
    predicted = sum(analyze._saved_per_token_layer(cfg, s, 4, S, slots) for s in cfg.layer_specs)
    assert per_token <= predicted <= 2 * per_token, (per_token, predicted)


def test_saved_bytes_by_hand():
    """Reduced qwen3's (attn, moe) layer and mamba2's (mamba, none) layer at
    S=16, f32 (d=64, 4 heads of 16 on 2; 8 experts top-2 of 32; d_inner 128
    in 8 heads of 16, state 16)."""
    qwen, mamba = _cfg("qwen3"), _cfg("mamba2")
    slots = analyze._slots_per_token(qwen, 16 * 16)
    assert slots == 8 * 80 / 256  # capacity 256·2·1.25/8 = 80
    norms = 2 * 64 * (4 + 4)
    attn = (64 + 2 * 32) * 4 + (64 + 32) * 4 + 64 * 4 + 4 * 4  # q k v, RoPE'd q k, out, lse
    ffn = slots * (64 + 4 * 32) * 4 + 2 * 64 * 4 + 4 * 3 * 8 + 8 * 2  # buffer and slots, gathered, router
    assert analyze._saved_per_token_layer(qwen, qwen.pattern[0], 4, 16, slots) == norms + attn + ffn + 2 * 64 * 4
    ssd = ((2 * 128 + 2 * 16 + 8) * 4 + 2 * 4 * (128 + 32) + 4 * (7 * 128 + 4 * 16 + 8 * 8)
           + 4 * 16 * (3 * 8 + 1) + 4 * 8 * 16 * 16 * 2 / 16 + 4 * 4 * 128)  # one chunk of 16: no scan step
    assert analyze._saved_per_token_layer(mamba, mamba.pattern[0], 4, 16, 0.0) == 64 * (4 + 4) + ssd + 64 * 4
    assert Model(mamba) and Model(qwen)
