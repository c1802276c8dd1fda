"""The port's dry run against ``repro``'s, on the CPU.

Exact for every architecture of ``ARCHS`` × the four ``LM_SHAPES``:
``shape_applicable``, ``input_specs`` (shapes and dtypes of every leaf, in
``jax.tree_util``'s order, against ``repro``'s ``ShapeDtypeStruct``
trees, whose decode caches ``jax.eval_shape`` makes), ``model_flops``, and
``abstract_train_state`` per architecture. ``roofline_report``'s ``row()``
on fixed inputs at ``HW_V5E``; ``choose_kv_slots`` and ``make_policy`` on
shape-only meshes; ``constrain``'s spec at the shapes of the twelve sites
where ``repro`` constrains (``jax.lax.with_sharding_constraint``
monkeypatched to hand back the spec it is given).

The matrix products of reduced cells counted on ``meta`` by
``roofline.op_counts`` against ``repro``'s ``dot_flops_summary`` of the
same cell lowered on a 1×1 ``jax.sharding.Mesh`` (Auto axes) under
``costing_mode()``: exactly equal (rtol 1e-9) on llama3-8b prefill and
decode, qwen3-moe-30b-a3b decode, gemma3-27b prefill and whisper-tiny
prefill; equal up to a stated term on two cells whose programs differ:
llama3-8b's train step counts one (B·S·d·V) logits product more (the
port recomputes each loss chunk's logits in the backward, where ``repro``
keeps them), mamba2-780m's prefill counts the C·Bᵀ products once per
group where ``repro`` forms them per head. The counts on CPU tensors equal
the counts on ``meta``.
"""
import numpy as np
import pytest
import jax
import torch

from repro.configs import ARCHS as J_ARCHS, LM_SHAPES as J_SHAPES, reduced as j_reduced
from repro.configs.base import ShapeConfig as JShape, shape_applicable as j_shape_applicable
from repro.launch.cells import build_cell as j_build_cell, choose_kv_slots as j_choose_kv_slots, lower_cell
from repro.models.common import costing_mode
from repro.models.registry import input_specs as j_input_specs
from repro.roofline import HW_V5E as J_HW_V5E, model_flops as j_model_flops, roofline_report as j_roofline_report
from repro.roofline.hlo_flops import dot_flops_summary
import repro.sharding.context as jctx
from repro.train.step import TrainConfig as JTrainConfig, abstract_train_state as j_abstract_train_state
from repro_torch.configs import ARCHS, LM_SHAPES, ShapeConfig, reduced, shape_applicable
from repro_torch.launch.cells import ShapeMesh, build_cell, choose_kv_slots, count_cell, materialize
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import input_specs
from repro_torch.roofline import HW_V5E, model_flops, roofline_report
from repro_torch.sharding import context as ctx
from repro_torch.train.step import TrainConfig, abstract_train_state

CELLS = [(a, s.name) for a in ARCHS for s in LM_SHAPES]
J_SHAPE = {s.name: s for s in J_SHAPES}
T_SHAPE = {s.name: s for s in LM_SHAPES}


class FakeMesh:
    """Duck-typed mesh (axis names, a devices array of the mesh's shape)."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=object)


MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}, {"data": 2, "model": 4},
          {"data": 1, "model": 1}]


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _leaves(tree):
    return [(tuple(x.shape), _dtype_name(x.dtype)) for x in tree_leaves(tree)]


def _j_leaves(tree):
    return [(tuple(x.shape), str(np.dtype(x.dtype))) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}:{s}" for a, s in CELLS])
def test_shapes_specs_and_model_flops(arch, shape):
    cfg, jcfg, s, js = ARCHS[arch], J_ARCHS[arch], T_SHAPE[shape], J_SHAPE[shape]
    assert shape_applicable(cfg, s) == j_shape_applicable(jcfg, js)
    assert model_flops(cfg, s) == j_model_flops(jcfg, js)
    if shape_applicable(cfg, s)[0]:
        assert _leaves(input_specs(cfg, s)) == _j_leaves(j_input_specs(jcfg, js))


def test_input_specs_with_kv_slots():
    for arch in ("llama3-8b", "internlm2-20b", "whisper-tiny"):
        got = input_specs(ARCHS[arch], T_SHAPE["decode_32k"], kv_slots=16)
        want = j_input_specs(J_ARCHS[arch], J_SHAPE["decode_32k"], kv_slots=16)
        assert _leaves(got) == _j_leaves(want), arch


@pytest.mark.parametrize("arch", list(ARCHS))
def test_abstract_train_state(arch):
    for comp in (False, True):
        got = abstract_train_state(ARCHS[arch], TrainConfig(grad_compression=comp))
        want = j_abstract_train_state(J_ARCHS[arch], JTrainConfig(grad_compression=comp))
        assert (got.err is None) == (want.err is None)
        assert _leaves(got) == _j_leaves(want)
        assert all(x.device.type == "meta" for x in tree_leaves(got))


def test_roofline_report_row():
    kw = dict(arch="llama3-8b", shape="train_4k", mesh_name="pod16x16", chips=256,
              cost={"flops": 3.5e15, "bytes accessed": 2.25e12}, coll_bytes_per_chip=7.5e10,
              mflops=4.1e17, peak_bytes_per_chip=6.0e10)
    for cost in (kw["cost"], {"flops": 1e12, "bytes accessed": 1e9}, {"flops": 1e9, "bytes accessed": 1e9}):
        got = roofline_report(**{**kw, "cost": cost}, hw=HW_V5E).row()
        want = j_roofline_report(**{**kw, "cost": cost}, hw=J_HW_V5E).row()
        assert got == want
    assert roofline_report(**kw).row() == j_roofline_report(**kw).row()  # both default to HW_V5E


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s.values())))
def test_kv_slots_and_policy(sizes):
    mesh = FakeMesh(sizes)
    for arch in ARCHS:
        for seq in (False, True):
            assert choose_kv_slots(ARCHS[arch], mesh, seq_sharded=seq) == \
                j_choose_kv_slots(J_ARCHS[arch], mesh, seq_sharded=seq)
    for seq in (False, True):
        got, want = ctx.make_policy(mesh, seq_sharded=seq), jctx.make_policy(mesh, seq_sharded=seq)
        assert (got.mapping, got.sizes) == (want.mapping, want.sizes)


def _sites(cfg, B, S):
    """(shape, logical names) of repro's twelve constrain sites at a cell's
    global shapes: attention.py:41-43, layers.py:61, :124, lm.py:83, :123,
    :210, :238, moe.py:71, :78, ssm.py:97."""
    d, H, KH, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    E = cfg.num_experts or 128
    rows = [((B, S, H, D), ("batch", "seq", "model", None)),
            ((B, S, KH, D), ("batch", "seq", "model", None)),
            ((B, S, KH, D), ("batch", "seq", "model", None)),
            ((B, S, cfg.d_ff or 4 * d), ("batch", "seq", "model")),
            ((B, 512, cfg.vocab_size), ("batch", None, "model")),
            ((B, S, d), ("batch", "seq", None)),
            ((B, S, d), ("batch", "seq", None)),
            ((B, S, d), ("batch", "seq", None)),
            ((B, 1, d), ("batch", "seq", None)),
            ((E, 8 * B, d), ("model", None, None)),
            ((E, 8 * B, d), ("model", None, None))]
    ssm = ARCHS["mamba2-780m"]
    rows.append(((B, S, ssm.ssm_heads, ssm.ssm_head_dim), ("batch", "seq", "model", None)))
    return rows


@pytest.mark.parametrize("sizes", MESHES[:3], ids=lambda s: "x".join(map(str, s.values())))
def test_constrain_specs_match_repro(sizes, monkeypatch):
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, spec: seen.append(tuple(spec)) or x)
    mesh = FakeMesh(sizes)
    for arch in ARCHS:
        for B, S in ((256, 4096), (32, 32768), (128, 1), (1, 524288), (6, 10)):
            for seq in (False, True):
                pol = ctx.make_policy(mesh, seq_sharded=seq)
                for shape, names in _sites(ARCHS[arch], B, S):
                    seen.clear()
                    with jctx.activation_sharding(mesh, seq_sharded=seq):
                        jctx.constrain(jax.ShapeDtypeStruct(shape, np.float32), *names)
                    got = ctx.activation_spec(pol, shape, names)
                    assert (tuple(got) if got is not None else None) == (seen[0] if seen else None), \
                        (arch, shape, names, seq)


def test_constrain_is_a_no_op_on_plain_tensors():
    x = torch.ones(4, 8, 16)
    with ctx.activation_sharding(FakeMesh({"data": 2, "model": 4})):
        assert ctx.constrain(x, "batch", "seq", "model") is x
        assert ctx.gathered({"w": x})["w"] is x
    assert ctx.constrain(x, "batch", "seq", None) is x


# ---------------------------------------------------------------- matmul FLOPs

def _j_dot_flops(arch, kind, B, S, kw):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with mesh, costing_mode():
        cell = j_build_cell(j_reduced(J_ARCHS[arch]), JShape("c", S, B, kind), mesh, **kw)
        return dot_flops_summary(lower_cell(cell).compile().as_text())["total_dot_flops"]


def _t_count(arch, kind, B, S, kw):
    return count_cell(build_cell(reduced(ARCHS[arch]), ShapeConfig("c", S, B, kind), ShapeMesh(), **kw))


def _logits_product(arch, B, S):
    cfg = reduced(ARCHS[arch])
    return 2 * B * S * cfg.d_model * cfg.vocab_size


def _ssd_heads_less_groups(arch, B, S):
    cfg = reduced(ARCHS[arch])
    cl = min(cfg.ssm_chunk, S)
    per_layer = 2 * B * (S // cl) * (cfg.ssm_heads - cfg.ssm_groups) * cl * cl * cfg.ssm_state
    return -per_layer * sum(s.mixer == "mamba" for s in cfg.layer_specs)


DOT_CELLS = [  # arch, kind, B, S, kw, the port's count less repro's
    ("llama3-8b", "prefill", 2, 64, {}, lambda a, B, S: 0),
    ("llama3-8b", "decode", 2, 64, {}, lambda a, B, S: 0),
    ("llama3-8b", "train", 2, 64, {"microbatches": 1}, _logits_product),
    ("qwen3-moe-30b-a3b", "decode", 2, 64, {}, lambda a, B, S: 0),
    ("gemma3-27b", "prefill", 2, 64, {}, lambda a, B, S: 0),
    ("whisper-tiny", "prefill", 2, 64, {}, lambda a, B, S: 0),
    ("mamba2-780m", "prefill", 2, 64, {}, _ssd_heads_less_groups),
]


@pytest.mark.parametrize("arch,kind,B,S,kw,extra", DOT_CELLS, ids=[f"{c[0]}:{c[1]}" for c in DOT_CELLS])
def test_matmul_flops_match_repro(arch, kind, B, S, kw, extra):
    got = _t_count(arch, kind, B, S, kw)["dots"]["total_dot_flops"]
    want = _j_dot_flops(arch, kind, B, S, kw) + extra(arch, B, S)
    np.testing.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize("kind,kw", [("train", {"microbatches": 2}), ("prefill", {}), ("decode", {})])
def test_meta_counts_equal_cpu_counts(kind, kw):
    cfg = reduced(ARCHS["llama3-8b"])
    cell = build_cell(cfg, ShapeConfig("c", 64, 4, kind), ShapeMesh(), **kw)
    meta = count_cell(cell)
    cpu = count_cell(cell, materialize(cell.args, cfg.vocab_size, torch.Generator().manual_seed(0), device="cpu"))
    for k in ("flops", "bytes accessed", "argument_bytes", "peak_bytes", "ops", "collectives"):
        assert meta[k] == cpu[k], k
    assert meta["dots"] == cpu["dots"]
    assert meta["peak_bytes"] > meta["argument_bytes"] > 0
