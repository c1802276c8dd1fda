"""Every local op of one dry-run cell, in order, with the model-code line
that ran it: how a count that moves with the torch version is traced to
the DTensor site where the versions choose differently.

    PYTHONPATH=src python -m repro_torch.launch.op_trace trace llama3-8b decode_32k OUT.json
    PYTHONPATH=src python -m repro_torch.launch.op_trace trace qwen3-moe-30b-a3b train OUT.json --reduced
    PYTHONPATH=src python -m repro_torch.launch.op_trace sites OUT.json        # collectives by site
    PYTHONPATH=src python -m repro_torch.launch.op_trace diff A.json B.json    # where two traces part

``trace`` counts the cell as ``launch.dryrun`` does (``count_cell``), on the
production mesh (data=16, model=16), or with ``--reduced`` the
``reduced`` config at a small shape of the same kind (train 8 × 64, one
microbatch; prefill and decode 8 × 256; long: decode 1 × 256, sequence-
sharded) on a fake (data=2, model=4) mesh, and writes ``{"counts": …,
"ops": [[op, input types, output types, collective kind, site], …]}``.
A site is the innermost ``repro_torch`` frame outside ``sharding/``, and
the innermost one where that differs. Run it under each torch version and
``diff`` the two files.
"""
from __future__ import annotations

import argparse
import difflib
import json
import traceback
from collections import defaultdict

import torch

from repro_torch.roofline.op_counts import OpCounter, _collective_kind, _nbytes, _tensors, _type

REDUCED_SHAPES = {"train": (64, 8), "prefill": (256, 8), "decode": (256, 8), "long": (256, 1)}


class OpTrace(OpCounter):
    """``OpCounter`` that also logs each local op it counts."""

    def __init__(self) -> None:
        super().__init__()
        self.log: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out
        frames = [f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}" for f in traceback.extract_stack()
                  if "repro_torch" in f.filename and "op_counts" not in f.filename and "op_trace" not in f.filename]
        caller = next((f for f in reversed(frames) if not f.startswith("sharding/")), frames[-1] if frames else "")
        site = caller if not frames or frames[-1] == caller else f"{caller} via {frames[-1]}"
        ins = _tensors((args, kwargs or {}))
        kind = _collective_kind(func)
        self.log.append([str(func), [_type(t) for t in ins], [_type(t) for t in _tensors(out)], kind,
                         sum(_nbytes(t) for t in ins) if kind else 0, site])
        return out


def trace(arch: str, shape: str, reduced: bool) -> dict:
    import torch.distributed as dist

    from repro_torch.configs import ARCHS, SHAPES_BY_NAME, ShapeConfig, reduced as reduce_cfg
    from repro_torch.launch.cells import build_cell, count_cell
    from repro_torch.launch.mesh import make_production_mesh

    if reduced:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        kind = "decode" if shape == "long" else shape
        cfg, shp, kw = reduce_cfg(ARCHS[arch]), ShapeConfig(shape, *REDUCED_SHAPES[shape], kind), {}
    else:
        mesh, cfg, shp, kw = make_production_mesh(), ARCHS[arch], SHAPES_BY_NAME[shape], {}
    kw = {"microbatches": 1 if reduced else 8} if shp.kind == "train" else kw
    counter = OpTrace()
    c = count_cell(build_cell(cfg, shp, mesh, **kw), counter=counter)
    counts = {"torch": torch.__version__, "flops": c["flops"], "dots": c["dots"]["total_dot_flops"],
              "bytes accessed": c["bytes accessed"], "collectives": c["collectives"], "peak_bytes": c["peak_bytes"]}
    return {"counts": counts, "ops": counter.log}


def sites(ops: list) -> list[str]:
    """The collectives by (kind, operand types, site), the most bytes first."""
    rows = defaultdict(lambda: [0, 0])
    for op, ins, _, kind, nbytes, site in ops:
        if kind:
            rows[(kind, ", ".join(ins), site)][0] += nbytes
            rows[(kind, ", ".join(ins), site)][1] += 1
    ordered = sorted(rows.items(), key=lambda r: -r[1][0])
    return [f"{b:>14d} B {n:>5d}× {k} {t} @ {s}" for (k, t, s), (b, n) in ordered]


def diff(a: list, b: list, limit: int = 40) -> list[str]:
    """Where two traces' op sequences part (view ops aside), one block each."""
    def seq(ops):
        return [f"{op} {ins} -> {outs} @ {site}" for op, ins, outs, _, _, site in ops
                if not any(v in op for v in (".view", "as_strided", ".slice", ".select", "_unsafe_view"))]

    sa, sb = seq(a), seq(b)
    lines = []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(None, sa, sb, autojunk=False).get_opcodes():
        if tag != "equal" and len(lines) < limit:
            lines.append(f"== {tag} a[{i1}:{i2}] b[{j1}:{j2}]")
            lines += [f"  - {x}" for x in sa[i1:i2][:6]] + [f"  + {x}" for x in sb[j1:j2][:6]]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("trace")
    t.add_argument("arch")
    t.add_argument("shape", help="an LM_SHAPES name, or with --reduced train, prefill, decode or long")
    t.add_argument("out")
    t.add_argument("--reduced", action="store_true")
    sub.add_parser("sites").add_argument("trace")
    d = sub.add_parser("diff")
    d.add_argument("a")
    d.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "trace":
        result = trace(args.arch, args.shape, args.reduced)
        with open(args.out, "w") as f:
            json.dump(result, f)
        print(json.dumps(result["counts"]))
    elif args.cmd == "sites":
        with open(args.trace) as f:
            print("\n".join(sites(json.load(f)["ops"])))
    else:
        with open(args.a) as f, open(args.b) as g:
            print("\n".join(diff(json.load(f)["ops"], json.load(g)["ops"])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
