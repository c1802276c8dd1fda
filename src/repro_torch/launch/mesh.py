"""Device meshes of the port: ``repro.launch.mesh`` over ``torch.distributed``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, with dim names ``("data", "model")``:

  data   — data parallelism: the explain engine's bucket rows
           (``sharding.explain_specs``);
  model  — tensor parallelism, plumbed as in ``repro``; the explain engine
           replicates parameters, so its ranks only repeat rows.

``repro``'s ``ensure_host_devices`` asks JAX for virtual CPU devices; in
PyTorch a device of the mesh is a process, so a mesh of N on one host is N
processes (``torchrun --nproc-per-node N``), and there is no counterpart.

``make_production_mesh`` is ``repro``'s production mesh for the dry run,
(data=16, model=16) or (pod=2, data=16, model=16): a function, not a
module-level constant, so importing this module touches no process group.
Its 256 or 512 ranks are a fake process group (``torch.testing``'s
``FakeStore``): this process is rank 0, no peer exists, and a collective
on ``meta`` tensors only reports its shapes, which is all the dry run's
count needs.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def parse_mesh_arg(spec: str) -> tuple[int, int]:
    """``--mesh dp,tp`` -> (dp, tp). A bare ``dp`` means tp=1."""
    parts = [int(p) for p in spec.split(",") if p.strip()]
    if not 1 <= len(parts) <= 2 or any(p < 1 for p in parts):
        raise ValueError(f"--mesh wants 'dp' or 'dp,tp' with positive ints, got {spec!r}")
    return (parts[0], parts[1] if len(parts) == 2 else 1)


def make_production_mesh(*, multi_pod: bool = False):
    """``repro``'s production mesh over a fake process group of 256 ranks, or
    512 with ``multi_pod``, started here unless a group exists already (one
    of the mesh's size, as a second call finds it). Raises
    ``ValueError`` when a group of another size is up."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = 512 if multi_pod else 256
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    elif dist.get_world_size() != world:
        raise ValueError(f"the production mesh needs {world} ranks; a process group of "
                         f"{dist.get_world_size()} is up")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_explain_mesh(dp: int, tp: int = 1, *, device="cuda"):
    """(data=dp, model=tp) mesh over the world ``launch.distributed.
    init_distributed`` started (every rank calls it). Raises unless the
    world is up with dp·tp ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call launch.distributed.init_distributed(backend) first")
    if dist.get_world_size() != dp * tp:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks; the world has {dist.get_world_size()}")
    dev = torch.device(device)
    if dev.type == "cuda":  # this rank's card, before the mesh would pick one by LOCAL_RANK
        torch.cuda.set_device(dev.index if dev.index is not None else torch.cuda.current_device())
    return init_device_mesh(dev.type, (dp, tp), mesh_dim_names=("data", "model"))


def make_debug_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """Tiny (data, model) mesh over however many ranks the world has (tests)."""
    return make_explain_mesh(data, model, device=device)


def mesh_over(ranks: list, shape: tuple, names: tuple, device_type: str):
    """A ``DeviceMesh`` of ``shape`` over ``ranks`` of the world, every rank
    taking part (``dispatch.run_everywhere`` brings the workers in)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.tensor(ranks, dtype=torch.int).reshape(shape), mesh_dim_names=names)


__all__ = ["make_debug_mesh", "make_explain_mesh", "make_production_mesh", "mesh_over", "parse_mesh_arg"]
