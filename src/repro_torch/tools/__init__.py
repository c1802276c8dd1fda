"""The dev tools of ``tools/`` on the port, run as modules:

    PYTHONPATH=src python -m repro_torch.tools.make_golden [--device cpu] [--forward-only]
    PYTHONPATH=src python -m repro_torch.tools.perf_iterate ARCH SHAPE [knobs]
    PYTHONPATH=src python -m repro_torch.tools.perf_iterate [ARCH] --explain-adaptive [--device cpu]
    PYTHONPATH=src python -m repro_torch.tools.render_experiments

Each takes its tool's flags and prints its lines; a tool that runs a model
also takes ``--device {cuda,cpu}`` (default ``cuda``; without a card it
exits non-zero, it never carries on on the CPU). ``main(argv)`` returns
what the run made. The port's files go where ``repro``'s would not collide
with them: ``tests/golden_torch/``, ``results/trajectory_torch.jsonl`` and
``results/EXPERIMENTS_torch.md``.
"""
