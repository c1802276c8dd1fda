"""The user scripts of ``examples/`` on the port, run as modules:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--params NPZ]
    PYTHONPATH=src python -m repro_torch.examples.explain_serving [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu] [--arch ARCH]
    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]

Each takes its script's flags and prints its lines, plus ``--device
{cuda,cpu}`` (default ``cuda``; without a card it exits non-zero, it never
carries on on the CPU), and ``main(argv)`` returns what it printed as a
dict. The seeded draws are torch's, so the numbers are not ``repro``'s.
"""
