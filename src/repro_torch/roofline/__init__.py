"""Roofline terms of the port: ``repro.roofline``'s hardware table,
``hotpath_terms`` and the dry run's roofline report, with an analytic cost
model in place of XLA's ``cost_analysis`` and op counts (``op_counts``) in
place of the compiled HLO text."""
from repro_torch.roofline.analyze import (
    COLLECTIVE_OPS,
    HW_BY_KIND,
    HW_CPU_HOST,
    HW_GENERIC_GPU,
    HW_H100,
    HW_V5E,
    Hardware,
    RooflineReport,
    collective_bytes,
    hardware_for,
    hotpath_cost,
    hotpath_terms,
    model_flops,
    roofline_report,
)

__all__ = [
    "COLLECTIVE_OPS",
    "HW_BY_KIND",
    "HW_CPU_HOST",
    "HW_GENERIC_GPU",
    "HW_H100",
    "HW_V5E",
    "Hardware",
    "RooflineReport",
    "collective_bytes",
    "hardware_for",
    "hotpath_cost",
    "hotpath_terms",
    "model_flops",
    "roofline_report",
]
