"""Roofline terms of the port: ``repro.roofline``'s hardware table and
``hotpath_terms``, with an analytic cost model in place of XLA's
``cost_analysis``."""
from repro_torch.roofline.analyze import (
    HW_BY_KIND,
    HW_CPU_HOST,
    HW_GENERIC_GPU,
    HW_H100,
    HW_V5E,
    Hardware,
    hardware_for,
    hotpath_cost,
    hotpath_terms,
)

__all__ = [
    "HW_BY_KIND",
    "HW_CPU_HOST",
    "HW_GENERIC_GPU",
    "HW_H100",
    "HW_V5E",
    "Hardware",
    "hardware_for",
    "hotpath_cost",
    "hotpath_terms",
]
