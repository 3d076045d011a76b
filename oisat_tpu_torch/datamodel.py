"""Data containers for satellite granules and CTM fields.

Plain-dataclass twins of :class:`oisat_tpu.datamodel.satellite_amf`,
``satellite_opt``, ``satellite_ssmis`` and ``ctm_model`` with identical
field names (reference oisatgmi/config.py:7-73).  They are not shared because
that module imports jax and registers pytrees.  Leaves are numpy arrays on
the host (readers, synthetic builders) and torch tensors once regridded
onto the device; NaN marks missing data; level stacks are (L, H, W).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, List, Optional

import numpy as np

__all__ = ["satellite_amf", "satellite_opt", "satellite_ssmis", "ctm_model",
           "stack_granules"]

Array = Any  # np.ndarray | torch.Tensor | [] placeholder (reference uses [])


@dataclasses.dataclass
class satellite_amf:
    """Two-step-retrieval granule (NO2/HCHO/O3 sensors); reference config.py:7-24."""

    vcd: Array = None
    amf: Array = None
    time: Optional[datetime.datetime] = None
    tropopause: Array = None
    latitude_center: Array = None
    longitude_center: Array = None
    latitude_corner: Array = None
    longitude_corner: Array = None
    uncertainty: Array = None
    quality_flag: Array = None
    pressure_mid: Array = None
    scattering_weights: Array = None
    ctm_upscaled_needed: bool = False
    ctm_vcd: Array = None
    ctm_time_at_sat: Any = None
    old_amf: Array = None
    new_amf: Array = None


@dataclasses.dataclass
class satellite_opt:
    """Optimal-estimation granule (MOPITT CO / GOSAT XCH4); reference config.py:27-50."""

    vcd: Array = None
    time: Optional[datetime.datetime] = None
    profile: Array = None
    tropopause: Array = None
    latitude_center: Array = None
    longitude_center: Array = None
    latitude_corner: Array = None
    longitude_corner: Array = None
    uncertainty: Array = None
    quality_flag: Array = None
    pressure_mid: Array = None
    averaging_kernels: Array = None
    ctm_upscaled_needed: bool = False
    ctm_vcd: Array = None
    ctm_xcol: Array = None
    ctm_time_at_sat: Any = None
    aprior_column: Array = None
    apriori_profile: Array = None
    surface_pressure: Array = None
    apriori_surface: Array = None
    x_col: Array = None
    pressure_weight: Array = None
    sensor: str = ""


@dataclasses.dataclass
class satellite_ssmis:
    """SSMIS water-vapor granule; reference config.py:53-61."""

    vcd: Array = None
    uncertainty: Array = None
    time: Optional[datetime.datetime] = None
    latitude_center: Array = None
    longitude_center: Array = None
    ctm_upscaled_needed: bool = False
    ctm_vcd: Array = None
    sensor: str = "SSMIS"


@dataclasses.dataclass
class ctm_model:
    """CTM field container; reference config.py:64-73.

    ``gas_profile``/``pressure_mid``/``delta_p`` are ``(T, L, H, W)`` for
    sub-monthly models and ``(L, H, W)`` once averaged.
    """

    latitude: Array = None
    longitude: Array = None
    time: List[datetime.datetime] = dataclasses.field(default_factory=list)
    gas_profile: Array = None
    pressure_mid: Array = None
    tempeature_mid: Array = None  # (sic) -- reference field name, kept for parity
    delta_p: Array = None
    ctmtype: str = ""
    averaged: bool = False


def stack_granules(granules, field_names):
    """Stack ``field`` across host granules (skipping None) -> dict of (G, ...) arrays."""
    out = {}
    for name in field_names:
        out[name] = np.stack([np.asarray(getattr(g, name)) for g in granules if g is not None])
    return out
