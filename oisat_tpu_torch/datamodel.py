"""Data containers for satellite granules and CTM fields.

Plain-dataclass twins of :class:`oisat_tpu.datamodel.satellite_amf` and
:class:`oisat_tpu.datamodel.ctm_model` with identical field names
(reference oisatgmi/config.py:7-24, :64-73).  They are not shared because
that module imports jax and registers pytrees.  Leaves are numpy arrays on
the host (readers, synthetic builders) and torch tensors once regridded
onto the device; NaN marks missing data; level stacks are (L, H, W).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, List, Optional

__all__ = ["satellite_amf", "ctm_model"]

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
