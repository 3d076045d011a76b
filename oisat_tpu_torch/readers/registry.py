"""Per-product sensor constants as data (twin of
:mod:`oisat_tpu.readers.registry`, the constants bit for bit).

The reference hard-codes interpolation method, analysis grid size and QA
threshold inside each reader function (e.g. reference oisatgmi/reader.py:528-530
TEMPO, :800-802 TROPOMI NO2, :899-901 OMI NO2); here they form a typed
registry so sensors are configuration, not code.
"""

from __future__ import annotations

import dataclasses

__all__ = ["SensorSpec", "SENSORS"]


@dataclasses.dataclass(frozen=True)
class SensorSpec:
    name: str  # product key, e.g. "OMI_NO2"
    interpolator_type: int  # 1 linear / 2 nearest / 3 rbf / 4 kd-nearest
    grid_size: float  # fine analysis grid pitch [deg]
    flag_thresh: float  # QA threshold (mask keeps flag > thresh)
    kind: str  # "amf" | "opt" | "ssmis"
    reference: str  # file:line of the constants in the reference


SENSORS = {
    "TEMPO_NO2": SensorSpec("TEMPO_NO2", 4, 0.05, 0.0, "amf", "reader.py:528-530"),
    "TEMPO_HCHO": SensorSpec("TEMPO_HCHO", 4, 0.05, 0.0, "amf", "reader.py:620-622"),
    "TROPOMI_NO2": SensorSpec("TROPOMI_NO2", 1, 0.10, 0.75, "amf", "reader.py:800-802"),
    "TROPOMI_HCHO": SensorSpec("TROPOMI_HCHO", 2, 0.10, 0.5, "amf", "reader.py:698-700"),
    "OMI_NO2": SensorSpec("OMI_NO2", 1, 0.25, 0.0, "amf", "reader.py:899-901"),
    "OMI_HCHO": SensorSpec("OMI_HCHO", 1, 0.25, 0.0, "amf", "reader.py:976-980"),
    "OMI_O3": SensorSpec("OMI_O3", 1, 0.25, 0.0, "amf", "reader.py:1044-1048"),
    "OMPS_HCHO": SensorSpec("OMPS_HCHO", 1, 0.5, 0.0, "amf", "reader.py:1122-1126"),
    "MOPITT_CO": SensorSpec("MOPITT_CO", 1, 1.0, 0.0, "opt", "reader.py:1206-1211"),
    "GOSAT_XCH4": SensorSpec("GOSAT_XCH4", 1, 1.0, 0.0, "opt", "reader.py:1266-1273"),
    "SSMIS_WV": SensorSpec("SSMIS_WV", 1, 0.25, 0.0, "ssmis", "reader.py:1297-1303"),
}
