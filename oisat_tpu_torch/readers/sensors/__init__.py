"""Per-sensor fleet readers of the port (twin of
:mod:`oisat_tpu.readers.sensors`; reference oisatgmi/reader.py:1307-1464).

Each fleet reader globs a month of files, decodes them on the host
(``num_job`` > 1: in a thread pool) and regrids every granule through
:mod:`oisat_tpu_torch.regridder` on ``device`` (None: the card), one granule at
a time.
"""

from oisat_tpu_torch.readers.sensors.gosat import gosat_reader
from oisat_tpu_torch.readers.sensors.mopitt import mopitt_reader
from oisat_tpu_torch.readers.sensors.omi import omi_reader
from oisat_tpu_torch.readers.sensors.omps import omps_reader
from oisat_tpu_torch.readers.sensors.ssmis import ssmis_reader
from oisat_tpu_torch.readers.sensors.tempo import tempo_reader
from oisat_tpu_torch.readers.sensors.tropomi import tropomi_reader

__all__ = [
    "omi_reader", "tempo_reader", "tropomi_reader", "omps_reader",
    "mopitt_reader", "gosat_reader", "ssmis_reader",
]
