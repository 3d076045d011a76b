"""State carried between the JAX package and the port.

Turns the JAX package's host data -- numpy leaves of its month-input
NamedTuples, :class:`oisat_tpu.ops.weights.SparsePlan`, ``satellite_amf`` /
``satellite_opt`` / ``satellite_ssmis`` / ``ctm_model`` granules -- into the
port's types with tensors on a given device, and the port's results back
into numpy.  Both
sides can so compute on the same arrays; int32 plan indices become int64
(torch's index dtype).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from oisat_tpu_torch import datamodel
from oisat_tpu_torch._device import positive_strides, resolve_device
from oisat_tpu_torch.parallel.analysis import (
    AnalysisInputs,
    FullMonthInputs,
    GosatMonthInputs,
    MopittMonthInputs,
    SsmisMonthInputs,
)

__all__ = ["to_tensor", "to_numpy", "full_month_inputs", "analysis_inputs",
           "mopitt_month_inputs", "gosat_month_inputs", "ssmis_month_inputs",
           "plan_to_torch", "satellite_amf_from", "satellite_opt_from",
           "satellite_ssmis_from", "ctm_model_from", "granule_to"]


def to_tensor(x, device) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor on ``device``; integer
    arrays become int64, floating arrays keep their dtype."""
    a = positive_strides(x)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=resolve_device(device))


def to_numpy(x):
    """Tensors -> numpy, recursively through NamedTuples, tuples and lists
    (a 0-d tensor becomes a 0-d array)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return x


def _inputs_from(cls, x, device):
    return cls(*(to_tensor(getattr(x, f), device) for f in cls._fields))


def full_month_inputs(x, device) -> FullMonthInputs:
    """Any object with the ``FullMonthInputs`` fields (the JAX NamedTuple
    with numpy leaves) as the port's FullMonthInputs on ``device``."""
    return _inputs_from(FullMonthInputs, x, device)


def analysis_inputs(x, device) -> AnalysisInputs:
    """Any object with the ``AnalysisInputs`` fields as the port's
    AnalysisInputs on ``device``."""
    return _inputs_from(AnalysisInputs, x, device)


def mopitt_month_inputs(x, device) -> MopittMonthInputs:
    """Any object with the dense ``MopittMonthInputs`` fields (the JAX
    NamedTuple in its full layout; its table fields are not read) as the
    port's MopittMonthInputs on ``device``."""
    return _inputs_from(MopittMonthInputs, x, device)


def gosat_month_inputs(x, device) -> GosatMonthInputs:
    """Any object with the dense ``GosatMonthInputs`` fields as the port's
    GosatMonthInputs on ``device``."""
    return _inputs_from(GosatMonthInputs, x, device)


def ssmis_month_inputs(x, device) -> SsmisMonthInputs:
    """Any object with the ``SsmisMonthInputs`` fields as the port's
    SsmisMonthInputs on ``device``."""
    return _inputs_from(SsmisMonthInputs, x, device)


def plan_to_torch(plan, device):
    """A :class:`~oisat_tpu.ops.weights.SparsePlan` with its ``idx`` (int64),
    ``w`` and ``mask`` on ``device``.  A compacted plan (``sel`` set) is
    expanded back onto the full pixel axis, so appliers index the raw
    (..., Npix) batch."""
    idx = np.asarray(plan.idx).astype(np.int64)
    if plan.sel is not None:
        idx = np.asarray(plan.sel, np.int64)[idx]
    return dataclasses.replace(plan, idx=to_tensor(idx, device),
                               w=to_tensor(plan.w, device),
                               mask=to_tensor(np.asarray(plan.mask, bool), device),
                               sel=None)


def _copy_fields(src, cls):
    return cls(**{f.name: getattr(src, f.name) for f in dataclasses.fields(cls)})


def satellite_amf_from(granule) -> datamodel.satellite_amf:
    """The port's host granule with the same leaves as ``granule`` (e.g. a
    :class:`oisat_tpu.datamodel.satellite_amf` from a reader or a test)."""
    return _copy_fields(granule, datamodel.satellite_amf)


def satellite_opt_from(granule) -> datamodel.satellite_opt:
    """The port's host granule with the same leaves as ``granule`` (e.g. a
    :class:`oisat_tpu.datamodel.satellite_opt`)."""
    return _copy_fields(granule, datamodel.satellite_opt)


def satellite_ssmis_from(granule) -> datamodel.satellite_ssmis:
    """The port's host granule with the same leaves as ``granule`` (e.g. a
    :class:`oisat_tpu.datamodel.satellite_ssmis`)."""
    return _copy_fields(granule, datamodel.satellite_ssmis)


# host geometry: stays numpy on a gridded granule, as the regrid leaves it
_HOST_FIELDS = ("latitude_center", "longitude_center", "latitude_corner",
                "longitude_corner")


def granule_to(granule, device):
    """A copy of a gridded granule (any of the three kinds, of either
    package) as the port's granule with its array fields as tensors on
    ``device``, the state the port's regrid leaves a granule in.  The
    coordinates stay host numpy; ``[]`` and size-1 placeholders are kept as
    they are."""
    cls = getattr(datamodel, type(granule).__name__)
    out = _copy_fields(granule, cls)
    for f in dataclasses.fields(cls):
        v = getattr(out, f.name)
        if (f.name not in _HOST_FIELDS and isinstance(v, np.ndarray)
                and v.size > 1 and v.dtype.kind == "f"):
            setattr(out, f.name, to_tensor(v, device))
    return out


def ctm_model_from(ctm) -> datamodel.ctm_model:
    """The port's CTM container with the same leaves as ``ctm``."""
    return _copy_fields(ctm, datamodel.ctm_model)
