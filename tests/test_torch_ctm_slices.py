"""The matched CTM slices the port prepares for a month
(``obs_operators._prepared``, through ``driver.oisatgmi._fused_inputs``):
each slice's arrays are copied as the reader hands them over and the
operator's float64 columns are derived on the granules' device.  They must be
bitwise the host numpy derivation: ``partial_column`` / ``air_partial_column``
of the float64 casts, and on a granule flagged ``ctm_upscaled_needed`` the
float64 stack of the fields mapped through the same upscaler.

Every case runs on the CPU and, marked ``gpu``, on a CUDA device where one is
present: there torch would divide by a Python number as a product with its
reciprocal, which the derivation must not do.  Also held: one counted device
derivation (``assemble.slices_device``) and the raw bytes (``h2d.bytes``) per
distinct slice, and the prepared tensors shared by the granules of a slice.
"""

from __future__ import annotations

import datetime

import numpy as np
import pytest
import torch

from oisat_tpu_torch import obs_operators as oo
from oisat_tpu_torch.datamodel import ctm_model, satellite_amf, satellite_opt
from oisat_tpu_torch.driver import oisatgmi
from oisat_tpu_torch.ops.vertical import (
    air_partial_column,
    ak_conv_mopitt_fields,
    partial_column,
)
from oisat_tpu_torch.utils import profiling

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]
LC, LS = 12, 5
# the CTM's GEOS-like 0.5 x 0.625 deg window and a 1 deg granule grid inside it
CTM_GRID = np.meshgrid(np.arange(-10.0, 10.0, 0.625), np.arange(20.0, 40.01, 0.5))
SAT_GRID = np.meshgrid(np.arange(-8.5, 8.6, 1.0), np.arange(22.5, 37.6, 1.0))
# OMI-like granule hours against the mean diurnal cycle's 3-hourly snapshots:
# matched snapshots 0, 1, 2, 4, 7, 7 (five distinct slices)
AMF_HOURS = (1, 4, 5, 13, 22, 23)
# MOPITT-like granule days against three daily ECCOH snapshots: days 1, 2, 2, 3
OPT_DAYS = (1, 2, 2, 3)


@pytest.fixture
def device(request):
    dev = torch.device(request.param)
    if dev.type == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return dev


@pytest.fixture
def traced():
    profiling.take()
    profiling.enable(True)
    yield
    profiling.enable(False)
    profiling.take()


def _ctm_fields(rng, lead):
    """(pmid, profile, dp) float32 of shape ``lead + (LC, H, W)``, as a
    reader hands them over (profiles and thicknesses of many binades, so the
    float64 products exercise the rounding)."""
    shape = lead + (LC,) + CTM_GRID[0].shape
    pmid = np.sort(rng.uniform(1.0, 1000.0, shape), axis=-3)[..., ::-1, :, :]
    prof = rng.lognormal(0.0, 3.0, shape)
    dp = rng.uniform(0.01, 40.0, shape)
    return tuple(np.ascontiguousarray(a, np.float32) for a in (pmid, prof, dp))


def _amf_month(device, upscaled: bool, seed=0):
    """(ctm, granules): the mean diurnal cycle of a GMI-like CTM (8 snapshots
    3 h apart) and one AMF granule per hour of ``AMF_HOURS``."""
    rng = np.random.default_rng(seed)
    pmid, prof, dp = _ctm_fields(rng, (8,))
    times = [datetime.datetime(2019, 7, 15, 3 * h) for h in range(8)]
    ctm = ctm_model(CTM_GRID[1], CTM_GRID[0], times, prof, pmid, [], dp, "GMI", True)
    lon, lat = SAT_GRID if upscaled else CTM_GRID
    hw = lat.shape

    def t(*shape):
        return torch.as_tensor(rng.uniform(0.1, 1.0, shape + hw), dtype=torch.float32,
                               device=device)

    grans = [satellite_amf(
        vcd=t(), amf=t(), time=datetime.datetime(2019, 7, 2 + k, h), tropopause=t() * 500.0,
        latitude_center=lat, longitude_center=lon, uncertainty=t(),
        pressure_mid=t(LS) * 1000.0, scattering_weights=t(LS), ctm_upscaled_needed=upscaled)
        for k, h in enumerate(AMF_HOURS)]
    return ctm, grans


def _mopitt_month(device, upscaled: bool, seed=1):
    """(ctm_data, granules): three daily ECCOH-like snapshots (no time axis)
    and one MOPITT-like granule per day of ``OPT_DAYS``."""
    rng = np.random.default_rng(seed)
    ctm_data = []
    for day in (1, 2, 3):
        pmid, prof, dp = _ctm_fields(rng, ())
        ctm_data.append(ctm_model(CTM_GRID[1], CTM_GRID[0], [datetime.datetime(2019, 7, day)],
                                  prof, pmid, [], dp, "ECCOH", False))
    lon, lat = SAT_GRID if upscaled else CTM_GRID
    hw = lat.shape

    def t(*shape):
        return torch.as_tensor(rng.uniform(0.1, 1.0, shape + hw), dtype=torch.float32,
                               device=device)

    grans = [satellite_opt(
        vcd=t(), time=datetime.datetime(2019, 7, day, 12), latitude_center=lat,
        longitude_center=lon, uncertainty=t(), pressure_mid=t(LS) * 1000.0,
        averaging_kernels=t(LS + 1), aprior_column=t(), apriori_profile=t(LS),
        apriori_surface=t(), x_col=t(), sensor="MOPITT", ctm_upscaled_needed=upscaled)
        for day in OPT_DAYS]
    return ctm_data, grans


def _plans_built(ctm_data, granule, device) -> int:
    """Build (and cache) the upscaler of a flagged granule's grid, as the
    month before would have, and drop what tracing recorded so far.  Returns
    the bytes one mapping copies itself (the box filter's index rows, 0
    unflagged), which the counters hold beside the slices' own."""
    per_map = 0
    if granule.ctm_upscaled_needed:
        up = oo._ctm_to_sat_upscaler(ctm_data, granule, device)
        profiling.take()
        up.apply(torch.zeros((1,) + ctm_data[0].latitude.shape, dtype=torch.float64,
                             device=device))
        per_map = profiling.take()[1].get("h2d.bytes", 0)
    profiling.take()
    return per_map


def _host_expected(ctm_data, granule, device, fields):
    """The parent's host derivation of one slice: ``fields`` (host arrays,
    float64 columns computed in numpy) copied as they are, or on a flagged
    granule cast to float64, stacked on the host and mapped through the
    upscaler."""
    if not granule.ctm_upscaled_needed:
        return [torch.as_tensor(f).to(device) for f in fields]
    stack = np.concatenate([np.asarray(f, np.float64) for f in fields])
    up = oo._ctm_to_sat_upscaler(ctm_data, granule, device)
    assert not up.needed  # the CTM grid is finer: the fields are mapped
    out = up.apply(torch.as_tensor(stack).to(device))
    return list(out.split([f.shape[0] for f in fields]))


def _assert_bitwise(got, want, name):
    assert got.dtype == want.dtype and got.device == want.device, name
    assert np.array_equal(got.cpu().numpy(), want.cpu().numpy(), equal_nan=True), name


def _amf_snapshot(hour):
    return min(range(8), key=lambda k: abs(hour - 3 * k))


@pytest.mark.parametrize("upscaled", [False, True])
@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_amf_slices_are_the_host_partial_columns_bitwise(device, upscaled, traced):
    ctm, grans = _amf_month(device, upscaled)
    per_map = _plans_built([ctm], grans[0], device)
    inputs, _ = oisatgmi._fused_inputs("amf", "OMI", [ctm], grans)
    _, counters = profiling.take()
    for k, (g, hour) in enumerate(zip(grans, AMF_HOURS)):
        s = _amf_snapshot(hour)
        pmid, prof, dp = ctm.pressure_mid[s], ctm.gas_profile[s], ctm.delta_p[s]
        pc = partial_column(np.asarray(dp, np.float64), np.asarray(prof, np.float64))
        want_pmid, want_pc = _host_expected([ctm], g, device, [pmid, pc])
        _assert_bitwise(inputs.ctm_pmid[k], want_pmid, f"pmid of granule {k}")
        _assert_bitwise(inputs.ctm_pc[k], want_pc, f"partial column of granule {k}")
    assert inputs.ctm_pc.dtype == torch.float64
    n_slices = len({_amf_snapshot(h) for h in AMF_HOURS})
    assert counters["assemble.slices_device"] == n_slices == 5
    # three float32 arrays of one snapshot a slice
    assert counters["h2d.bytes"] == n_slices * (3 * ctm.pressure_mid[0].nbytes + per_map)


@pytest.mark.parametrize("upscaled", [False, True])
@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_mopitt_slices_are_the_host_air_columns_bitwise(device, upscaled, traced):
    ctm_data, grans = _mopitt_month(device, upscaled)
    per_map = _plans_built(ctm_data, grans[0], device)
    inputs, _ = oisatgmi._fused_inputs("opt", "MOPITT", ctm_data, grans)
    _, counters = profiling.take()
    for k, (g, day) in enumerate(zip(grans, OPT_DAYS)):
        c = ctm_data[day - 1]
        airpc = air_partial_column(np.asarray(c.delta_p, np.float64))
        want = _host_expected(ctm_data, g, device, [c.pressure_mid, c.gas_profile, airpc])
        for name, w in zip(("ctm_pmid", "ctm_profile", "ctm_airpc"), want):
            _assert_bitwise(getattr(inputs, name)[k], w, f"{name} of granule {k}")
    assert inputs.ctm_airpc.dtype == torch.float64
    assert counters["assemble.slices_device"] == len(set(OPT_DAYS)) == 3
    assert counters["h2d.bytes"] == 3 * (3 * ctm_data[0].delta_p.nbytes + per_map)


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_the_staged_operators_read_the_same_slices(device):
    """``ak_conv_mopitt`` (the staged path) gives the fused path's
    per-granule results on the same month: both read the same slices."""
    ctm_data, grans = _mopitt_month(device, upscaled=True)
    oo.ak_conv_mopitt(ctm_data, grans)
    inputs, _ = oisatgmi._fused_inputs("opt", "MOPITT", ctm_data, grans)
    vcd, xcol = ak_conv_mopitt_fields(
        inputs.ctm_pmid, inputs.ctm_profile, inputs.ctm_airpc, inputs.sat_pmid, inputs.aks,
        inputs.aprior_col, inputs.apriori_profile, inputs.apriori_surface, inputs.vcd)
    for k, g in enumerate(grans):
        _assert_bitwise(g.ctm_vcd, vcd[k], f"model vcd of granule {k}")
        _assert_bitwise(g.ctm_xcol, xcol[k], f"model xcol of granule {k}")


@pytest.mark.parametrize("upscaled", [False, True])
def test_a_slice_is_prepared_once_and_shared(upscaled, traced):
    ctm, grans = _amf_month("cpu", upscaled)
    per_map = _plans_built([ctm], grans[0], "cpu")
    calls = []

    def host_fields():
        calls.append(1)
        return oo._amf_ctm_slice([ctm], 0, 7)

    cache: dict = {}
    first = oo._prepared(cache, [ctm], grans[4], 7, "cpu", host_fields, oo._amf_columns)
    again = oo._prepared(cache, [ctm], grans[5], 7, "cpu", host_fields, oo._amf_columns)
    assert again is first and len(calls) == 1 and len(cache) == 1
    _, counters = profiling.take()
    assert counters["assemble.slices_device"] == 1
    assert counters["h2d.bytes"] == 3 * ctm.delta_p[7].nbytes + per_map


def test_a_kind_without_a_derivation_copies_its_arrays_and_counts_no_slice(traced):
    """GOSAT's slice (pmid, profile) is copied as it is, and mapped in
    float64 on a flagged granule: nothing is derived on the device."""
    ctm_data, grans = _mopitt_month("cpu", upscaled=True)
    g = grans[0]
    per_map = _plans_built(ctm_data, g, "cpu")
    cache: dict = {}
    got = oo._prepared(cache, ctm_data, g, 0, "cpu",
                       lambda: oo._time_collapsed(ctm_data[0], ("pressure_mid", "gas_profile")))
    _, counters = profiling.take()
    want = _host_expected(ctm_data, g, "cpu",
                          [ctm_data[0].pressure_mid, ctm_data[0].gas_profile])
    for k in range(2):
        _assert_bitwise(got[k], want[k], f"field {k}")
    assert "assemble.slices_device" not in counters
    assert counters["h2d.bytes"] == 2 * ctm_data[0].pressure_mid.nbytes + per_map


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_the_columns_divide_as_numpy_on_the_device(device):
    """``partial_column`` / ``air_partial_column`` of float64 and float32
    tensors: bitwise numpy's result on the same values."""
    rng = np.random.default_rng(7)
    dp = rng.lognormal(0.0, 4.0, 200_000)
    prof = rng.lognormal(0.0, 4.0, 200_000)
    for dt in (np.float64, np.float32):
        a, b = dp.astype(dt), prof.astype(dt)
        got = partial_column(torch.as_tensor(a).to(device), torch.as_tensor(b).to(device))
        assert np.array_equal(got.cpu().numpy(), partial_column(a, b)), dt
        got = air_partial_column(torch.as_tensor(a).to(device))
        assert np.array_equal(got.cpu().numpy(), air_partial_column(a)), dt
