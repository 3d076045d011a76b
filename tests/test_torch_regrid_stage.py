"""A granule's value batch and error row built on its device
(``oisat_tpu_torch.regridder._device_batch``) against the host stack it
replaced: bitwise, NaN in the same places, for every kind of granule the
regrid takes, at float32 and float64, and every regridded field bitwise the
one the host stack gives.

The reference below keeps the host stack verbatim: the QA mask, then each
row cast and multiplied by it, ``np.stack``-ed and copied.  The ``gpu`` test
builds the batch on the card at the benchmark's shapes and holds it to the
host stack computed on the CPU (``python -m pytest --noconftest -m gpu -q
tests/test_torch_regrid_stage.py`` on the GPU host).
"""

from __future__ import annotations

import datetime

import numpy as np
import pytest
import torch

from oisat_tpu_torch import regridder
from oisat_tpu_torch._device import to_device
from oisat_tpu_torch.datamodel import satellite_amf, satellite_opt, satellite_ssmis
from oisat_tpu_torch.regridder import regrid_granule, regrid_ssmis_granule

torch.set_num_threads(1)

DTYPES = [np.float32, np.float64]
CTM_GRID = np.meshgrid(np.arange(-20.0, 20.01, 2.5), np.arange(-30.0, 30.01, 2.0))


# --- the host stack the device build replaced, verbatim ------------------

def _quality_mask(quality_flag, flag_thresh: float, dtype=np.float32) -> np.ndarray:
    """QA mask as the reference builds it: 1.0 where flag > thresh else NaN
    (interpolator.py:124-127), in the regridded fields' ``dtype``."""
    m = (np.asarray(quality_flag) > flag_thresh).astype(dtype)
    m[m != 1.0] = np.nan
    return np.squeeze(m)


def _batch_rows(sat_data, is_opt: bool):
    """(names, rows) of the value batch: the 2-D fields, then every level of
    the 3-D fields as ``"name:z"`` rows (host arrays, not yet cast)."""
    names: list = []
    rows: list = []

    def add2d(name, arr):
        names.append(name)
        rows.append(np.squeeze(np.asarray(arr)))

    def add3d(name, arr):
        a = np.asarray(arr)
        for z in range(a.shape[0]):
            names.append(f"{name}:{z}")
            rows.append(np.squeeze(a[z]))

    add2d("vcd", sat_data.vcd)
    if not is_opt:
        add2d("amf", sat_data.amf)
    if np.size(sat_data.tropopause) != 1:
        add2d("tropopause", sat_data.tropopause)
    if not is_opt and np.size(sat_data.scattering_weights) != 1:
        add3d("scattering_weights", sat_data.scattering_weights)
        add3d("pressure_mid", sat_data.pressure_mid)
    if is_opt:
        # all-zero placeholders (np.zeros((1,)) of the readers) stay out
        for name in ("aprior_column", "surface_pressure", "apriori_surface"):
            if np.asarray(getattr(sat_data, name)).any():
                add2d(name, getattr(sat_data, name))
        add2d("x_col", sat_data.x_col)
        add3d("averaging_kernels", sat_data.averaging_kernels)
        if sat_data.sensor == "GOSAT":
            add3d("pressure_weight", sat_data.pressure_weight)
        add3d("pressure_mid", sat_data.pressure_mid)
        add3d("apriori_profile", sat_data.apriori_profile)
    return names, rows


def host_stack(sat_data, flag_thresh: float, host_dtype):
    """(names, batch, err) as the host built them: the value batch and the
    error row of a ``satellite_amf`` / ``satellite_opt`` granule, or of a
    ``satellite_ssmis`` one (no mask)."""
    if isinstance(sat_data, satellite_ssmis):
        batch = np.asarray(sat_data.vcd, host_dtype).ravel()[None]
        err = np.asarray(sat_data.uncertainty, host_dtype).ravel()[None]
        return ["vcd"], batch, err
    mask = _quality_mask(sat_data.quality_flag, flag_thresh, host_dtype)
    names, rows = _batch_rows(sat_data, isinstance(sat_data, satellite_opt))
    # cast first, then the QA multiply (mask is exactly 1.0 or NaN)
    batch = np.stack([(np.asarray(r, host_dtype) * mask).ravel() for r in rows])
    err = (np.asarray(np.squeeze(sat_data.uncertainty), host_dtype) * mask).ravel()[None]
    return names, batch, err


def _host_batch(fields, uncertainty, quality_flag, flag_thresh, dtype, dev, *, sat_data):
    """The parent's ``_device_batch``: the host stack, then its two copies."""
    host_dtype = np.float64 if dtype == torch.float64 else np.float32
    _, batch, err = host_stack(sat_data, flag_thresh, host_dtype)
    return to_device(batch, dev), to_device(err, dev)


def device_stack(sat_data, flag_thresh: float, dtype, device):
    """(names, batch, err) as the regrid now builds them on ``device``."""
    t = regridder._regrid_dtype(dtype)
    if isinstance(sat_data, satellite_ssmis):
        batch, err = regridder._device_batch([(np.asarray(sat_data.vcd), False)],
                                             sat_data.uncertainty, None, 0.0, t, device)
        return ["vcd"], batch, err
    names, fields = regridder._batch_fields(sat_data, isinstance(sat_data, satellite_opt))
    batch, err = regridder._device_batch(fields, sat_data.uncertainty, sat_data.quality_flag,
                                         flag_thresh, t, device)
    return names, batch, err


def assert_bitwise(got, want, what):
    """``got`` (a tensor) equals the host array ``want`` bit for bit where
    either is a number, and is NaN where ``want`` is NaN."""
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    bits = {4: np.uint32, 8: np.uint64}[want.dtype.itemsize]
    np.testing.assert_array_equal(got.view(bits)[~nan], want.view(bits)[~nan], err_msg=what)


# --- granules of every layout the readers hand over ----------------------

def _swath(rng, ny, nx):
    lat = (np.linspace(-25.0, 25.0, ny)[:, None] + 0.05 * rng.standard_normal((ny, nx)))
    lon = (np.linspace(-12.0, 12.0, nx)[None, :] + 0.05 * rng.standard_normal((ny, nx)))
    return lon, lat


def omi_orbit(seed, ny=48, nx=12, nz=6, flip=False, big_endian=False):
    """An OMI-shaped orbit: float64 2-D fields, float32 3-D fields, 1% bad
    QA; ``flip`` hands the 3-D fields over level-flipped (negative stride)
    and the VCD row-flipped, ``big_endian`` every field in the other byte
    order."""
    rng = np.random.default_rng(seed)
    lon, lat = _swath(rng, ny, nx)
    qa = np.ones((ny, nx))
    qa[rng.random((ny, nx)) < 0.01] = 0.0
    qa[0, :2] = 0.0
    psurf = (1000.0 + 30.0 * rng.standard_normal((ny, nx))).astype(np.float32)
    eta = np.linspace(1.0, 0.02, nz, dtype=np.float32)[:, None, None]
    f = dict(vcd=np.abs(2.0 + 0.3 * rng.standard_normal((ny, nx))),
             amf=np.abs(rng.normal(1.5, 0.2, (ny, nx))),
             tropopause=rng.uniform(100.0, 250.0, (ny, nx)),
             uncertainty=np.abs(rng.normal(0.5, 0.1, (ny, nx))),
             quality_flag=qa, pressure_mid=eta * psurf[None],
             scattering_weights=np.abs(rng.normal(1.0, 0.2, (nz, ny, nx))).astype(np.float32))
    f["vcd"][3, 4] = np.nan
    if flip:
        f["vcd"] = f["vcd"][::-1]
        f["scattering_weights"] = np.flip(f["scattering_weights"], 0)
        f["pressure_mid"] = np.flip(f["pressure_mid"], 0)
    if big_endian:
        f = {k: v.astype(v.dtype.newbyteorder(">")) for k, v in f.items()}
    return satellite_amf(time=datetime.datetime(2019, 7, 1, 13), latitude_center=lat,
                         longitude_center=lon, latitude_corner=[], longitude_corner=[],
                         ctm_upscaled_needed=False, ctm_vcd=[], ctm_time_at_sat=[],
                         old_amf=[], new_amf=[], **f)


def amf_without_sw(seed):
    """An AMF granule without scattering weights (an L3 grid's reader)."""
    g = omi_orbit(seed)
    g.scattering_weights = np.empty((1,))
    g.pressure_mid = np.empty((1,))
    return g


def f32_flag_orbit(seed, **shape):
    """A float32 QA flag holding float32(0.1) beside a threshold of 0.1,
    which float32 cannot hold: float32's comparison keeps none of them."""
    g = omi_orbit(seed, **shape)
    qa = np.full(np.shape(g.vcd), 0.5, np.float32)
    qa[::5, ::4] = np.float32(0.1)
    qa[2::11, 1::5] = 0.05
    g.quality_flag = qa
    return g


def mopitt_day(seed, pitch=4.0, nlev=4, placeholders=True):
    """A MOPITT-shaped L3 day in its reader's layout: every field a
    transposed, longitude-first view; float32 columns and float64 a-priori
    mixing ratios; ``placeholders=False`` leaves the a-priori column, the
    surface pressure and surface a priori as the readers' all-zero
    ``np.zeros((1,))``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    lon, lat = np.meshgrid(np.arange(-20.0 + pitch / 2, 20.0, pitch),
                           np.arange(-28.0 + pitch / 2, 28.0, pitch))
    hw = lat.shape  # (lat, lon): the fields are views of these transposed
    vcd = np.abs(2000.0 + 60.0 * rng.standard_normal(hw)).astype(f32)
    vcd[rng.random(hw) < 0.2] = np.nan

    def t2(a):
        return a.T

    def t3(a):
        return np.transpose(a, (0, 2, 1))

    zero = np.zeros((1,))
    return satellite_opt(
        vcd=t2(vcd), time=datetime.datetime(2019, 7, 1, 12), profile=[],
        tropopause=np.empty((1,)), latitude_center=lat.T, longitude_center=lon.T,
        latitude_corner=[], longitude_corner=[],
        uncertainty=t2((0.07 * vcd).astype(f32)), quality_flag=t2(np.ones(hw, f32)),
        pressure_mid=t3(np.broadcast_to(np.linspace(900.0, 100.0, nlev)[:, None, None],
                                        (nlev,) + hw).astype(f32).copy()),
        averaging_kernels=t3(np.abs(rng.normal(150.0, 50.0, (nlev + 1,) + hw)).astype(f32)),
        aprior_column=t2(np.abs(rng.normal(2000.0, 100.0, hw)).astype(f32)) if placeholders
        else zero,
        apriori_profile=t3(np.abs(rng.normal(90.0, 12.0, (nlev,) + hw))),
        surface_pressure=t2((1000.0 + 30.0 * rng.standard_normal(hw)).astype(f32))
        if placeholders else zero,
        apriori_surface=t2(np.abs(rng.normal(100.0, 10.0, hw))) if placeholders else zero,
        x_col=t2((1e6 * vcd / 2.1e10).astype(f32)), pressure_weight=[], sensor="MOPITT")


def gosat_day(seed, n_points=300, nlev=5):
    """GOSAT-shaped soundings (points on the last axis) with pressure
    weights, the all-zero placeholders and an integer quality flag."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    sigma = np.linspace(1.0, 0.01, nlev)[:, None]
    psurf = 1000.0 + 30.0 * rng.standard_normal(n_points)
    xch4 = 1800.0 + 8.0 * rng.standard_normal(n_points)
    zero = np.zeros((1,))
    return satellite_opt(
        vcd=xch4, time=datetime.datetime(2019, 7, 1, 12), profile=[],
        tropopause=np.empty((1,)), latitude_center=rng.uniform(-25.0, 25.0, n_points).astype(f32),
        longitude_center=rng.uniform(-18.0, 18.0, n_points).astype(f32),
        latitude_corner=[], longitude_corner=[],
        uncertainty=np.abs(rng.normal(10.0, 2.0, n_points)),
        quality_flag=(rng.random(n_points) > 0.1).astype(np.int8),
        pressure_mid=sigma * psurf[None],
        averaging_kernels=rng.uniform(0.3, 1.1, (nlev, n_points)).astype(f32),
        aprior_column=zero,
        apriori_profile=(1800.0 * (0.85 + 0.15 * sigma)
                         + 10.0 * rng.standard_normal((nlev, n_points))).astype(f32),
        surface_pressure=zero, apriori_surface=zero, x_col=xch4,
        pressure_weight=np.broadcast_to(np.full((nlev, 1), 1.0 / nlev, f32), (nlev, n_points)),
        sensor="GOSAT")


def ssmis_map(seed, pitch=2.0):
    """An SSMIS-shaped map: float32 columns with NaN patches."""
    rng = np.random.default_rng(seed)
    lon, lat = np.meshgrid(np.arange(-20.0 + pitch / 2, 20.0, pitch, dtype=np.float32),
                           np.arange(-28.0 + pitch / 2, 28.0, pitch, dtype=np.float32))
    pwv = np.abs(20.0 + 3.0 * rng.standard_normal(lat.shape)).astype(np.float32)
    pwv[rng.random(lat.shape) < 0.2] = np.nan
    return satellite_ssmis(vcd=pwv, uncertainty=pwv * np.float32(0.05),
                           time=datetime.datetime(2019, 7, 1), latitude_center=lat,
                           longitude_center=lon, ctm_upscaled_needed=False, ctm_vcd=[],
                           sensor="SSMI")


# (granule maker, QA threshold, regrid method)
CASES = {
    "omi_orbit": (omi_orbit, 0.75, 1),
    "amf_without_scattering_weights": (amf_without_sw, 0.75, 1),
    "mopitt_transposed": (mopitt_day, 0.75, 1),
    "mopitt_placeholders": (lambda s: mopitt_day(s, placeholders=False), 0.75, 1),
    "gosat_pressure_weight": (gosat_day, 0.75, 4),
    "ssmis": (ssmis_map, 0.0, 1),
    "flipped_fields": (lambda s: omi_orbit(s, flip=True), 0.75, 1),
    "f32_flag_threshold_0.1": (f32_flag_orbit, 0.1, 1),
    "big_endian_fields": (lambda s: omi_orbit(s, big_endian=True), 0.75, 1),
}


def _regrid(g, thresh, method, dtype):
    lon2d, lat2d = CTM_GRID
    if isinstance(g, satellite_ssmis):
        return regrid_ssmis_granule(1.0, g, lon2d, lat2d, "cpu", dtype=dtype)
    return regrid_granule(method, 1.0, g, lon2d, lat2d, "cpu", flag_thresh=thresh, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("case", list(CASES))
def test_the_device_batch_is_the_host_stack_bitwise(case, dtype, monkeypatch):
    make, thresh, method = CASES[case]
    g = make(7)
    names, want, want_err = host_stack(g, thresh, dtype)
    got_names, got, got_err = device_stack(g, thresh, dtype, torch.device("cpu"))
    assert got_names == names
    assert np.isnan(want).any() and not np.isnan(want).all()
    assert_bitwise(got, want, f"{case}: batch")
    assert_bitwise(got_err, want_err, f"{case}: error row")

    # the whole regridded granule against the one the host stack gives
    out = _regrid(g, thresh, method, dtype)
    monkeypatch.setattr(regridder, "_device_batch",
                        lambda *a, **k: _host_batch(*a, **k, sat_data=g))
    ref = _regrid(g, thresh, method, dtype)
    fields = {n: v for n, v in vars(ref).items() if torch.is_tensor(v)}
    assert "vcd" in fields and "uncertainty" in fields
    for name, want_t in fields.items():
        assert_bitwise(getattr(out, name), want_t.numpy(), f"{case}: regridded {name}")


def _global_mopitt_day(seed, nlev=9):
    """The benchmark's MOPITT day: the 1 deg globe, 360 x 180 longitude
    first, ``nlev`` levels and an (nlev + 1)-row AK."""
    from oisat_tpu_torch.entry import synthetic_mopitt_day

    g = synthetic_mopitt_day(seed, nlev=nlev)
    assert np.shape(g.vcd) == (360, 180) and np.shape(g.averaging_kernels)[0] == nlev + 1
    return g


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("case", ["omi_orbit", "mopitt_day", "f32_flag_threshold_0.1"])
def test_the_card_builds_the_host_stack_at_the_benchmark_shapes(case, dtype, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    thresh = 0.75
    if case == "mopitt_day":
        g = _global_mopitt_day(13)
    else:  # a 1644 x 60 x 35 orbit
        g = omi_orbit(11, ny=1644, nx=60, nz=35)
    if case == "f32_flag_threshold_0.1":
        g.quality_flag, thresh = f32_flag_orbit(0, ny=1644, nx=60).quality_flag, 0.1
    names, want, want_err = host_stack(g, thresh, dtype)
    got_names, got, got_err = device_stack(g, thresh, dtype, torch.device("cuda"))
    assert got_names == names and got.device.type == "cuda"
    assert_bitwise(got, want, f"{case}: batch")
    assert_bitwise(got_err, want_err, f"{case}: error row")

    # the granule regridded on the card as the benchmark's cells regrid it,
    # against the same regrid of the host stack
    from oisat_tpu_torch.entry import merra2_gmi_grid

    lon2d, lat2d = merra2_gmi_grid()
    grid_size = 1.0 if case == "mopitt_day" else 0.25
    out = regrid_granule(1, grid_size, g, lon2d, lat2d, "cuda", flag_thresh=thresh, dtype=dtype)
    monkeypatch.setattr(regridder, "_device_batch",
                        lambda *a, **k: _host_batch(*a, **k, sat_data=g))
    ref = regrid_granule(1, grid_size, g, lon2d, lat2d, "cuda", flag_thresh=thresh, dtype=dtype)
    fields = {n: v for n, v in vars(ref).items() if torch.is_tensor(v)}
    assert "vcd" in fields and fields["vcd"].device.type == "cuda"
    for name, want_t in fields.items():
        assert_bitwise(getattr(out, name), want_t.cpu().numpy(), f"{case}: regridded {name}")

