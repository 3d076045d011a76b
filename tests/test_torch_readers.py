"""The port's file readers (oisat_tpu_torch.readers) against the JAX package's
on the same synthetic product files, on the CPU.

The files come from the generators of tests/test_sensors.py,
tests/test_ctm_readers.py and tests/test_job.py; their constant fields are
then roughened with numpy-seeded noise and a few fill values, so a wrong
axis, cast or mask shows.  Tolerances:

* ``ncio`` functions, the CTM readers and every sensor's decode (the per-file
  reader without a CTM grid): bitwise equal leaves, equal dtypes.  GOSAT's
  decode ends in the filler, whose float64 interpolation runs as torch ops in
  the port: rtol 1e-12.
* regridded granules (through both packages' ``readers`` facade; the JAX side
  under ``OISAT_PARITY=1``, host granules, full-precision transfers; the port
  with ``fast_swath=False`` on "cpu"): float32 rtol 1e-5 / atol 1e-6, NaN
  patterns identical, the tolerance of tests/test_torch_regrid.py.
"""

import dataclasses
import datetime
import importlib
from pathlib import Path
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
import torch

from oisat_tpu.readers import ncio as jax_ncio
from oisat_tpu.readers import ctm as jax_ctm
from oisat_tpu.readers import readers as jax_readers
from oisat_tpu_torch.readers import ctm as port_ctm
from oisat_tpu_torch.readers import ncio as port_ncio
from oisat_tpu_torch.readers import readers as port_readers
from oisat_tpu_torch.readers.registry import SENSORS as PORT_SENSORS
from tests import test_sensors as gen
from tests.test_ctm_readers import write_gmi_pair
from tests.test_job import _write_eccoh, _write_omi_hcho, _write_omi_o3
from tests.test_torch_oi import assert_parity

torch.set_num_threads(1)

CLON, CLAT = gen.CLON, gen.CLAT
_KEEP = ("lat", "lon", "time", "flag", "qa_value", "pressure", "tm5", "eta", "index")


def _roughen(path, seed):
    """Multiply every float field of two or more dimensions (coordinates,
    times, flags, pressure tables and indices left alone) by seeded noise in
    0.9..1.1 and put a NaN, a negative and an infinite value in."""
    rng = np.random.default_rng(seed)

    def visit(name, obj):
        leaf = name.split("/")[-1].lower()
        if (not isinstance(obj, h5py.Dataset) or obj.ndim < 2 or obj.dtype.kind != "f"
                or any(k in leaf for k in _KEEP)):
            return
        data = obj[...] * rng.uniform(0.9, 1.1, obj.shape)
        flat = data.reshape(-1)
        flat[3], flat[7], flat[11] = np.nan, -abs(flat[7]), np.inf
        obj[...] = data

    with h5py.File(path, "a") as f:
        f.visititems(visit)


def _omi_no2(path):
    gen.write_omi_no2(path)
    with h5py.File(path, "a") as f:  # the total-column branch
        s = f["SCIENCE_DATA"]
        s["ColumnAmountNO2"] = np.full((gen.NY, gen.NX), 5.0e15)
        s["Amf"] = np.full((gen.NY, gen.NX), 2.4)
        s["ColumnAmountNO2Std"] = np.full((gen.NY, gen.NX), 1.5e15)
        flags = s["VcdQualityFlags"][...]
        flags[:4, :4] = np.arange(16.0).reshape(4, 4) % 4  # every bit pattern
        flags[5, 5] = np.nan
        s["VcdQualityFlags"][...] = flags


def _tropomi_no2(path):
    gen.write_tropomi_no2(path)
    with h5py.File(path, "a") as f:  # the total-column branch
        det = f["PRODUCT/SUPPORT_DATA/DETAILED_RESULTS"]
        det["nitrogendioxide_total_column"] = np.full((180, 120), 1.1e-4)
        det["nitrogendioxide_total_column_precision"] = np.full((180, 120), 3e-5)


def _tempo_no2(path):
    gen.write_tempo_no2(path)
    with h5py.File(path, "a") as f:  # the total-column branch
        f["product"]["vertical_column_stratosphere"] = np.full((150, 120), 2.0e15)
        f["support_data"]["amf_total"] = np.full((150, 120), 2.1)
        f["support_data"]["vertical_column_total_uncertainty"] = np.full((150, 120), 1.2e15)


def _tempo_hcho(path):
    gen.write_tempo_no2(path)
    with h5py.File(path, "a") as f:
        f["product"]["vertical_column"] = np.full((150, 120), 7.0e15)
        f["product"]["vertical_column_uncertainty"] = np.full((150, 120), 2.0e15)
        f["support_data"]["amf"] = np.full((150, 120), 1.6)


def _no2(fn):
    return lambda mod, path, read_ak, trop, **kw: getattr(mod, fn)(
        path, trop, None, None, read_ak, **kw)


def _plain(fn):
    return lambda mod, path, read_ak, trop, **kw: getattr(mod, fn)(
        path, None, None, read_ak, **kw)


# product -> (module, file writer, file name under the month's folder, YYYYMM,
#             decode(module, path, read_ak, trop), TEMPO hour)
PRODUCTS = {
    "OMI_NO2": ("omi", _omi_no2, "OMI-Aura_L2-OMNO2_2019m0710.nc", "201907",
                _no2("omi_reader_no2"), None),
    "OMI_HCHO": ("omi", _write_omi_hcho, "OMI-Aura_L2-OMHCHO_2019m0710.nc", "201907",
                 _plain("omi_reader_hcho"), None),
    "OMI_O3": ("omi", _write_omi_o3, "OMI-Aura_L2-OMTO3_2019m0710.he5", "201907",
               _plain("omi_reader_o3"), None),
    "TROPOMI_NO2": ("tropomi", _tropomi_no2, "S5P_OFFL_L2__NO2____20190712.nc", "201907",
                    _no2("tropomi_reader_no2"), None),
    "TROPOMI_HCHO": ("tropomi", gen.write_tropomi_hcho, "S5P_OFFL_L2__HCHO___20190714.nc",
                     "201907", _plain("tropomi_reader_hcho"), None),
    "TEMPO_NO2": ("tempo", _tempo_no2, "TEMPO_NO2_L2_20230905T180000.nc", "202309",
                  _no2("tempo_reader_no2"), 18),
    "TEMPO_HCHO": ("tempo", _tempo_hcho, "TEMPO_HCHO_L2_20230905T180000.nc", "202309",
                   _plain("tempo_reader_hcho"), 18),
    "OMPS_HCHO": ("omps", gen.write_omps, "OMPS_NPP_HCHO_2019m0703.nc", "201907",
                  _plain("omps_reader_hcho"), None),
    "MOPITT_CO": ("mopitt", gen.write_mopitt, "MOP03JM-201907.he5", "201907",
                  _plain("mopitt_reader_co"), None),
    "GOSAT_XCH4": ("gosat", gen.write_gosat, "2010/ESACCI-GHG-20100615.nc", "201006",
                   _plain("gosat_reader_xch4"), None),
    "SSMIS_WV": ("ssmis", gen.write_ssmis, "f16_201001v7.nc", "201001",
                 lambda mod, path, read_ak, trop, **kw: mod.ssmis_reader_wv(
                     path, None, None, **kw), None),
}


def test_registry_is_the_twins_bit_for_bit():
    from oisat_tpu.readers.registry import SENSORS as JAX_SENSORS

    assert list(PORT_SENSORS) == list(JAX_SENSORS) and len(PORT_SENSORS) == 11
    for name, spec in JAX_SENSORS.items():
        assert dataclasses.asdict(PORT_SENSORS[name]) == dataclasses.asdict(spec)
    assert set(PRODUCTS) == set(PORT_SENSORS)


def _write(tmp_path, product, seed=0):
    _, write, fname, _, _, _ = PRODUCTS[product]
    path = tmp_path / fname
    path.parent.mkdir(parents=True, exist_ok=True)
    write(path)
    if product != "SSMIS_WV":  # raw counts: the writer's own values stay
        _roughen(path, seed)
    return str(path)


def _leaf(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def _assert_granules(got, want, exact, what):
    """Every field of the port's granule against the twin's: placeholders of
    one size, scalars equal, arrays bitwise (``exact``) or at the float32
    regrid tolerance."""
    assert type(got).__name__ == type(want).__name__, what
    for f in dataclasses.fields(got):
        a, b = _leaf(getattr(got, f.name)), _leaf(getattr(want, f.name))
        name = f"{what}.{f.name}"
        if isinstance(b, (str, bool, datetime.datetime)) or b is None:
            assert a == b, name
        elif np.size(b) <= 1:
            assert np.size(a) == np.size(b), name
        elif exact is True:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a, b, equal_nan=True), name
        elif exact:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=exact, atol=0,
                                       equal_nan=True, err_msg=name)
        elif f.name in ("latitude_center", "longitude_center"):
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
        else:
            assert np.asarray(a).dtype == np.float32, name
            assert_parity(a, b, np.float32, name)


@pytest.mark.parametrize("read_ak,trop", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("product", sorted(PRODUCTS))
def test_decode_is_bitwise_the_twins(tmp_path, product, read_ak, trop):
    mod, _, _, _, decode, _ = PRODUCTS[product]
    path = _write(tmp_path, product, seed=1)
    jmod = importlib.import_module(f"oisat_tpu.readers.sensors.{mod}")
    pmod = importlib.import_module(f"oisat_tpu_torch.readers.sensors.{mod}")
    want = decode(jmod, path, read_ak, trop)
    # GOSAT's filler computes on a device even without a CTM grid
    kw = dict(device="cpu") if product == "GOSAT_XCH4" else {}
    got = decode(pmod, path, read_ak, trop, **kw)
    assert got is not None and want is not None
    _assert_granules(got, want, 1e-12 if product == "GOSAT_XCH4" else True, product)


def _facade(cls, product, folder):
    r = cls()
    r.ctm_data = [SimpleNamespace(latitude=CLAT, longitude=CLON)]
    r.add_satellite_data(product, Path(folder))
    return r


def _read_both(monkeypatch, tmp_path, product, num_job=1, **kw):
    _, _, _, yyyymm, _, hour = PRODUCTS[product]
    monkeypatch.setenv("OISAT_PARITY", "1")
    args = dict(read_ak=True, trop=True, num_job=num_job, tempo_hour=hour)
    args.update(kw)
    jr = _facade(jax_readers, product, tmp_path)
    jr.read_satellite_data(yyyymm, **args)
    pr = _facade(port_readers, product, tmp_path)
    pr.read_satellite_data(yyyymm, device="cpu", fast_swath=False, **args)
    return pr.sat_data, jr.sat_data


@pytest.mark.parametrize("product", sorted(PRODUCTS))
def test_regridded_granules_match_the_twins(monkeypatch, tmp_path, product):
    _write(tmp_path, product, seed=2)
    got, want = _read_both(monkeypatch, tmp_path, product)
    assert len(got) == len(want) == 1 and got[0] is not None and want[0] is not None
    assert torch.is_tensor(got[0].vcd) and got[0].vcd.shape == CLON.shape
    assert int(torch.isfinite(got[0].vcd).sum()) > 3  # TEMPO covers 4 x 4 degrees
    _assert_granules(got[0], want[0], False, product)


def test_regridded_omi_without_scattering_weights_matches(monkeypatch, tmp_path):
    _write(tmp_path, "OMI_NO2", seed=3)
    got, want = _read_both(monkeypatch, tmp_path, "OMI_NO2", read_ak=False, trop=False)
    assert np.size(got[0].scattering_weights) == 1
    _assert_granules(got[0], want[0], False, "OMI_NO2 no AK")


def test_fast_swath_default_reads_through_the_native_builder(tmp_path):
    from oisat_tpu_torch import native

    _write(tmp_path, "OMI_NO2", seed=4)
    r = _facade(port_readers, "OMI_NO2", tmp_path)
    r.read_satellite_data("201907", trop=True, device="cpu")
    assert native.available() and int(torch.isfinite(r.sat_data[0].vcd).sum()) > 50


def _two_good_one_corrupt(tmp_path):
    """Three OMI files of one month: the middle one is not HDF5."""
    for day, seed in ((8, 5), (12, 6)):
        path = tmp_path / f"OMI-Aura_L2-OMNO2_2019m07{day:02}.nc"
        _omi_no2(path)
        _roughen(path, seed)
        with h5py.File(path, "a") as f:
            f["GEOLOCATION_DATA/Time"][...] = (
                datetime.datetime(2019, 7, day) - datetime.datetime(1993, 1, 1)).total_seconds()
    (tmp_path / "OMI-Aura_L2-OMNO2_2019m0710.nc").write_bytes(b"not an HDF5 file " * 20)


def test_a_corrupt_file_becomes_none(monkeypatch, tmp_path, capsys):
    _two_good_one_corrupt(tmp_path)
    got, want = _read_both(monkeypatch, tmp_path, "OMI_NO2")
    assert [g is None for g in got] == [w is None for w in want] == [False, True, False]
    assert "[OMI_NO2] failed on" in capsys.readouterr().out
    for g, w in zip(got, want):
        if g is not None:
            _assert_granules(g, w, False, "OMI_NO2")


def test_num_job_4_equals_num_job_1(tmp_path):
    """The thread pool decodes, the regrid runs one granule at a time: the
    same granules in the same order, bitwise."""
    _two_good_one_corrupt(tmp_path)
    out = {}
    for nj in (1, 4):
        r = _facade(port_readers, "OMI_NO2", tmp_path)
        r.read_satellite_data("201907", trop=True, num_job=nj, device="cpu")
        out[nj] = r.sat_data
    assert [g is None for g in out[4]] == [False, True, False]
    for a, b in zip(out[1], out[4]):
        if a is not None:
            _assert_granules(b, a, True, "num_job")
            assert a.time == b.time


def test_many_threads_on_one_device_lock_give_the_serial_month(tmp_path):
    """More decode threads than cores and a shortened switch interval: every
    granule still goes through the regrid (and its plan caches) alone, so the
    month is bitwise the serial one.  Time-bounded by the twelve small files."""
    import sys

    for day in range(1, 13):
        path = tmp_path / f"OMI-Aura_L2-OMNO2_2019m07{day:02}.nc"
        _omi_no2(path)
        _roughen(path, day)
    serial = _facade(port_readers, "OMI_NO2", tmp_path)
    serial.read_satellite_data("201907", trop=True, num_job=1, device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pooled = _facade(port_readers, "OMI_NO2", tmp_path)
        pooled.read_satellite_data("201907", trop=True, num_job=32, device="cpu")
    finally:
        sys.setswitchinterval(old)
    assert len(pooled.sat_data) == len(serial.sat_data) == 12
    for a, b in zip(serial.sat_data, pooled.sat_data):
        assert a is not None and b is not None
        _assert_granules(b, a, True, "stress")


def test_unknown_satellite_and_missing_hour_raise(tmp_path):
    r = _facade(port_readers, "MODIS_AOD", tmp_path)
    with pytest.raises(Exception, match="come tomorrow"):
        r.read_satellite_data("201907", device="cpu")
    r = _facade(port_readers, "TEMPO_NO2", tmp_path)
    with pytest.raises(ValueError, match="tempo_hour"):
        r.read_satellite_data("202309", device="cpu")


def test_reading_without_a_card_raises_unless_the_cpu_is_named(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _write(tmp_path, "OMI_NO2")
    r = _facade(port_readers, "OMI_NO2", tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        r.read_satellite_data("201907")
    from oisat_tpu_torch.readers.sensors import omi_reader

    with pytest.raises(RuntimeError, match="no CUDA device"):
        omi_reader(str(tmp_path), "OMI_NO2", CLON, CLAT, "201907", True)


# ---- ncio ------------------------------------------------------------------

def _packed_file(path):
    with h5py.File(path, "w") as f:
        g = f.create_group("a").create_group("b")
        d = g.create_dataset("packed", data=np.array([[1, 2, -999], [4, 5, 6]], np.int16))
        d.attrs["scale_factor"] = np.float32(0.5)
        d.attrs["add_offset"] = np.array([10.0])
        d.attrs["_FillValue"] = np.int16(-999)
        d.attrs["units"] = np.bytes_("K")
        fl = g.create_dataset("filled", data=np.array([1.5, -1e30, 3.0], np.float32))
        fl.attrs["_FillValue"] = np.float32(-1e30)
        g.create_dataset("counts", data=np.arange(6, dtype=np.int32).reshape(1, 6))
        g.attrs["title"] = "group"
        f["top"] = np.linspace(0.0, 1.0, 5)


def test_ncio_functions_are_bitwise_the_twins(tmp_path):
    path = tmp_path / "packed.nc"
    _packed_file(path)
    for var, group in (("packed", ["a", "b"]), ("packed", "a/b"), ("filled", ["a", "b"]),
                       ("counts", ["a", "b"]), ("top", None)):
        a, b = port_ncio.read_nc(path, var, group), jax_ncio.read_nc(path, var, group)
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), var
    packed = port_ncio.read_nc(path, "packed", "a/b")
    assert packed.dtype == np.float64 and np.isnan(packed[0, 2]) and packed[0, 0] == 10.5
    assert np.isnan(port_ncio.read_nc(path, "filled", "a/b")[1])
    assert np.array_equal(port_ncio.read_group_nc(path, ["a", "b"], "counts"),
                          jax_ncio.read_group_nc(path, ["a", "b"], "counts"))
    assert np.array_equal(port_ncio.read_nc_raw(path, "a/b/packed"),
                          jax_ncio.read_nc_raw(path, "a/b/packed"))
    assert port_ncio.read_nc_raw(path, "a/b/packed")[0, 2] == -999  # raw: no fill, no scale
    for var, group in (("packed", "a/b"), (None, ["a", "b"]), (None, None)):
        a, b = (m.get_nc_attrs(path, var, group) for m in (port_ncio, jax_ncio))
        assert list(a) == list(b)
        for k in a:
            assert type(a[k]) is type(b[k]) and np.array_equal(a[k], b[k]), k
    assert port_ncio.get_nc_attrs(path, "packed", "a/b")["units"] == "K"
    tiny = tmp_path / "tiny.nc"
    tiny.write_bytes(b"x" * 10)
    files = [str(path), str(tiny)]
    assert port_ncio.remove_empty_files(files) == jax_ncio.remove_empty_files(files) == files[:1]


# ---- CTM readers -------------------------------------------------------------

def _assert_ctm(got, want, what):
    assert len(got) == len(want) > 0, what
    for g, w in zip(got, want):
        assert type(g).__name__ == "ctm_model" and type(g).__module__.startswith("oisat_tpu_torch")
        for f in dataclasses.fields(g):
            a, b = getattr(g, f.name), getattr(w, f.name)
            name = f"{what}.{f.name}"
            if isinstance(b, np.ndarray):
                assert isinstance(a, np.ndarray) and a.dtype == b.dtype, name
                assert np.array_equal(a, b, equal_nan=True), name
            else:
                assert a == b, name


def _gmi_month(tmp_path, prefix, met, gas, days=(1, 2)):
    for day in days:
        write_gmi_pair(tmp_path / f"{prefix}.{met}.201907{day:02}.nc4",
                       tmp_path / f"{prefix}.{gas}.201907{day:02}.nc4", day)
        for kind in (met, gas):
            _roughen(tmp_path / f"{prefix}.{kind}.201907{day:02}.nc4", day)
        with h5py.File(tmp_path / f"{prefix}.{gas}.201907{day:02}.nc4", "a") as f:
            f["CH2O"] = np.random.default_rng(day).uniform(1e-10, 2e-9, f["NO2"].shape)
        with h5py.File(tmp_path / f"{prefix}.{met}.201907{day:02}.nc4", "a") as f:
            f["QV"] = np.random.default_rng(day + 9).uniform(1e-4, 2e-2, f["PL"].shape)


@pytest.mark.parametrize("gas", ["NO2", "HCHO", "H2O"])
@pytest.mark.parametrize("num_job", [1, 4])
def test_gmi_reader_is_bitwise_the_twins(tmp_path, gas, num_job):
    _gmi_month(tmp_path, "MERRA2_GMI", "tavg3_3d_met_Nv", "tavg3_3d_tac_Nv")
    got = port_ctm.GMI_reader(str(tmp_path), "201907", gas, num_job=num_job)
    want = jax_ctm.GMI_reader(str(tmp_path), "201907", gas, num_job=1)
    assert got[0].gas_profile.dtype == np.float32 and len(got) == 2
    _assert_ctm(got, want, f"GMI {gas}")


def test_higmi_reader_streams_in_float32_like_the_twin(tmp_path):
    _gmi_month(tmp_path, "HiGMI", "tavg1_3D_met_CONUS", "tavg1_3D_gasconc_CONUS",
               days=(1, 2, 3))
    got = port_ctm.Hi_GMI_reader(str(tmp_path), "201907", "NO2")
    want = jax_ctm.Hi_GMI_reader(str(tmp_path), "201907", "NO2")
    assert got[0].averaged and got[0].gas_profile.dtype == np.float32
    _assert_ctm(got, want, "HiGMI")


@pytest.mark.parametrize("gas", ["CH4", "CO", "H2O"])
def test_eccoh_reader_is_bitwise_the_twins(tmp_path, gas):
    path = tmp_path / "run.eccoh_Nv.201907.nc4"
    _write_eccoh(path, "QV" if gas == "H2O" else gas, 1.8e-6)
    _roughen(path, 7)
    got = port_ctm.ECCOH_reader(str(tmp_path), "201907", gas)
    want = jax_ctm.ECCOH_reader(str(tmp_path), "201907", gas)
    _assert_ctm(got, want, f"ECCOH {gas}")
    if gas == "CH4":  # the moist -> dry step ran: above the raw ppbv values
        raw = np.flip(jax_ncio.read_nc(path, "CH4"), axis=0) * 1e9
        ok = np.isfinite(got[0].gas_profile) & (raw > 0)
        assert (got[0].gas_profile[ok] > raw[ok]).all()


def _cmaq_month(tmp_path, nt=4, nz=3, nlat=6, nlon=7):
    rng = np.random.default_rng(11)
    tflag = np.zeros((nt, 2, 2), np.int32)
    for t in range(nt):
        tflag[t, :, 0] = 2019188
        tflag[t, :, 1] = t * 10000
    for tag in ("20190707", "20190708"):
        with h5py.File(tmp_path / f"CCTM_CONC_{tag}.nc", "w") as f:
            f["TFLAG"] = tflag
            f["FORM"] = rng.uniform(1e-3, 3e-3, (nt, nz, nlat, nlon))
        with h5py.File(tmp_path / f"METCRO3D_{tag}", "w") as f:
            f["PRES"] = (np.linspace(90000, 50000, nz)[None, :, None, None]
                         * rng.uniform(0.98, 1.02, (nt, nz, nlat, nlon)))
        with h5py.File(tmp_path / f"METCRO2D_{tag}", "w") as f:
            f["PRSFC"] = rng.uniform(100000.0, 102000.0, (nt, nlat, nlon))
        with h5py.File(tmp_path / f"GRIDCRO2D_{tag}", "w") as f:
            f["LAT"] = np.linspace(30, 45, nlat)[:, None] * np.ones((nlat, nlon))
            f["LON"] = np.ones((nlat, 1)) * np.linspace(-10, 10, nlon)[None, :]


def test_cmaq_reader_is_bitwise_the_twins(tmp_path):
    _cmaq_month(tmp_path)
    got = port_ctm.CMAQ_reader(str(tmp_path), str(tmp_path), "201907", "HCHO")
    want = jax_ctm.CMAQ_reader(str(tmp_path), str(tmp_path), "201907", "HCHO")
    assert got[0].ctmtype == "CMAQ" and got[0].averaged
    _assert_ctm(got, want, "CMAQ")


def test_free_ctm_and_the_loud_failures(tmp_path):
    ctl = tmp_path / "control_free.yml"
    ctl.write_text("lonll: -10.0\nlonur: 10.0\nlatll: 30.0\nlatur: 45.0\ngridsize: 1.0\n")
    _assert_ctm(port_ctm.free_ctm(str(ctl)), jax_ctm.free_ctm(str(ctl)), "FREE")
    with pytest.raises(FileNotFoundError, match="no GMI met"):
        port_ctm.GMI_reader(str(tmp_path), "201907", "NO2")
    with pytest.raises(FileNotFoundError, match="no HiGMI met"):
        port_ctm.Hi_GMI_reader(str(tmp_path), "201907", "NO2")
    with pytest.raises(FileNotFoundError, match="no CMAQ conc"):
        port_ctm.CMAQ_reader(str(tmp_path), str(tmp_path), "201907", "NO2")
    with pytest.raises(ValueError, match="3-hourly"):
        port_ctm.GMI_reader(str(tmp_path), "201907", "NO2", frequency_opt="hourly")
    (tmp_path / "CCTM_CONC_201907a.nc").write_bytes(b"x" * 200)
    with pytest.raises(Exception, match="not consistent"):
        port_ctm.CMAQ_reader(str(tmp_path), str(tmp_path), "201907", "NO2")
    with pytest.raises(RuntimeError, match="inconsistent file lists"):
        port_ctm._stream_average(iter([]), 2, "HiGMI")


@pytest.mark.parametrize("averaging", [False, True])
def test_facade_reads_gmi_with_and_without_averaging(tmp_path, averaging):
    _gmi_month(tmp_path, "MERRA2_GMI", "tavg3_3d_met_Nv", "tavg3_3d_tac_Nv")
    out = []
    for cls in (port_readers, jax_readers):
        r = cls()
        r.add_ctm_data("GMI", tmp_path)
        r.read_ctm_data("201907", "NO2", "3-hourly", averaging=averaging, num_job=1)
        out.append(r.ctm_data)
    assert len(out[0]) == (1 if averaging else 2) and out[0][0].averaged is averaging
    _assert_ctm(*out, f"facade GMI averaging={averaging}")
    r = port_readers()
    r.add_ctm_data("WRF", tmp_path)
    with pytest.raises(ValueError, match="unknown CTM product"):
        r.read_ctm_data("201907", "NO2", "3-hourly")
