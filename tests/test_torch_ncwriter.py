"""The port's file writers (oisat_tpu_torch.ncwriter, .utils.granule_store,
.report, .utils.profiling, .data) against the JAX package's, on the CPU.

Each package reads what the other wrote: the diag netCDF (variable names and
their order, float32 fields, dimension scales, the ``S1`` time characters,
global attributes name for name), ``write_nc`` files, and the granule store
(all three granule classes and ``None``; a tensor leaf is pulled to the host on
save).  Values written and read back are bitwise equal.  The PDF report has the
twin's page count.
"""

import datetime
import json
import re
import time

import h5py
import numpy as np
import pytest
import torch

from oisat_tpu import datamodel as jdm
from oisat_tpu import ncwriter as jax_nc
from oisat_tpu.report import report as jax_report
from oisat_tpu.utils import granule_store as jax_store
from oisat_tpu_torch import datamodel as pdm
from oisat_tpu_torch import ncwriter as port_nc
from oisat_tpu_torch.convert import granule_to
from oisat_tpu_torch.report import draw_coastlines, report as port_report
from oisat_tpu_torch.utils import granule_store as port_store
from oisat_tpu_torch.utils import profiling

torch.set_num_threads(1)

NAMES = ["sat_averaged_vcd", "ctm_averaged_vcd_prior", "ctm_averaged_vcd_posterior",
         "sat_averaged_error", "ak_OI", "error_OI", "scaling_factor", "lon", "lat",
         "aux1", "aux2"]
# what oi_diagnostics holds: floats, an int, a string, a bool (the solver's info)
ATTRS = {"n": 214.0, "omb_mean": -0.25, "chi2": 1.5, "desroziers_iterations": 2,
         "solver": "dense+direct_f64_dev", "exact_diag": True, "reg": 0.5}


def _fields(seed=0, H=6, W=9, extra=False):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(3, 1, (H, W)) for n in NAMES}
    out["ak_OI"][0, 0] = np.nan
    if extra:
        out["desroziers_sa_scale"] = rng.uniform(0.5, 2, (H, W))
        out["desroziers_so_scale"] = rng.uniform(0.5, 2, (H, W))
    return out


def _layout(path):
    """What defines the file for a netCDF reader: per dataset its dtype, shape
    and attached dimension scales, and the global attributes."""
    out = {}
    with h5py.File(path, "r") as f:
        for name, ds in f.items():
            scales = [[s.name for s in d.values()] for d in ds.dims]
            data = np.asarray(ds)
            if data.dtype.kind == "f":
                data = np.nan_to_num(data, nan=-777.0)  # NaN != NaN in a list
            out[name] = (str(ds.dtype), ds.shape, ds.maxshape, scales,
                         bool(ds.is_scale), data.tolist())
        attrs = {k: (type(v).__name__, v if not isinstance(v, np.generic) else v.item())
                 for k, v in f.attrs.items()}
    return out, attrs


@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_diag_file_crosses_between_the_packages(tmp_path, writer, reader, extra):
    mods = {"port": port_nc, "jax": jax_nc}
    fields = _fields(1, extra=extra)
    tstr = "2019-07-15 12:30:00"
    path = tmp_path / "diag.nc"
    mods[writer].write_diag_nc(path, fields, tstr, global_attrs=ATTRS)
    got, got_t, got_attrs = mods[reader].read_diag_nc(path, with_attrs=True)
    assert got_t == tstr
    assert mods[reader].read_diag_nc(path)[1] == tstr
    assert set(got) == set(fields)
    for name, want in fields.items():
        assert got[name].dtype == np.float32, name
        assert np.array_equal(got[name], want.astype(np.float32), equal_nan=True), name
    assert set(got_attrs) == set(ATTRS)  # HDF5 lists names alphabetically
    for k, v in ATTRS.items():
        assert got_attrs[k] == v, k


def test_diag_file_layout_is_the_twins(tmp_path):
    fields = _fields(2, extra=True)
    port_nc.write_diag_nc(tmp_path / "p.nc", fields, "2019-07-15 12:30:00", ATTRS)
    jax_nc.write_diag_nc(tmp_path / "j.nc", fields, "2019-07-15 12:30:00", ATTRS)
    p, pa = _layout(tmp_path / "p.nc")
    j, ja = _layout(tmp_path / "j.nc")
    assert list(p) == list(j) and p == j
    assert pa == ja
    assert p["time"][0] == "|S1" and p["time"][3] == [["/t"]]
    assert p["ak_OI"][3] == [["/x"], ["/y"]] and p["x"][4] and p["y"][4] and p["t"][4]
    with pytest.raises(KeyError, match="no 'time' variable"):
        with h5py.File(tmp_path / "bare.nc", "w") as f:
            f["x"] = np.arange(3.0)
        port_nc.read_diag_nc(tmp_path / "bare.nc")


def test_write_nc_is_the_twins(tmp_path):
    from oisat_tpu.readers.ncio import read_nc as jax_read_nc
    from oisat_tpu_torch.readers.ncio import get_nc_attrs, read_nc

    rng = np.random.default_rng(3)
    dims = {"time": np.array([0.0]), "lat": np.linspace(-80, 80, 4), "lon": 5}
    variables = {"SF": (("time", "lat", "lon"), rng.uniform(0.5, 2, (1, 4, 5)),
                        {"units": "1", "long_name": "scaling factor"}),
                 "time": (("time",), None, {"units": "hours since 2019-07-01"})}
    for mod, name in ((port_nc, "p.nc"), (jax_nc, "j.nc")):
        mod.write_nc(tmp_path / name, dims, variables, {"source": "test", "version": 2})
    assert _layout(tmp_path / "p.nc") == _layout(tmp_path / "j.nc")
    assert np.array_equal(read_nc(tmp_path / "p.nc", "SF"), jax_read_nc(tmp_path / "j.nc", "SF"))
    assert get_nc_attrs(tmp_path / "p.nc", "time")["units"] == "hours since 2019-07-01"
    assert get_nc_attrs(tmp_path / "p.nc")["version"] == 2


# ---- granule store ------------------------------------------------------------

def _granules(dm, seed=0, H=4, W=5, L=3):
    """One granule of each class with every kind of leaf: arrays, size-1 and
    ``[]`` placeholders, a bool, a string, a datetime."""
    r = np.random.default_rng(seed)
    lat, lon = np.meshgrid(np.linspace(30, 33, H), np.linspace(-5, -1, W), indexing="ij")

    def f(*shape):
        return r.normal(2, 0.5, shape).astype(np.float32)

    amf = dm.satellite_amf(
        vcd=f(H, W), amf=f(H, W), time=datetime.datetime(2019, 7, 4, 13, 30),
        tropopause=np.empty((1,)), latitude_center=lat, longitude_center=lon,
        latitude_corner=[], longitude_corner=[], uncertainty=f(H, W), quality_flag=[],
        pressure_mid=f(L, H, W), scattering_weights=f(L, H, W), ctm_upscaled_needed=True,
        ctm_vcd=f(H, W), ctm_time_at_sat=np.float64(20190704.5), old_amf=[], new_amf=f(H, W))
    opt = dm.satellite_opt(
        vcd=f(H, W), time=datetime.datetime(2019, 7, 5, 12), profile=[],
        tropopause=np.empty((1,)), latitude_center=lat, longitude_center=lon,
        latitude_corner=[], longitude_corner=[], uncertainty=f(H, W), quality_flag=[],
        pressure_mid=f(L, H, W), averaging_kernels=f(L + 1, H, W), ctm_vcd=[], ctm_xcol=[],
        ctm_time_at_sat=[], aprior_column=np.zeros((1,)), apriori_profile=f(L, H, W),
        surface_pressure=np.zeros((1,)), apriori_surface=np.zeros((1,)), x_col=f(H, W),
        pressure_weight=np.empty((1,)), sensor="MOPITT")
    ssm = dm.satellite_ssmis(vcd=f(H, W), uncertainty=f(H, W),
                             time=datetime.datetime(2010, 1, 1), latitude_center=lat,
                             longitude_center=lon, ctm_upscaled_needed=False, ctm_vcd=[],
                             sensor="SSMI")
    return [amf, None, opt, ssm]


def _assert_same_granules(got, want, cls_module):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert type(g).__name__ == type(w).__name__
        assert type(g).__module__ == cls_module
        for name, b in vars(w).items():
            a = getattr(g, name)
            b = b.detach().cpu().numpy() if torch.is_tensor(b) else b
            if isinstance(b, np.ndarray) or isinstance(b, np.generic):
                assert isinstance(a, np.ndarray), name
                assert a.dtype == np.asarray(b).dtype and a.shape == np.shape(b), name
                if np.size(b) > 1 or name not in ("tropopause", "pressure_weight"):
                    assert np.array_equal(a, b, equal_nan=True), name  # np.empty: any value
            else:
                assert a == b and type(a) is type(b), name


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_granule_store_crosses_between_the_packages(tmp_path, writer, reader):
    store = {"port": port_store, "jax": jax_store}
    dm = {"port": pdm, "jax": jdm}
    want = _granules(dm[writer], seed=4)
    path = tmp_path / "store.h5"
    store[writer].save_granules(path, want)
    got = store[reader].load_granules(path)
    _assert_same_granules(got, want, dm[reader].__name__)


def test_granule_store_pulls_tensor_leaves_and_skips_bookkeeping(tmp_path):
    host = _granules(pdm, seed=5)
    dev = [g if g is None else granule_to(g, "cpu") for g in host]
    assert torch.is_tensor(dev[0].vcd) and isinstance(dev[0].latitude_center, np.ndarray)
    assert not torch.is_tensor(dev[0].tropopause) and dev[2].quality_flag == []
    dev[0]._scratch = object()  # an underscore attribute is derived state
    port_store.save_granules(tmp_path / "s.h5", dev)
    with h5py.File(tmp_path / "s.h5", "r") as f:
        assert "_scratch" not in f["g0000"] and f.attrs["n"] == 4
        assert f["g0001"].attrs["class"] == "none"
        assert f["g0000"].attrs["empty:quality_flag"] == 1
    _assert_same_granules(port_store.load_granules(tmp_path / "s.h5"), host, pdm.__name__)
    _assert_same_granules(jax_store.load_granules(tmp_path / "s.h5"), host, jdm.__name__)


# ---- report ---------------------------------------------------------------------

def _pages(path):
    return len(re.findall(rb"/Type\s*/Page\b(?!s)", open(path, "rb").read()))


@pytest.mark.parametrize("gas,n_pages", [("NO2", 10), ("HCHO", 10), ("CO", 10), ("CH4", 10),
                                         ("O3", 8), ("H2O", 8)])
def test_report_has_the_twins_pages(tmp_path, gas, n_pages):
    H, W = 8, 10
    rng = np.random.default_rng(6)
    lon, lat = np.meshgrid(np.linspace(-10, 10, W), np.linspace(30, 45, H))
    args = [np.abs(rng.normal(3, 1, (H, W))) for _ in range(9)]
    p = port_report(lon, lat, *args, f"{gas}_201907", str(tmp_path / "p"), gas)
    j = jax_report(lon, lat, *args, f"{gas}_201907", str(tmp_path / "j"), gas)
    assert p.endswith(f"OI_report_{gas}_201907.pdf")
    assert open(p, "rb").read(5) == b"%PDF-"
    assert _pages(p) == _pages(j) == n_pages


def test_report_skips_placeholders_and_refuses_an_unknown_gas(tmp_path):
    z = np.ones((4, 5))
    lon, lat = np.meshgrid(np.linspace(-10, 10, 5), np.linspace(30, 45, 4))
    args = [z * 3] * 7 + [np.empty((1,)), np.empty((1,))]
    p = port_report(lon, lat, *args, "NO2_x", str(tmp_path), "NO2")
    j = jax_report(lon, lat, *args, "NO2_y", str(tmp_path), "NO2")
    assert _pages(p) == _pages(j) == 8
    with pytest.raises(ValueError, match="no report ranges"):
        port_report(lon, lat, *([z] * 9), "X_1", str(tmp_path), "XYZ")


def test_coastlines_are_the_twins_data():
    from oisat_tpu import data as jax_data
    from oisat_tpu_torch import data as port_data

    a, b = port_data.coastline_segments(), jax_data.coastline_segments()
    assert len(a) == len(b) > 10
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert port_data.coastlines_source() == jax_data.coastlines_source()

    class Ax:
        def __init__(self):
            self.lines = 0

        def plot(self, x, y, **kw):
            self.lines += 1

        def set_xlim(self, *a):
            pass

        set_ylim = set_xlim

    ax = Ax()
    draw_coastlines(ax, -130.0, -60.0, 20.0, 55.0)
    assert ax.lines > 0


# ---- profiling ----------------------------------------------------------------------

def test_stage_registry_times_and_reports():
    profiling.reset()
    with profiling.stage("alpha"):
        time.sleep(0.01)
    with profiling.stage("alpha", sync=torch.zeros(2), granule="x"):
        pass
    with profiling.stage("beta", sync="cpu"):
        pass
    rep = json.loads(profiling.report())
    assert rep["alpha"]["count"] == 2 and rep["alpha"]["total_s"] >= 0.01
    assert list(rep)[0] == "alpha" and rep["beta"]["count"] == 1
    profiling.reset()
    assert json.loads(profiling.report()) == {}


def test_log_prints_fields_as_json(capsys):
    profiling.log("month done", year=2019, month=7)
    profiling.log("plain")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("month done ") and json.loads(out[0][11:]) == {
        "year": 2019, "month": 7}
    assert out[1] == "plain"


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 100
    assert any("mm" in e.key or "matmul" in e.key for e in prof.key_averages())
