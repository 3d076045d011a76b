"""The port's job runner (oisat_tpu_torch.run.job / .run.campaign), its
driver's file methods, ``tools.readjust_OI`` and the example against the JAX
package's ``run/job.py``, ``tools/readjust_OI.py`` and ``examples/``, on the
CPU, from files to files.

Every month that tests/test_job.py runs is written once into a temp directory
(the generators of tests/test_sensors.py, tests/test_ctm_readers.py and
tests/test_job.py) and run by both packages under the same control keys, each
into its own output folders.  Both sides run at full precision with the scipy
weight builders (``parity: true``: the JAX runner pins ``OISAT_PARITY=1``, the
port passes ``fast_swath=False``); the port runs on ``device: cpu``.

Tolerance: every variable of the diag netCDF (read with the JAX package's
``read_diag_nc``) within rtol 1e-5 plus 1e-6 of the variable's largest
magnitude, identical NaN patterns, the same variable names, the same knee
factor (both drivers print it), the innovation count equal and the other
global attributes at rtol 1e-4.  An ``oi_method: full`` month whose float64
tail does not run ends in the float32 dense scan, whose two eigensolvers agree
to 5e-4 (tests/test_torch_oi_full.py): its posterior fields and residual
statistics are held at that.  (A Desroziers pass on such a month re-estimates
So from the cancelling y - xb of that scan, and the two packages' scales then
part by 2e-3: the job months keep Desroziers on the scalar OI.)
"""

import datetime
import importlib.util
import os
import re
import runpy
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
import torch

from oisat_tpu.ncwriter import read_diag_nc as jax_read_diag_nc
from oisat_tpu_torch.driver import oisatgmi
from oisat_tpu_torch.ncwriter import read_diag_nc
from oisat_tpu_torch.run import campaign as port_campaign
from oisat_tpu_torch.run import job as port_job
from tests import test_job as tj
from tests.test_ctm_readers import write_gmi_pair
from tests.test_sensors import (write_gosat, write_mopitt, write_omi_no2, write_ssmis,
                                write_tempo_no2)
from tests.test_tools import make_diag

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FREE_BOX = "lonll: -10.0\nlonur: 10.0\nlatll: 30.0\nlatur: 45.0\ngridsize: 1.0\n"
FACTOR = re.compile(r"The regularization factor is ([0-9.]+)")


def _jax_module(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "run" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctrl(tmp_path, **over):
    """tests/test_job.py's base control file, with the parity builders and,
    for the port, the CPU."""
    ctrl = tj._base_ctrl(tmp_path, parity=True, device="cpu")
    ctrl.update(over)
    (tmp_path / "control_free.yml").write_text(FREE_BOX)
    return ctrl


def _eccoh(tmp_path, yyyymm, gas, value):
    path = tmp_path / "ctm" / f"run.eccoh_Nv.{yyyymm}.nc4"
    tj._write_eccoh(path, gas, value)
    with h5py.File(path, "a") as f:
        f["time"].attrs["begin_date"] = np.int32(int(yyyymm) * 100 + 1)
        # a structured field instead of the generator's constant
        f[gas][...] = f[gas][...] * np.random.default_rng(0).uniform(0.8, 1.2, f[gas].shape)


def _gmi(tmp_path):
    write_gmi_pair(tmp_path / "ctm" / "MERRA2_GMI.tavg3_3d_met_Nv.20190710.nc4",
                   tmp_path / "ctm" / "MERRA2_GMI.tavg3_3d_tac_Nv.20190710.nc4", 10,
                   nlat=16, nlon=17)


def _omi_no2(tmp_path, days=(10,)):
    """OMI NO2 files whose columns vary over the swath (a flat field leaves
    the knee to rounding)."""
    for day in days:
        path = tmp_path / "sat" / f"OMI-Aura_L2-OMNO2_2019m07{day:02}.nc"
        write_omi_no2(path)
        rng = np.random.default_rng(day)
        with h5py.File(path, "a") as f:
            for name in ("ColumnAmountNO2Trop", "ColumnAmountNO2TropStd", "AmfTrop"):
                d = f["SCIENCE_DATA"][name]
                d[...] = d[...] * rng.uniform(0.6, 1.4, d.shape)
            f["SCIENCE_DATA"]["ColumnAmountNO2"] = f["SCIENCE_DATA"]["ColumnAmountNO2Trop"][...]
            f["SCIENCE_DATA"]["Amf"] = f["SCIENCE_DATA"]["AmfTrop"][...]
            f["SCIENCE_DATA"]["ColumnAmountNO2Std"] = f["SCIENCE_DATA"]["ColumnAmountNO2TropStd"][...]
            f["GEOLOCATION_DATA/Time"][...] = (
                datetime.datetime(2019, 7, day) - datetime.datetime(1993, 1, 1)).total_seconds()


# name -> (set-up of the files, control overrides, (year, month), diag tag)
def _free_omi(tmp):
    _omi_no2(tmp)


def _gmi_omi(tmp):
    _gmi(tmp)
    _omi_no2(tmp, days=(9, 10, 11))


def _mopitt(tmp):
    _eccoh(tmp, "201907", "CO", 9e-8)
    write_mopitt(tmp / "sat" / "MOP03JM-201907.he5")


def _gosat(tmp):
    _eccoh(tmp, "201006", "CH4", 1.8e-6)
    (tmp / "sat" / "2010").mkdir(parents=True)
    write_gosat(tmp / "sat" / "2010" / "ESACCI-GHG-20100615.nc")


def _ssmis(tmp):
    _eccoh(tmp, "201001", "QV", 0.004)
    write_ssmis(tmp / "sat" / "f16_201001v7.nc")


MONTHS = {
    "free_omi_no2": (_free_omi, dict(troposphere_only=True), (2019, 7), "NO2_201907"),
    "free_omi_no2_full": (_free_omi, dict(troposphere_only=True, oi_method="full",
                                          length_scale_km=200.0), (2019, 7), "NO2_201907"),
    "gmi_omi_no2": (_gmi_omi, dict(ctm_name="GMI", ctm_avg=True, troposphere_only=True),
                    (2019, 7), "NO2_201907"),
    "gmi_omi_no2_daily": (_gmi_omi, dict(ctm_name="GMI", troposphere_only=True,
                                         save_daily=True, num_job=3), (2019, 7), "NO2_201907"),
    "gmi_omi_no2_fused": (_gmi_omi, dict(ctm_name="GMI", ctm_avg=True, troposphere_only=True,
                                         fused_month=True, save_daily=True), (2019, 7),
                          "NO2_201907"),
    "gmi_omi_no2_fused_full_weighted": (
        _gmi_omi, dict(ctm_name="GMI", ctm_avg=True, troposphere_only=True, fused_month=True,
                       oi_method="full", length_scale_km=250.0,
                       averaging_weighting="inverse_variance"), (2019, 7), "NO2_201907"),
    "gmi_omi_no2_fused_desroziers": (
        _gmi_omi, dict(ctm_name="GMI", ctm_avg=True, troposphere_only=True, fused_month=True,
                       desroziers_iterations=1), (2019, 7), "NO2_201907"),
    "gmi_omi_no2_binned_desroziers": (
        _gmi_omi, dict(ctm_name="GMI", ctm_avg=True, troposphere_only=True,
                       desroziers_iterations=2, desroziers_bins=3), (2019, 7), "NO2_201907"),
    "eccoh_mopitt_co": (_mopitt, dict(ctm_name="ECCOH", gas="CO", sensor="MOPITT"),
                        (2019, 7), "CO_201907"),
    "eccoh_mopitt_co_fused": (_mopitt, dict(ctm_name="ECCOH", gas="CO", sensor="MOPITT",
                                            fused_month=True), (2019, 7), "CO_201907"),
    "eccoh_gosat_ch4": (_gosat, dict(ctm_name="ECCOH", gas="CH4", sensor="GOSAT",
                                     start_date="2010-06", end_date="2010-06"),
                        (2010, 6), "CH4_201006"),
    "omi_hcho": (lambda tmp: tj._write_omi_hcho(tmp / "sat" / "OMI-Aura_L2-OMHCHO_2019m0710.nc"),
                 dict(gas="HCHO"), (2019, 7), "HCHO_201907"),
    "omi_o3": (lambda tmp: tj._write_omi_o3(tmp / "sat" / "OMI-Aura_L2-OMTO3_2019m0710.he5"),
               dict(gas="O3", read_AK=False), (2019, 7), "O3_201907"),
    "eccoh_ssmis_h2o": (_ssmis, dict(ctm_name="ECCOH", gas="H2O", sensor="SSMIS",
                                     start_date="2010-01", end_date="2010-01"),
                        (2010, 1), "H2O_201001"),
}


POSTERIOR = ("ctm_averaged_vcd_posterior", "ak_OI", "error_OI", "scaling_factor")


def _assert_diag_equal(port_nc, jax_nc, scan_tol=None):
    """The port's diag file against the JAX run's, both read by the JAX
    package's reader; ``scan_tol`` widens the posterior fields of a month that
    ends in the float32 dense scan."""
    got, got_t, got_attrs = jax_read_diag_nc(port_nc, with_attrs=True)
    want, want_t, want_attrs = jax_read_diag_nc(jax_nc, with_attrs=True)
    assert list(got) == list(want) and got_t == want_t
    own, own_t = read_diag_nc(port_nc)  # and the port reads its own file
    assert own_t == got_t and all(np.array_equal(own[k], got[k], equal_nan=True) for k in got)
    for name, b in want.items():
        a = got[name]
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, name
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        fin = np.isfinite(b)
        tol = scan_tol if scan_tol and name in POSTERIOR else 1e-5
        if fin.any():
            np.testing.assert_allclose(a[fin], b[fin], rtol=tol,
                                       atol=0.1 * tol * float(np.abs(b[fin]).max()),
                                       err_msg=name)
    assert set(got_attrs) == set(want_attrs)
    for k, v in want_attrs.items():
        if isinstance(v, (str, bytes, bool, np.bool_)) or k in ("n", "reg", "desroziers_bins",
                                                                "desroziers_iterations"):
            assert got_attrs[k] == v, k
        elif k == "f64_resid":
            assert got_attrs[k] <= 1e-5 and v <= 1e-5
        else:
            # y - xb cancels: the residual statistics are held on the scale of xb
            tol = scan_tol if scan_tol and k.startswith("oma") else 1e-4
            scale = float(np.nanmax(np.abs(want["ctm_averaged_vcd_posterior"]))) \
                if k.startswith("oma") else 0.1
            np.testing.assert_allclose(got_attrs[k], v, rtol=tol, atol=tol * scale, err_msg=k)
    return got


def _run_both(tmp_path, monkeypatch, capsys, name):
    setup, over, (year, month), tag = MONTHS[name]
    ctrl = _ctrl(tmp_path, **over)
    setup(tmp_path)
    monkeypatch.chdir(tmp_path)
    runs = {}
    for side, run_month in (("jax", _jax_module("job").run_month), ("port", port_job.run_month)):
        c = dict(ctrl, output_nc_dir=str(tmp_path / side / "diag"),
                 output_pdf_dir=str(tmp_path / side / "report"))
        capsys.readouterr()
        run_month(c, year, month)
        runs[side] = (c, FACTOR.findall(capsys.readouterr().out))
    return runs, tag


@pytest.mark.parametrize("name", sorted(MONTHS))
def test_run_month_matches_the_jax_job(tmp_path, monkeypatch, capsys, name):
    runs, tag = _run_both(tmp_path, monkeypatch, capsys, name)
    ctrl = runs["port"][0]
    assert runs["port"][1] == runs["jax"][1], "knee factors differ"
    full = ctrl.get("oi_method") == "full"
    assert len(runs["port"][1]) == (0 if full else 1)  # the full OI reports "reg" instead
    fields = _assert_diag_equal(tmp_path / "port" / "diag" / f"{tag}.nc",
                                tmp_path / "jax" / "diag" / f"{tag}.nc",
                                scan_tol=5e-4 if full else None)
    assert np.isfinite(fields["sat_averaged_vcd"]).sum() > 5
    assert np.isfinite(fields["scaling_factor"]).all()
    if ctrl["ctm_name"] != "FREE":
        assert np.isfinite(fields["ctm_averaged_vcd_posterior"]).sum() > 5
    assert ("desroziers_sa_scale" in fields) == (ctrl.get("desroziers_bins", 1) > 1)
    pdf = tmp_path / "port" / "report" / f"OI_report_{tag}.pdf"
    assert pdf.read_bytes()[:5] == b"%PDF-"
    if ctrl.get("save_daily"):
        import scipy.io as sio

        mats = {side: sorted(p.name for p in (tmp_path / side / "diag").glob("sat_data_*.mat"))
                for side in ("port", "jax")}
        assert mats["port"] == mats["jax"] and len(mats["port"]) == 3
        for m in mats["port"]:
            a = sio.loadmat(str(tmp_path / "port" / "diag" / m))
            b = sio.loadmat(str(tmp_path / "jax" / "diag" / m))
            for key in ("vcd_sat", "vcd_ctm", "vcd_err", "time_sat", "lat", "lon"):
                np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-6, equal_nan=True,
                                           err_msg=f"{m} {key}")


def test_oi_full_control_keys_reach_the_solver(tmp_path, monkeypatch):
    """``oi_method: full`` + ``length_scale_km`` select the full-covariance
    OI; an unknown method raises."""
    import oisat_tpu_torch.driver as port_driver

    ctrl = _ctrl(tmp_path, troposphere_only=True, oi_method="full", length_scale_km=200.0)
    _omi_no2(tmp_path)
    monkeypatch.chdir(tmp_path)
    calls = []
    real = port_driver.oi_full

    def spy(xa, y, sigma_b, sigma_o, lat, lon, length_scale_km, **kw):
        calls.append((float(length_scale_km), str(kw["device"])))
        return real(xa, y, sigma_b, sigma_o, lat, lon, length_scale_km, **kw)

    monkeypatch.setattr(port_driver, "oi_full", spy)
    port_job.run_month(ctrl, 2019, 7)
    assert calls == [(200.0, "cpu")]
    with pytest.raises(ValueError, match="oi_method"):
        port_job.run_month(dict(ctrl, oi_method="cheese"), 2019, 7)


def test_tempo_hour_loop_matches_the_jax_job(tmp_path, monkeypatch, capsys):
    """24 per-hour pipelines with per-hour fault tolerance: only hour 18 has
    data, the other 23 fail inside their ``try`` and the job completes; the
    hour that should succeed did, and gives the JAX job's diag file."""
    (tmp_path / "sat").mkdir()
    write_tempo_no2(tmp_path / "sat" / "TEMPO_NO2_L2_20230905T180000.nc")
    ctrl = _ctrl(tmp_path, sensor="TEMPO", ctm_freq="hourly", read_AK=False,
                 troposphere_only=True, start_date="2023-09", end_date="2023-09")
    (tmp_path / "control_free.yml").write_text(
        "lonll: -6.0\nlonur: 0.0\nlatll: 33.0\nlatur: 39.0\ngridsize: 0.5\n")
    monkeypatch.chdir(tmp_path)
    hours = []
    for side, run_month in (("jax", _jax_module("job").run_month), ("port", port_job.run_month)):
        c = dict(ctrl, output_nc_dir=str(tmp_path / side / "diag"),
                 output_pdf_dir=str(tmp_path / side / "report"))
        capsys.readouterr()
        run_month(c, 2023, 9, on_hour=hours.append if side == "port" else None)
        out = capsys.readouterr().out
        assert len(re.findall(r"Error processing hour \d+:", out)) == 23
        assert "Error processing hour 18:" not in out
        assert sorted(p.name for p in (tmp_path / side / "diag").glob("*.nc")) == [
            "NO2_202309_18UTC.nc"]
    assert hours == list(range(24))
    _assert_diag_equal(tmp_path / "port" / "diag" / "NO2_202309_18UTC.nc",
                       tmp_path / "jax" / "diag" / "NO2_202309_18UTC.nc")
    assert (tmp_path / "port" / "report" / "OI_report_NO2_202309_18UTC.pdf").exists()


def test_fused_month_falls_back_to_the_staged_path(tmp_path, monkeypatch, capsys):
    """A ``fused_month: true`` month the fused step refuses (no scattering
    weights: ``read_AK: false``) prints the fallback line and finishes
    staged, with the staged job's result."""
    ctrl = _ctrl(tmp_path, ctm_name="GMI", ctm_avg=True, troposphere_only=True,
                 read_AK=False, fused_month=True)
    _gmi(tmp_path)
    _omi_no2(tmp_path, days=(9, 10))
    monkeypatch.chdir(tmp_path)
    for sub, fused in (("fused", True), ("staged", False)):
        c = dict(ctrl, fused_month=fused, output_nc_dir=str(tmp_path / sub / "diag"),
                 output_pdf_dir=str(tmp_path / sub / "report"))
        capsys.readouterr()
        port_job.run_month(c, 2019, 7)
        said = "fused month not applicable (fused month path needs scattering weights)" \
            in capsys.readouterr().out
        assert said is fused
    a, _ = read_diag_nc(tmp_path / "fused" / "diag" / "NO2_201907.nc")
    b, _ = read_diag_nc(tmp_path / "staged" / "diag" / "NO2_201907.nc")
    assert all(np.array_equal(a[k], b[k], equal_nan=True) for k in b) and len(a) == 11


def test_job_helpers_and_what_the_port_refuses(tmp_path, monkeypatch):
    jax_job = _jax_module("job")
    for ym in ((2019, 7), (2019, 12), (2020, 2)):
        assert port_job.month_window(*ym) == jax_job.month_window(*ym)
    assert port_job.month_window(2019, 12) == ("2019-12-01", "2020-01-01")
    sub = _jax_module("job_submitter")
    for window in (("2005-11", "2006-02"), ("2019-05", "2019-08"), ("2004-12", "2006-01")):
        assert port_campaign.month_list(*window) == sub.month_list(*window)
    assert port_job.fused_eligible({"fused_month": True}) and not port_job.fused_eligible({})
    ctrl = _ctrl(tmp_path, troposphere_only=True)
    kw = port_job.reader_kwargs(ctrl)
    assert kw["read_ak"] == "False" and kw["fast_swath"] is False and kw["device"] == "cpu"
    kw = port_job.reader_kwargs(dict(ctrl, ctm_name="GMI", parity=False, num_job="4"))
    assert kw["read_ak"] is True and kw["fast_swath"] is True and kw["num_job"] == 4
    import yaml

    (tmp_path / "control.yml").write_text(yaml.safe_dump(ctrl))
    monkeypatch.chdir(tmp_path)
    assert port_job.load_control() == jax_job.load_control() == ctrl
    # mesh_devices: with device: cpu, N logical CPU shards run the month and
    # give the mesh-less month's file (the month steps' float32 bound); on
    # the card, more cards than the host has raise before any file is read
    from oisat_tpu_torch import regridder

    monkeypatch.setitem(regridder._REGRID_MESH, "mesh", None)  # run_month sets it
    _gmi(tmp_path)
    _omi_no2(tmp_path, days=(9, 10))
    month = dict(ctrl, ctm_name="GMI", ctm_avg=True, fused_month=True)
    for sub, md in (("single", 1), ("mesh", 4), ("all", "all")):
        port_job.run_month(dict(month, mesh_devices=md, output_nc_dir=str(tmp_path / sub),
                                output_pdf_dir=str(tmp_path / sub)), 2019, 7)
    assert regridder._regrid_mesh_default() is None  # "all" of the CPU: one position
    a, _ = read_diag_nc(tmp_path / "mesh" / "NO2_201907.nc")
    b, _ = read_diag_nc(tmp_path / "single" / "NO2_201907.nc")
    c, _ = read_diag_nc(tmp_path / "all" / "NO2_201907.nc")
    assert list(a) == list(b) and np.isfinite(b["ctm_averaged_vcd_posterior"]).sum() > 5
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6 * np.nanmax(np.abs(b[k])),
                                   equal_nan=True, err_msg=k)
        assert np.array_equal(c[k], b[k], equal_nan=True), k
    assert port_job.read_month(dict(month, mesh_devices=2), 2019, 7).reader_obj.sat_data
    over = dict(month, device="cuda", mesh_devices=max(torch.cuda.device_count() + 1, 2))
    for call in (port_job.run_month, port_job.read_month):
        with pytest.raises(RuntimeError, match=r"check the mesh_devices control key"):
            call(over, 2019, 7)
    with pytest.raises(ValueError, match="TEMPO months read per-hour"):
        port_job.read_month(dict(ctrl, sensor="TEMPO"), 2019, 7)
    assert port_job.main(["2019"]) == 2


def test_every_shipped_control_file_is_read_unchanged():
    """The keys of run/control*.yml are the keys the port's runner reads."""
    for path in sorted((REPO / "run").glob("control_*.yml")) + [REPO / "run" / "control.yml"]:
        ctrl = port_job.load_control(path)
        if "sensor" not in ctrl:  # control_free.yml: the FREE grid's box
            assert set(ctrl) == {"lonll", "lonur", "latll", "latur", "gridsize"}
            continue
        kw = port_job.reader_kwargs(ctrl)
        assert kw["device"] is None and isinstance(kw["num_job"], int), path.name
        port_job.month_setup(ctrl)
        assert ctrl.get("oi_method", "scalar") in ("scalar", "full")


def test_job_without_a_card_raises_unless_the_cpu_is_named(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ctrl = _ctrl(tmp_path, troposphere_only=True)
    del ctrl["device"]
    _omi_no2(tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_job.run_month(ctrl, 2019, 7)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_campaign.run_campaign(ctrl)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oisatgmi().load_state(tmp_path / "absent.h5")
    from oisat_tpu_torch.examples import synthetic_month
    from oisat_tpu_torch.tools.readjust_OI import readjust

    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_month.main(["--granules", "1", "--out", str(tmp_path / "demo")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        readjust(tmp_path, tmp_path / "out")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_month.main(["--mesh", "2", "--granules", "1"])
    # --mesh 2 on the CPU: two logical shards, the mesh-less run's file
    for sub, mesh in (("mesh", "2"), ("single", "1")):
        assert synthetic_month.main(["--granules", "2", "--fused", "--mesh", mesh, "--device",
                                     "cpu", "--out", str(tmp_path / sub)]) == 0
    a, _ = read_diag_nc(tmp_path / "mesh" / "demo_201907.nc")
    b, _ = read_diag_nc(tmp_path / "single" / "demo_201907.nc")
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6 * np.nanmax(np.abs(b[k])),
                                   equal_nan=True, err_msg=k)


# ---- campaign ---------------------------------------------------------------------

def _campaign_ctrl(tmp_path, **over):
    ctrl = _ctrl(tmp_path, ctm_name="GMI", ctm_avg=True, troposphere_only=True,
                 fused_month=True, end_date="2019-08")  # 08 has no data
    ctrl.update(over)
    return ctrl


def test_run_campaign_sweeps_months_with_retry(tmp_path, monkeypatch, capsys):
    """A month with data produces its diag; a month whose read fails is
    retried once and then reported, without killing the campaign."""
    ctrl = _campaign_ctrl(tmp_path)
    _gmi(tmp_path)
    _omi_no2(tmp_path)
    monkeypatch.chdir(tmp_path)
    failed = port_campaign.run_campaign(ctrl, retries=1)
    assert failed == [(2019, 8)]
    assert (tmp_path / "diag" / "NO2_201907.nc").exists()
    assert not (tmp_path / "diag" / "NO2_201908.nc").exists()
    out = capsys.readouterr().out
    assert "month FAILED after retries" in out and '"month"' in out
    import yaml

    (tmp_path / "control.yml").write_text(yaml.safe_dump(dict(ctrl, end_date="2019-07")))
    assert port_campaign.main([str(tmp_path / "control.yml")]) == 0


def test_run_campaign_prefetch_mechanism(monkeypatch):
    """With prefetch, month k+1's read runs in the background thread during
    month k's tail and arrives as pre_read; prefetch=False and TEMPO keep
    every read inline."""
    ctrl = {"start_date": "2019-07", "end_date": "2019-09", "sensor": "OMI", "device": "cpu"}
    events = []

    def fake_read(c, y, m):
        events.append(("read", y, m, threading.current_thread() is not threading.main_thread()))
        return f"obj-{y}{m:02}"

    def fake_run(c, y, m, pre_read=None, prefetch_hook=None):
        events.append(("run", y, m, pre_read))
        if prefetch_hook is not None:
            prefetch_hook()

    monkeypatch.setattr(port_campaign, "read_month", fake_read)
    monkeypatch.setattr(port_campaign, "run_month", fake_run)
    assert port_campaign.run_campaign(dict(ctrl), prefetch=True) == []
    runs = [e for e in events if e[0] == "run"]
    assert [r[1:] for r in runs] == [
        (2019, 7, None), (2019, 8, "obj-201908"), (2019, 9, "obj-201909")]
    reads = [e for e in events if e[0] == "read"]
    assert len(reads) == 2 and all(bg for (_, _, _, bg) in reads)

    events.clear()
    assert port_campaign.run_campaign(dict(ctrl), prefetch=False) == []
    assert all(e[3] is None for e in events if e[0] == "run")
    assert not [e for e in events if e[0] == "read"]

    events.clear()
    tempo = dict(ctrl, sensor="TEMPO", campaign_prefetch=True)
    assert port_campaign.run_campaign(tempo) == []
    assert all(e[3] is None for e in events if e[0] == "run")


def test_run_campaign_prefetch_default_follows_core_count(monkeypatch):
    ctrl = {"start_date": "2019-07", "end_date": "2019-08", "sensor": "OMI", "device": "cpu"}
    reads = []
    monkeypatch.setattr(port_campaign, "read_month",
                        lambda c, y, m: reads.append((y, m)) or "obj")

    def fake_run(c, y, m, pre_read=None, prefetch_hook=None):
        if prefetch_hook is not None:
            prefetch_hook()

    monkeypatch.setattr(port_campaign, "run_month", fake_run)
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    assert port_campaign.run_campaign(dict(ctrl)) == []
    assert reads == []  # 1 core: no background read
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    assert port_campaign.run_campaign(dict(ctrl)) == []
    assert reads == [(2019, 8)]  # multi-core default: prefetch active


def test_month_read_in_the_prefetch_thread_gives_the_inline_months_result(tmp_path, monkeypatch):
    """Two months of one campaign, with and without the prefetch thread: the
    second month is read off the main thread while the first month's tail
    runs, and both months' diag files are bitwise those of the inline
    campaign."""
    ctrl = _campaign_ctrl(tmp_path, end_date="2019-08", fused_month=False, num_job=2)
    _gmi(tmp_path)
    write_gmi_pair(tmp_path / "ctm" / "MERRA2_GMI.tavg3_3d_met_Nv.20190810.nc4",
                   tmp_path / "ctm" / "MERRA2_GMI.tavg3_3d_tac_Nv.20190810.nc4", 10,
                   nlat=16, nlon=17)
    _omi_no2(tmp_path, days=(9, 10))
    for day in (9, 10):  # the same swaths, dated August
        src = tmp_path / "sat" / f"OMI-Aura_L2-OMNO2_2019m07{day:02}.nc"
        dst = tmp_path / "sat" / f"OMI-Aura_L2-OMNO2_2019m08{day:02}.nc"
        dst.write_bytes(src.read_bytes())
        with h5py.File(dst, "a") as f:
            f["GEOLOCATION_DATA/Time"][...] = (
                datetime.datetime(2019, 8, day) - datetime.datetime(1993, 1, 1)).total_seconds()
    with h5py.File(tmp_path / "ctm" / "MERRA2_GMI.tavg3_3d_met_Nv.20190810.nc4", "a") as f:
        f["time"].attrs["begin_date"] = np.int32(20190810)
    monkeypatch.chdir(tmp_path)
    threads = []
    real_read = port_job.read_month

    def spy(c, y, m):
        threads.append(threading.current_thread() is threading.main_thread())
        return real_read(c, y, m)

    monkeypatch.setattr(port_campaign, "read_month", spy)
    for sub, prefetch in (("pre", True), ("inline", False)):
        c = dict(ctrl, output_nc_dir=str(tmp_path / sub / "diag"),
                 output_pdf_dir=str(tmp_path / sub / "report"))
        assert port_campaign.run_campaign(c, prefetch=prefetch) == []
    assert threads == [False]  # one read, off the main thread
    for tag in ("NO2_201907", "NO2_201908"):
        a, ta, attrs_a = read_diag_nc(tmp_path / "pre" / "diag" / f"{tag}.nc", with_attrs=True)
        b, tb, attrs_b = read_diag_nc(tmp_path / "inline" / "diag" / f"{tag}.nc", with_attrs=True)
        assert ta == tb and attrs_a == attrs_b
        assert all(np.array_equal(a[k], b[k], equal_nan=True) for k in b), tag


# ---- checkpoints, outputs ------------------------------------------------------------

def _session(tmp_path, monkeypatch, **over):
    ctrl = _ctrl(tmp_path, ctm_name="GMI", ctm_avg=True, troposphere_only=True, **over)
    _gmi(tmp_path)
    _omi_no2(tmp_path, days=(9, 10, 11))
    (tmp_path / "sat" / "OMI-Aura_L2-OMNO2_2019m0712.nc").write_bytes(b"corrupt " * 40)
    monkeypatch.chdir(tmp_path)
    return ctrl, port_job.read_month(ctrl, 2019, 7)


def test_save_state_load_state_equals_the_uninterrupted_run(tmp_path, monkeypatch):
    ctrl, obj = _session(tmp_path, monkeypatch)
    assert [g is None for g in obj.reader_obj.sat_data] == [False, False, False, True]
    assert obj.gasname == "N"  # gasname = ctm_gas_name[0], as the twin sets it
    obj.recal_amf()
    before = list(obj.reader_obj.sat_data)
    obj.settle_device_granules()
    assert obj.reader_obj.sat_data == before
    obj.save_state(tmp_path / "ckpt.h5")
    obj.average("2019-07-01", "2019-08-01", gasname="NO2")
    obj.bias_correct("OMI", "NO2")
    obj.oi("OMI", error_ctm=50.0)

    resumed = oisatgmi()
    resumed.load_state(tmp_path / "ckpt.h5", ctm_data=obj.reader_obj.ctm_data, device="cpu")
    grans = resumed.reader_obj.sat_data
    assert grans[3] is None and torch.is_tensor(grans[0].vcd)
    assert torch.is_tensor(grans[0].ctm_vcd) and grans[0].quality_flag == []
    assert isinstance(grans[0].latitude_center, np.ndarray)
    resumed.average("2019-07-01", "2019-08-01", gasname="NO2")
    resumed.bias_correct("OMI", "NO2")
    resumed.oi("OMI", error_ctm=50.0)
    for name in ("sat_averaged_vcd", "sat_averaged_error", "ctm_averaged_vcd", "aux1", "aux2",
                 "ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI"):
        assert np.array_equal(getattr(resumed, name), getattr(obj, name), equal_nan=True), name
    assert resumed.oi_diagnostics == obj.oi_diagnostics and resumed.avg_time == obj.avg_time
    resumed.write_to_nc("resumed", str(tmp_path / "diag"))
    obj.write_to_nc("whole", str(tmp_path / "diag"))
    a, _ = read_diag_nc(tmp_path / "diag" / "resumed.nc")
    b, _ = read_diag_nc(tmp_path / "diag" / "whole.nc")
    assert all(np.array_equal(a[k], b[k], equal_nan=True) for k in b)
    # a session that already has a reader keeps its CTM
    obj.load_state(tmp_path / "ckpt.h5", device="cpu")
    assert obj.reader_obj.ctm_data and obj.reader_obj.sat_data[3] is None


def test_diag_fields_and_the_scaling_factor_rule(tmp_path, monkeypatch):
    from oisat_tpu_torch import _device

    ctrl, obj = _session(tmp_path, monkeypatch, fused_month=True)
    port_job._analyze(obj, ctrl, "OMI", "NO2", "2019-07-01", "2019-08-01", ("x", "y"))
    obj.ctm_averaged_vcd_corrected[0, :3] = (0.0, np.inf, np.nan)
    obj.ctm_averaged_vcd[1, 0] = 0.0
    _device.COPIES.update(h2d=0, d2h=0)
    fields = obj._diag_fields()
    assert _device.COPIES["d2h"] == 0  # the month's one pull brought every field
    assert list(fields) == ["sat_averaged_vcd", "ctm_averaged_vcd_prior",
                            "ctm_averaged_vcd_posterior", "sat_averaged_error", "ak_OI",
                            "error_OI", "scaling_factor", "lon", "lat", "aux1", "aux2"]
    shape = obj.reader_obj.ctm_data[0].latitude.shape
    assert all(isinstance(v, np.ndarray) and v.shape == shape for v in fields.values())
    sf = fields["scaling_factor"]
    assert np.isfinite(sf).all() and (sf[0, :3] == 1.0).all() and sf[1, 0] == 1.0
    ok = np.isfinite(obj.ctm_averaged_vcd_corrected / obj.ctm_averaged_vcd) & (sf != 1.0)
    assert ok.sum() > 50
    assert np.array_equal(sf[ok], (obj.ctm_averaged_vcd_corrected / obj.ctm_averaged_vcd)[ok])
    # fields that are tensors cost exactly one copy each
    for name in ("sat_averaged_vcd", "sat_averaged_error", "ctm_averaged_vcd", "aux1", "aux2",
                 "ctm_averaged_vcd_corrected", "ak_OI", "error_OI"):
        setattr(obj, name, torch.as_tensor(getattr(obj, name)))
    again = obj._diag_fields()
    assert _device.COPIES["d2h"] == 8
    assert all(np.array_equal(again[k], fields[k], equal_nan=True) for k in fields)
    obj.reporting("tensors", "NO2", str(tmp_path / "report"))
    assert (tmp_path / "report" / "OI_report_tensors.pdf").exists()


def test_reporting_plots_on_the_coarser_grid(tmp_path, monkeypatch):
    import oisat_tpu_torch.report as port_report

    seen = {}
    monkeypatch.setattr(port_report, "report",
                        lambda lon, lat, *a: seen.update(lon=lon, lat=lat, n=len(a)))
    z = np.ones((4, 5))
    obj = oisatgmi()
    for name in ("ctm_averaged_vcd", "ctm_averaged_vcd_corrected", "sat_averaged_vcd",
                 "sat_averaged_error", "increment_OI", "ak_OI", "error_OI", "aux1", "aux2"):
        setattr(obj, name, z)
    sat = SimpleNamespace(latitude_center=np.zeros((4, 5)), longitude_center=np.ones((4, 5)))
    # the twin's rule: the satellite grid when the CTM has fewer cells, else the CTM's
    for ctm_shape, want in (((8, 9), (8, 9)), ((2, 3), (4, 5))):
        ctm = SimpleNamespace(latitude=np.zeros(ctm_shape), longitude=np.ones(ctm_shape))
        obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=[None, sat])
        obj.reporting("tag", "NO2", str(tmp_path))
        assert seen["lat"].shape == seen["lon"].shape == want and seen["n"] == 12


# ---- readjust_OI and the example ------------------------------------------------------

def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kw", [dict(error_ctm=50.0),
                                dict(error_ctm=200.0, desroziers_iterations=3),
                                dict(error_ctm=200.0, desroziers_iterations=2,
                                     desroziers_bins=3)],
                         ids=["plain", "desroziers", "binned"])
def test_readjust_equals_the_twins(tmp_path, kw):
    """float64 fields from one diag file through both tools: float32 files,
    rtol 1e-6; the source file's attributes passed through; a stale scale
    map dropped or replaced."""
    from oisat_tpu.ncwriter import write_diag_nc
    from oisat_tpu_torch.tools.readjust_OI import main, readjust

    d = tmp_path / "diag"
    d.mkdir()
    fields = make_diag(d / "NO2_201907.nc", seed=3)
    fields["sat_averaged_vcd"][0, :2] = (-0.5, np.nan)
    fields["desroziers_sa_scale"] = np.full_like(fields["lat"], 7.0)
    fields["desroziers_so_scale"] = np.full_like(fields["lat"], 7.0)
    attrs = {"chi2": 1.25, "n": 384.0, "solver": "dense+direct_f64_dev"}
    write_diag_nc(d / "NO2_201907.nc", fields, "2019-07-15 12:00:00", global_attrs=attrs)
    got = readjust(d, tmp_path / "port", device="cpu", **kw)
    want = _jax_tool("readjust_OI").readjust(d, tmp_path / "jax", **kw)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    a, ta, attrs_a = read_diag_nc(got[0], with_attrs=True)
    b, tb, attrs_b = jax_read_diag_nc(want[0], with_attrs=True)
    assert ta == tb and attrs_a == attrs_b == attrs
    assert set(a) == set(b)
    assert ("desroziers_sa_scale" in a) == (kw.get("desroziers_bins", 1) > 1)
    for name in b:
        assert np.array_equal(np.isnan(a[name]), np.isnan(b[name])), name
        np.testing.assert_allclose(a[name], b[name], rtol=1e-6, atol=1e-7, equal_nan=True,
                                   err_msg=name)
    assert not np.allclose(a["ctm_averaged_vcd_posterior"], a["ctm_averaged_vcd_prior"],
                           equal_nan=True)
    argv = [str(d), str(tmp_path / "cli"), str(kw["error_ctm"]), "--device", "cpu",
            "--desroziers", str(kw.get("desroziers_iterations", 0)),
            "--desroziers-bins", str(kw.get("desroziers_bins", 1))]
    assert main(argv) == 0
    c, _ = read_diag_nc(tmp_path / "cli" / "NO2_201907.nc")
    assert all(np.array_equal(c[k], a[k], equal_nan=True) for k in a)


@pytest.mark.parametrize("flags", [[], ["--fused"], ["--fused", "--oi-method", "full"]],
                         ids=["staged", "fused", "fused_full"])
def test_example_runs_like_the_twin(tmp_path, monkeypatch, capsys, flags):
    """The same seeds through both examples (parity builders on the JAX
    side): the same diag variables at the job tolerance, the daily files and
    the PDF."""
    from oisat_tpu_torch.examples import synthetic_month

    out = tmp_path / "nested" / "port"
    assert synthetic_month.main(["--granules", "2", "--device", "cpu", "--out", str(out),
                                 *flags]) == 0
    port_factor = FACTOR.findall(capsys.readouterr().out)
    assert (out / "OI_report_NO2_201907_demo.pdf").exists()
    mats = sorted((out / "daily").glob("sat_data_NO2_*.mat"))
    assert len(mats) == 2
    import scipy.io as sio

    for m in mats:
        d = sio.loadmat(str(m))
        assert np.isfinite(d["vcd_ctm"]).any() and d["vcd_sat"].shape == d["vcd_ctm"].shape
    fields, tstr = read_diag_nc(out / "demo_201907.nc")
    assert tstr.startswith("2019-07") and np.isfinite(fields["scaling_factor"]).all()

    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    monkeypatch.setattr(sys, "argv", ["synthetic_month.py", "--granules", "2",
                                      "--out", str(tmp_path / "jax"), *flags])
    runpy.run_path(str(REPO / "examples" / "synthetic_month.py"), run_name="__main__")
    assert FACTOR.findall(capsys.readouterr().out) == port_factor
    want, _ = jax_read_diag_nc(tmp_path / "jax" / "demo_201907.nc")
    tol = 5e-4 if "full" in flags else 1e-5  # the float32 dense scan's tolerance
    for name, b in want.items():
        a = fields[name]
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * 0.1 * float(np.nanmax(np.abs(b))),
                                   equal_nan=True, err_msg=name)
