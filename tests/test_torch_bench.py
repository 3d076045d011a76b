"""The port's benchmark (``oisat_tpu_torch.bench``) against ``bench.py`` on the CPU.

``bench.py`` is loaded from the repository root with importlib (at top level
it imports only json, time, warnings and numpy).  Checked here:

* the inputs are bitwise bench.py's, NaN equal: ``make_fields``,
  ``_eta_pmid``, every field of ``_synthetic_orbit`` for two seeds, the four
  outputs of ``numpy_reference_oi`` and the three product-file writers;
* each row's computation equals the JAX package's on the same inputs at a
  small size, at the tolerance of the twin's own port test: the OI (the
  knee equal, rtol 1e-5 / atol 1e-6 in float32, tests/test_torch_oi.py),
  the curve (plain, rtol 1e-5 and the knee), ``oi_full_dense`` at n = 256
  (1e-4 of the field's largest magnitude, tests/test_torch_oi_full.py), both
  regrids of one small orbit (float32 bounds, tests/test_torch_regrid.py),
  ``oi_full_matfree`` on a 30 x 60 grid (1e-4, tests/test_torch_oi_full_
  matfree.py), a 3-orbit staged and fused month and one month of each of the
  year's four kinds (float32 bounds, tests/test_torch_regrid.py; the
  MOPITT / GOSAT / SSMIS months at tests/test_torch_sensors.py's float32
  month-step bound); the job months on the bench's files are in
  tests/test_torch_bench_files.py;
* every line a row prints parses as JSON with the five keys,
  ``detail.backend == "torch"`` and ``detail.device.platform == "cpu"``;
* ``python -m oisat_tpu_torch.bench`` with no card exits non-zero naming the
  missing device and prints no metric line.

The JAX regrid runs in its parity mode (``OISAT_PARITY=1``) against the
port's scipy builders, or with ``OISAT_F16_TRANSFER=0`` against the port's
native builder (the same plans, tests/test_torch_import.py); the JAX orbit
carries its affine pressure tables, the port's does not.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oisat_tpu import datamodel as jdm
from oisat_tpu.driver import oisatgmi as jax_oisatgmi
from oisat_tpu.obs_operators import amf_recal as jax_amf_recal
from oisat_tpu.ops import oi as jax_oi
from oisat_tpu.ops import oi_full as J
from oisat_tpu.regridder import regrid_granule as jax_regrid_granule
from oisat_tpu_torch import bench as B
from oisat_tpu_torch.convert import to_numpy
from oisat_tpu_torch.ops import oi as port_oi
from oisat_tpu_torch.ops import oi_full as T
from oisat_tpu_torch.ops.kernels import oi_scan
from tests.test_torch_oi import assert_parity

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DRIVER_FIELDS = B.DRIVER_FIELDS


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JB = _jax_bench()


def _lines(capsys, n=None):
    """The JSON lines printed since the last read; each with bench.py's five
    keys, the torch backend and the CPU."""
    out = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith('{"metric"')]
    lines = [json.loads(ln) for ln in out]
    for line in lines:
        assert set(line) == KEYS, line
        assert line["detail"]["backend"] == "torch"
        assert line["detail"]["device"] == {"platform": "cpu"}
        assert np.isfinite(line["value"]), line
    if n is not None:
        assert len(lines) == n
    return lines


def _bitwise(a, b, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), name


# ---- the inputs --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_make_fields_is_bitwise_the_twins(dtype):
    for got, want in zip(B.make_fields(64, 128, dtype=dtype), JB.make_fields(64, 128, dtype=dtype)):
        _bitwise(got, want)


def test_eta_pmid_is_bitwise_the_twins():
    got = B._eta_pmid(20, (16, 12), np.random.default_rng(3))
    _bitwise(got, JB._eta_pmid(20, (16, 12), np.random.default_rng(3)))


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_orbit_is_bitwise_the_twins(seed):
    got = B._synthetic_orbit(seed, ny=64, nx=20)
    want = JB._synthetic_orbit(seed, ny=64, nx=20)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            _bitwise(a, b, f.name)
        else:
            assert a == b, f.name


def test_numpy_reference_oi_is_bitwise_the_twins():
    fields = B.make_fields(48, 96, dtype=np.float64)
    got = B.numpy_reference_oi(*fields)
    want = JB.numpy_reference_oi(*fields)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        _bitwise(a, b)


@pytest.mark.parametrize("kind", ["gmi", "tempo", "tropomi"])
def test_product_files_are_bitwise_the_twins(tmp_path, kind):
    def write(mod, folder):
        folder.mkdir()
        if kind == "gmi":
            mod._write_bench_gmi_pair(folder / "met.nc4", folder / "gas.nc4", 201907, 15)
        elif kind == "tempo":
            mod._write_bench_tempo(folder / "f.nc", 13, seed=105)
        else:
            mod._write_bench_tropomi(folder / "f.nc", 3, seed=2, month=8)
        return sorted(folder.iterdir())

    for p, j in zip(write(B, tmp_path / "port"), write(JB, tmp_path / "jax")):
        with h5py.File(p, "r") as fp, h5py.File(j, "r") as fj:
            names = []
            fj.visit(names.append)
            got = []
            fp.visit(got.append)
            assert got == names
            for name in names:
                assert dict(fp[name].attrs).keys() == dict(fj[name].attrs).keys(), name
                for k, v in fj[name].attrs.items():
                    _bitwise(fp[name].attrs[k], v, f"{name}@{k}")
                if isinstance(fj[name], h5py.Dataset):
                    _bitwise(fp[name][()], fj[name][()], name)


# ---- each row's computation against the JAX package ------------------------------------

def test_headline_oi_matches_jax(capsys):
    fields = B.make_fields(64, 128)
    got = port_oi.oi(*(torch.as_tensor(f) for f in fields))
    want = jax_oi.oi(*(jnp.asarray(f) for f in fields))
    assert int(got.reg_index) == int(want.reg_index)
    for name in ("xb", "averaging_kernel", "increment", "error"):
        assert_parity(getattr(got, name).numpy(), np.asarray(getattr(want, name)), np.float32,
                      name)
    line = B.bench_oi(H=64, W=128, reps=1, repeats=2, device="cpu")
    assert _lines(capsys, 1)[0]["metric"] == line["metric"] == "oi_analysis_throughput"
    d = line["detail"]
    assert d["knee"] == int(want.reg_index) and d["repeats"] == 2
    assert d["max_rel_diff_vs_f64_reference"] <= B.OI_RTOL
    assert d["roofline"] == B.NOT_MEASURED and d["timer"] == "host_clock"


def test_curve_phase_matches_jax(capsys):
    n = 4096
    rng = np.random.default_rng(0)
    sa = np.abs(rng.normal(2, 1, n)).astype(np.float32)
    so = np.abs(rng.normal(1, 0.5, n)).astype(np.float32)
    regs = port_oi.regularization_grid()
    u, _ = port_oi.curve_inputs(torch.as_tensor(sa), torch.as_tensor(so))
    got = oi_scan.ak_curve_sums_plain(u, torch.as_tensor(regs, dtype=torch.float32)).numpy() / n
    want = np.asarray(jax_oi.ak_curve(jnp.asarray(sa), jnp.asarray(so),
                                      jnp.asarray(regs, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    from oisat_tpu.ops.knee import kneedle_index_np as jax_knee

    line = B.bench_curve_phase(n=n, reps=1, repeats=2, device="cpu")
    _lines(capsys, 1)
    assert line["metric"] == "oi_curve_phase_kernel"
    assert line["detail"]["knee"] == jax_knee(regs, want)
    assert line["detail"]["kernel_launches_per_call"] == 0  # the CPU: the plain version


def test_kalman_dense_solve_matches_jax(capsys):
    inputs = B.kalman_inputs(256)
    got = T.oi_full_dense(*(torch.as_tensor(a, dtype=torch.float32) for a in inputs), 300.0)
    want = J.oi_full_dense(*(jnp.asarray(a, jnp.float32) for a in inputs), 300.0)
    for name, g, w in zip(("xb", "ak", "increment", "err"), got, want):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    line = B.bench_kalman(256, reps=1, repeats=2, device="cpu")
    _lines(capsys, 1)
    assert line["metric"] == "kalman_full_solve" and line["detail"]["n_cells"] == 256


@pytest.mark.parametrize("fast", [False, True])
def test_regrid_of_one_orbit_matches_jax(monkeypatch, fast):
    lon2, lat2 = B._month_grid()
    if fast:
        monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    else:
        monkeypatch.setenv("OISAT_PARITY", "1")
    want = jax_regrid_granule(1, 0.25, JB._synthetic_orbit(3, ny=64, nx=20), lon2, lat2,
                              flag_thresh=0.0, fast_swath=fast, device=False)
    got = B.regrid_granule(1, 0.25, B._synthetic_orbit(3, ny=64, nx=20), lon2, lat2, "cpu",
                           flag_thresh=0.0, fast_swath=fast)
    assert int(torch.isfinite(got.vcd).sum()) > 100
    for name in ("vcd", "amf", "tropopause", "uncertainty", "pressure_mid", "scattering_weights"):
        assert_parity(getattr(got, name).numpy(), np.asarray(getattr(want, name)), np.float32,
                      name)


def test_regrid_rows_print_their_lines(capsys):
    lines = B.regrid_rows(orbits=2, repeats=2, ny=64, nx=20, device="cpu")
    assert [ln["metric"] for ln in _lines(capsys, 3)] == [
        "regrid_orbit_parity", "regrid_orbit_fast", "regrid_fast_speedup"]
    assert lines[0]["detail"]["repeats"] == lines[1]["detail"]["repeats"] == 2
    assert len(lines[2]["detail"]["pair_ratios"]) == 2
    piped = B.bench_regrid_pipelined(orbits=2, repeats=1, ny=64, nx=20, device="cpu")
    assert [ln["metric"] for ln in _lines(capsys, 1)] == ["regrid_orbit_fast_pipelined"]
    # the twin's timed window: each orbit is made inside it
    for line in (*lines[:2], piped):
        assert line["detail"]["orbit_synthesis"] == B.ORBIT_SYNTHESIS


def test_matfree_matches_jax(capsys):
    args = B.matfree_inputs(1800, rows=30)
    got = B.oi_full_matfree(*args, block=2048, device="cpu")
    want = J.oi_full_matfree(*args, block=2048)
    assert got[4]["precond"] == want[4]["precond"] == "jacobi"
    for name, g, w in zip(("xb", "ak", "increment", "err"), got[:4], want[:4]):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.nanmax(np.abs(w)),
                                   err_msg=name)
    line = B.bench_matfree(512, rows=16, block=512, device="cpu")
    _lines(capsys, 1)
    d = line["detail"]
    assert d["cells"] == 512 and d["converged"] and d["cg_resid"] <= B.CG_WARN_RESID
    assert d["size"] == "cut: 512 cells of bench.py's 64800"
    assert d["stat_norm"] > 0 and d["precond"] == "jacobi"


def _jax_ctm(ctm):
    return SimpleNamespace(**{f.name: getattr(ctm, f.name) for f in dataclasses.fields(ctm)})


def _assert_driver_fields(port, jax, what="", rtol=None):
    """The nine driver fields at the float32 bound (tests.test_torch_oi.TOL),
    or within ``rtol`` plus a tenth of it of the field's largest magnitude;
    the same innovation count."""
    for name in DRIVER_FIELDS:
        got, want = getattr(port, name), np.asarray(getattr(jax, name))
        if rtol is None:
            assert_parity(got, want, np.float32, f"{what} {name}")
            continue
        assert np.array_equal(np.isnan(got), np.isnan(want)), name
        if np.isfinite(want).any():
            np.testing.assert_allclose(got, want, rtol=rtol, equal_nan=True, err_msg=name,
                                       atol=0.1 * rtol * np.nanmax(np.abs(want)))
    assert port.oi_diagnostics["n"] == jax.oi_diagnostics["n"]


@pytest.mark.parametrize("fused", [False, True])
def test_three_orbit_month_matches_jax(monkeypatch, capsys, fused):
    """bench.py ``bench_month``'s run on 3 half orbits (the native builder on
    both sides), staged or fused, against the JAX package's."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    port, (total, regrid_s, op_s), n = B.month_session(3, fused, device="cpu")
    assert n == 3 and total >= regrid_s + op_s > 0
    lon2, lat2 = B._month_grid()
    grans = []
    for s in range(3):
        g = jax_regrid_granule(1, 0.25, JB._synthetic_orbit(s, ny=822, nx=60), lon2, lat2,
                               flag_thresh=0.0, device=False)
        g.time = B.datetime.datetime(2019, 7, 1 + s, 12)
        grans.append(g)
    ctm = _jax_ctm(B._month_ctm(lon2, lat2, rng=np.random.default_rng(0)))
    jobj = jax_oisatgmi()
    jobj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    if fused:
        jobj.analyze_month_fused("OMI", "NO2", *B.MONTH)
    else:
        jax_amf_recal([ctm], grans)
        jobj.average(*B.MONTH)
        jobj.bias_correct("OMI", "NO2")
        jobj.oi("OMI")
    _assert_driver_fields(port, jobj, "fused" if fused else "staged")
    line = B.bench_month(3, fused=fused, repeats=1, device="cpu")
    _lines(capsys, 1)
    want = "synthetic_month_fused" if fused else "synthetic_month_steady"
    assert line["metric"] == want and "fused_vs_staged" in line["detail"]


def test_full_month_row_names_its_branch(monkeypatch, capsys):
    """The full-covariance month on a 1 deg grid (the bench's 0.25 deg grid
    runs the matrix-free branch, minutes on the CPU): the dense branch, its
    cells, and repeats bitwise the cold run."""
    lon, lat = np.meshgrid(np.arange(-20.0, 10.0, 1.0), np.arange(20.0, 60.0, 1.0))
    monkeypatch.setattr(B, "_month_grid", lambda: (lon, lat))
    line = B.bench_month(2, fused=True, oi_method="full", repeats=1, device="cpu")
    _lines(capsys, 1)
    d = line["detail"]
    assert line["metric"] == "synthetic_month_fused_oifull"
    assert d["branch"] == "dense" and 0 < d["oi_cells"] <= lon.size


@pytest.mark.parametrize("sensor", ["OMI", "MOPITT", "GOSAT", "SSMIS"])
def test_one_year_month_matches_jax(monkeypatch, sensor):
    """One month of ``bench_year``'s kind through both fused drivers on the
    same granules (OMI: each package regrids bench.py's orbits).  The float32
    MOPITT / GOSAT / SSMIS months at rtol 2e-4 / atol 2e-5 of the largest
    magnitude (tests/test_torch_sensors.py's float32 month-step bound: their
    level sums cancel)."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    gas = dict(B.YEAR_PLAN)[sensor]
    lon2, lat2 = B._month_grid()
    rng = np.random.default_rng(0)
    pm3 = B._eta_pmid(20, lat2.shape, rng)
    ctm = B._month_ctm(lon2, lat2, month=3, rng=rng, pmid=pm3)
    grans = B.year_granules(sensor, 3, orbits=2, device="cpu")
    if sensor == "OMI":
        jgrans = []
        for s in range(2):
            g = jax_regrid_granule(1, 0.25, JB._synthetic_orbit(s + 300, ny=822, nx=60),
                                   lon2, lat2, flag_thresh=0.0, device=False)
            g.time = B.datetime.datetime(2019, 3, 1 + s, 12)
            jgrans.append(g)
    else:
        cls = getattr(jdm, type(grans[0]).__name__)
        jgrans = [cls(**{f.name: to_numpy(getattr(g, f.name))
                         for f in dataclasses.fields(g)}) for g in grans]
    assert len(grans) == len(jgrans) == (2 if sensor == "OMI" else 28)
    port = B.oisatgmi()
    port.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    port.analyze_month_fused(sensor, gas, "2019-03-01", "2019-04-01")
    jobj = jax_oisatgmi()
    jobj.reader_obj = SimpleNamespace(ctm_data=[_jax_ctm(ctm)], sat_data=jgrans)
    jobj.analyze_month_fused(sensor, gas, "2019-03-01", "2019-04-01")
    _assert_driver_fields(port, jobj, sensor, rtol=None if sensor == "OMI" else 2e-4)
    B._check_analysed(port, sensor, sensor)


def test_year_row_prints_its_line(capsys):
    line = B.bench_year(orbits=2, months=1, device="cpu")
    _lines(capsys, 1)
    d = line["detail"]
    assert line["metric"] == "full_year_all_sensor"
    assert set(d["median_month_s_per_kind"]) == {"OMI", "MOPITT", "GOSAT", "SSMIS"}


def test_bandwidth_row_checks_the_kalman_update(capsys):
    line = B.bench_oi_bandwidth(48, 64, reps=1, repeats=2, device="cpu")
    _lines(capsys, 1)
    assert line["detail"]["cells"] == 48 * 64 and line["detail"]["roofline"] == B.NOT_MEASURED


# ---- the command line and the packages the file rows need -----------------------------------

def test_bench_without_a_card_exits_naming_the_device():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "oisat_tpu_torch.bench"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "cuda" in proc.stderr
    assert '"metric"' not in proc.stdout
