"""The port's ExtData / emission tools (oisat_tpu_torch.tools.convert2EXT,
createOHfields, create_ind_CO_emiss, merge_soil_CCMI_NEI) against the JAX
package's ``tools/*.py``, on the CPU.

Each case writes the same seeded input files (tests/test_tools.py's
generators and shapes) and runs the twin, loaded from ``tools/<name>.py``
as tests/test_tools.py loads it, and the port's tool on them.  The written
files must be the twin's: the same file names, and in each file the same
datasets in the same order with the same dtype, shape, dimension scales and
attributes, values bitwise equal with NaN equal, and the same global
attributes except the creation timestamp both write (exact everywhere: the
two run the same numpy on the same inputs).  One case per tool runs the
port's CLI, ``python -m oisat_tpu_torch.tools.<name>``, in a subprocess.
"""

import datetime
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
from scipy.io import loadmat, savemat

from oisat_tpu.ncwriter import write_diag_nc, write_nc
from oisat_tpu_torch.tools import convert2EXT, create_ind_CO_emiss, createOHfields
from oisat_tpu_torch.tools import merge_soil_CCMI_NEI
from tests.test_tools import make_diag

REPO = Path(__file__).resolve().parent.parent
TIMESTAMPS = ("creation_time",)  # the wall clock at writing: differs by nature
SCALE_REFS = ("DIMENSION_LIST", "REFERENCE_LIST")  # object references: compared as names


def _twin(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain(v):
    return v.tolist() if isinstance(v, np.ndarray) else (v.item() if isinstance(v, np.generic) else v)


def _contents(path):
    """(datasets in file order: name, dtype, shape, scales, attrs, values),
    global attributes without the timestamps."""
    out = []
    with h5py.File(path, "r") as f:
        for name, ds in f.items():
            scales = [[s.name for s in d.values()] for d in ds.dims]
            attrs = {k: (type(v).__name__, _plain(v)) for k, v in ds.attrs.items()
                     if k not in SCALE_REFS}
            out.append((name, str(ds.dtype), ds.shape, scales, attrs, np.asarray(ds)))
        gattrs = {k: (type(v).__name__, _plain(v)) for k, v in f.attrs.items()
                  if k not in TIMESTAMPS}
        stamps = sorted(k for k in f.attrs if k in TIMESTAMPS)
    return out, gattrs, stamps


def assert_same_files(got_dir, want_dir, expect_n=None):
    got_names = sorted(os.listdir(got_dir))
    assert got_names == sorted(os.listdir(want_dir))
    assert got_names and (expect_n is None or len(got_names) == expect_n)
    for fname in got_names:
        got, got_g, got_s = _contents(Path(got_dir) / fname)
        want, want_g, want_s = _contents(Path(want_dir) / fname)
        assert [d[:5] for d in got] == [d[:5] for d in want], fname
        for g, w in zip(got, want):
            assert np.array_equal(g[5], w[5], equal_nan=g[5].dtype.kind == "f"), (fname, g[0])
        assert got_g == want_g and got_s == want_s == list(TIMESTAMPS), fname


# ---- inputs (tests/test_tools.py's shapes) ------------------------------------

def diag_folder(root: Path, seed: int = 0) -> Path:
    d = root / "diag"
    d.mkdir(parents=True)
    fields = make_diag(d / "HCHO_201907.nc", seed=seed)
    fields["scaling_factor"] = np.random.default_rng(seed + 1).uniform(0.5, 2.0, (16, 24))
    fields["scaling_factor"][3, 4] = np.nan
    write_diag_nc(d / "HCHO_201908.nc", fields, "2019-08-15 12:00:00")
    return d


def merra2_oh(root: Path, year: int, seed: int = 0) -> Path:
    rng = np.random.default_rng(seed)
    L, H, W = 4, 6, 8
    grid = {"lev": np.arange(1.0, L + 1), "lat": np.linspace(-80, 80, H),
            "lon": np.linspace(-170, 170, W)}
    for mm in range(1, 13):
        mdir = root / "merra2" / f"Y{year}" / f"M{mm:02}"
        mdir.mkdir(parents=True)
        write_nc(mdir / f"MERRA2_GMI.tavg24_3d_dac_Nv.monthly.{year}{mm:02}.nc4", dims=grid,
                 variables={"OH": (("lev", "lat", "lon"),
                                   np.abs(rng.normal(1e-12, 2e-13, (L, H, W))), {})})
        write_nc(mdir / f"MERRA2_GMI.tavg3_3d_met_Nv.monthly.{year}{mm:02}.nc4", dims=grid,
                 variables={"PL": (("lev", "lat", "lon"), rng.uniform(2e4, 1e5, (L, H, W)), {}),
                            "T": (("lev", "lat", "lon"), rng.uniform(200, 300, (L, H, W)), {})})
    return root / "merra2"


def merra2_co(root: Path, year: int, mm: int, with_sf: bool, seed: int = 7):
    """tests/test_tools.py:test_create_ind_co_emiss's month; ``with_sf``
    writes the OMI-HCHO scaling factors (else the climatology is None)."""
    mod = create_ind_CO_emiss
    rng = np.random.default_rng(seed)
    L, H, W = 3, 4, 5
    lat, lon, lev = np.linspace(30, 33, H), np.linspace(-5, -1, W), np.arange(1.0, L + 1)
    mdir = root / "merra2" / f"Y{year}" / f"M{mm:02}"
    mdir.mkdir(parents=True)

    def wnc(path, var3d):
        write_nc(str(path), dims={"lev": lev, "lat": lat, "lon": lon},
                 variables={"lat": (("lat",), None, {}), "lon": (("lon",), None, {}),
                            "lev": (("lev",), None, {}),
                            **{k: (("lev", "lat", "lon"), v, {}) for k, v in var3d.items()}})

    for group, reacts in mod.REACTIONS.items():
        if group != "bio":
            wnc(mdir / f"MERRA2_GMI.tavg24_3d_{group}_Nv.monthly.{year}{mm:02}.nc4",
                {r: np.abs(rng.normal(1e-9, 2e-10, (L, H, W))) for r in reacts})
    write_nc(str(mdir / f"MERRA2_GMI.tavg24_2d_dad_Nx.monthly.{year}{mm:02}.nc4"),
             dims={"lat": lat, "lon": lon},
             variables={r: (("lat", "lon"), np.abs(rng.normal(1e-10, 2e-11, (H, W))), {})
                        for r in mod.REACTIONS["bio"]})
    wnc(mdir / f"MERRA2_GMI.tavg3_3d_met_Nv.monthly.{year}{mm:02}.nc4",
        {"H": np.sort(rng.uniform(100, 5e4, (L, H, W)), axis=0)})
    write_nc(str(mdir / f"MERRA2_GMI.tavg3_3d_mst_Ne.monthly.{year}{mm:02}.nc4"),
             dims={"lev": np.arange(1.0, L + 2), "lat": lat, "lon": lon},
             variables={"ZLE": (("lev", "lat", "lon"),
                                np.sort(rng.uniform(100, 6e4, (L + 1, H, W)), axis=0), {})})
    sf_dir = root / "sf"
    sf_dir.mkdir()
    if with_sf:
        for yr in (2010, 2011):
            sf = np.abs(rng.normal(1.2, 0.1, (H, W)))
            if yr == 2010:
                sf[0, 1] = np.nan  # nanmean over the years keeps 2011's value
            write_nc(str(sf_dir / f"HCHO_{yr}{mm:02}.nc"), dims={"lat": lat, "lon": lon},
                     variables={"SF": (("lat", "lon"), sf, {})})
    return root / "merra2", sf_dir


def emission_inputs(root: Path, year: int, month: int, emis: str, nei: str | None = None,
                    seed: int = 0) -> dict:
    """tests/test_tools.py:test_merge_soil_ccmi_nei's inputs with seeded
    fields: ``NO`` has the OS file, ship and soil channels; another species
    has ``_ff`` only (its ``_bf`` absent: the zeroing branch).  ``nei``:
    the matching NEI-2016 species (default ``emis``)."""
    nei = nei or emis
    rng = np.random.default_rng(seed)
    lat1 = np.array([0.0, 1.0, 2.0, 3.0])
    lon1 = np.array([0.0, 1.0, 2.0, 3.0, 4.0])
    shape = (lat1.size, lon1.size)

    def grid_nc(path, variables, lat=lat1, lon=lon1, extra_dims=None):
        dims = {"lat": lat, "lon": lon}
        dims.update(extra_dims or {})
        write_nc(str(path), dims=dims, variables={"lat": (("lat",), None, {}),
                                                  "lon": (("lon",), None, {}), **variables})

    for key in ("ccmi", "ccmi_os", "soil", "nei", "scales"):
        (root / key).mkdir(parents=True)
    month12 = lambda: rng.uniform(0.5, 5.0, (12,) + shape)  # noqa: E731
    if emis == "NO":
        grid_nc(root / "ccmi_os" / f"CCMI_emis01_OS_NO_{year}_t12.nc4",
                {"NO_ff": (("t", "lat", "lon"), month12(), {}),
                 "NO_bf": (("t", "lat", "lon"), month12(), {})}, extra_dims={"t": 12})
        grid_nc(root / "ccmi" / f"CCMI_emis01_NO_shp_{year}_t12.nc4",
                {"NO_shp": (("t", "lat", "lon"), month12(), {})}, extra_dims={"t": 12})
        sdir = root / "soil" / f"soilnox_{year}" / f"{month:02d}"
        sdir.mkdir(parents=True)
        for day in range(1, 32):
            grid_nc(sdir / f"soilnox_025.{year}{month:02d}{day:02d}.nc",
                    {"SOIL_NOx": (("t", "lat", "lon"), rng.uniform(0, 1, (24,) + shape), {})},
                    extra_dims={"t": 24})
        nei_vars = {"NO": (("lat", "lon"), rng.uniform(5, 9, (3, 5)), {}),
                    "NO2": (("lat", "lon"), rng.uniform(0.5, 2, (3, 5)), {})}
    else:
        ff = month12()
        ff[:, 2, 3] = 0.0  # zeros backfilled from the raw inventory
        grid_nc(root / "ccmi" / f"CCMI_emis01_{emis}_{year}_t12.nc4",
                {f"{emis}_ff": (("t", "lat", "lon"), ff, {})}, extra_dims={"t": 12})
        nei_vars = {nei: (("lat", "lon"), rng.uniform(5, 9, (3, 5)), {})}
    nlat, nlon = np.array([0.0, 0.5, 1.0]), np.array([0.0, 0.5, 1.0, 1.5, 2.0])
    grid_nc(root / "nei" / f"2016fh_16j_merge_0pt1degree_month_{month:02d}.ncf", nei_vars,
            lat=nlat, lon=nlon)
    glon, glat = np.meshgrid(nlon, nlat)
    savemat(str(root / "scales" / f"Scales_2016{month:02d}.mat"),
            {f"{nei}_weekday": rng.uniform(0.5, 2, (24, 3, 5)),
             f"{nei}_weekend": rng.uniform(2, 4, (24, 3, 5))})
    write_nc(str(root / "scales" / "GRIDCRO2D_20190201.nc4"),
             dims={"y": np.arange(3.0), "x": np.arange(5.0)},
             variables={"LON": (("y", "x"), glon, {}), "LAT": (("y", "x"), glat, {})})
    return {k: str(root / k) for k in ("ccmi", "ccmi_os", "soil", "nei", "scales")}


# ---- the port's tools against the twins -----------------------------------------

@pytest.mark.parametrize("fake_years", [range(2003, 2005), []])
def test_convert2ext_files_are_the_twins(tmp_path, fake_years):
    d = diag_folder(tmp_path)
    _twin("convert2EXT").convert(d, tmp_path / "jax", fake_years=fake_years)
    convert2EXT.convert(d, tmp_path / "port", fake_years=fake_years)
    assert_same_files(tmp_path / "port", tmp_path / "jax", 2 + 12 * len(fake_years))
    with h5py.File(tmp_path / "port" / "HCHO_201908.nc") as f:
        assert np.isnan(f["SF"][0, 3, 4]) and f["SF"].shape == (1, 16, 24)


def test_convert2ext_of_an_empty_folder_writes_nothing(tmp_path):
    (tmp_path / "diag").mkdir()
    assert convert2EXT.convert(tmp_path / "diag", tmp_path / "port") is None
    assert _twin("convert2EXT").convert(tmp_path / "diag", tmp_path / "jax") is None
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") == []


def test_create_oh_fields_files_are_the_twins(tmp_path):
    merra2 = merra2_oh(tmp_path, 2005)
    want = _twin("createOHfields").create(tmp_path / "jax", str(merra2), 2005)
    got = createOHfields.create(tmp_path / "port", str(merra2), 2005)
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    assert_same_files(tmp_path / "port", tmp_path / "jax", 12)


@pytest.mark.parametrize("with_sf", [True, False])
def test_create_ind_co_emiss_files_are_the_twins(tmp_path, with_sf):
    merra2, sf_dir = merra2_co(tmp_path, 2019, 7, with_sf)
    twin = _twin("create_ind_CO_emiss")
    for name in ("REACTIONS", "FACTORS", "SF_REACTIONS"):
        assert getattr(create_ind_CO_emiss, name) == getattr(twin, name), name
    clim = create_ind_CO_emiss.monthly_sf_climatology(sf_dir, 7)
    want_clim = twin.monthly_sf_climatology(sf_dir, 7)
    assert (clim is None) == (want_clim is None) == (not with_sf)
    if with_sf:
        assert np.array_equal(clim, want_clim, equal_nan=True)
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    want = twin.build_month(tmp_path / "jax", merra2, sf_dir, 2019, 7)
    got = create_ind_CO_emiss.build_month(tmp_path / "port", merra2, sf_dir, 2019, 7)
    assert Path(got).name == Path(want).name
    assert_same_files(tmp_path / "port", tmp_path / "jax", 1)


@pytest.mark.parametrize("emis,nei,day", [("NO", "NO", datetime.date(2019, 7, 10)),
                                          ("NO", "NO", datetime.date(2019, 7, 13)),
                                          ("CO", "CO", datetime.date(2019, 7, 14))])
def test_merge_soil_ccmi_nei_files_are_the_twins(tmp_path, emis, nei, day):
    """A weekday and a weekend NO day (soil, ship, both channels) and a
    weekend CO day (no ``_bf`` channel, zeros backfilled)."""
    paths = emission_inputs(tmp_path / "in", day.year, day.month, emis, nei)
    twin = _twin("merge_soil_CCMI_NEI")
    assert merge_soil_CCMI_NEI.EMISSION_NAMES_GMI == twin.EMISSION_NAMES_GMI
    assert merge_soil_CCMI_NEI.CORRS_NEI_EMIS == twin.CORRS_NEI_EMIS
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    want = twin.merger(paths, emis, nei, day, str(tmp_path / "jax"))
    got = merge_soil_CCMI_NEI.merger(paths, emis, nei, day, str(tmp_path / "port"))
    assert Path(got).name == Path(want).name
    assert_same_files(tmp_path / "port", tmp_path / "jax", 1)


def test_nearest_map_and_inside_are_the_twins():
    twin = _twin("merge_soil_CCMI_NEI")
    rng = np.random.default_rng(4)
    slon, slat = np.meshgrid(np.linspace(-3, 3, 7), np.linspace(10, 14, 5))
    vals = rng.normal(0, 1, slon.shape)
    tlon, tlat = np.meshgrid(np.linspace(-4, 4, 17), np.linspace(9, 15, 13))
    got = merge_soil_CCMI_NEI._nearest_map(slon, slat, vals, tlon, tlat)
    assert np.array_equal(got, twin._nearest_map(slon, slat, vals, tlon, tlat))
    assert np.array_equal(merge_soil_CCMI_NEI._inside(slon, slat, tlon, tlat),
                          twin._inside(slon, slat, tlon, tlat))


# ---- the port's CLI, one case per tool ----------------------------------------------

def _cli(module: str, *args, cwd=None):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", f"oisat_tpu_torch.tools.{module}", *map(str, args)],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_convert2ext_cli(tmp_path):
    d = diag_folder(tmp_path, seed=2)
    out = _cli("convert2EXT", d, tmp_path / "port", "--no-fake")
    assert out.count("Now processing") == 2
    _twin("convert2EXT").convert(d, tmp_path / "jax", fake_years=[])
    assert_same_files(tmp_path / "port", tmp_path / "jax", 2)


def test_create_oh_fields_cli(tmp_path):
    merra2 = merra2_oh(tmp_path, 2007, seed=3)
    _cli("createOHfields", tmp_path / "port", "--merra2", merra2, "--year", 2007)
    _twin("createOHfields").create(tmp_path / "jax", str(merra2), 2007)
    assert_same_files(tmp_path / "port", tmp_path / "jax", 12)


def test_create_ind_co_emiss_cli(tmp_path):
    merra2, sf_dir = merra2_co(tmp_path, 2019, 7, with_sf=True)
    for mm in range(1, 13):  # the CLI runs every month of the year
        if mm != 7:
            src, dst = merra2 / "Y2019" / "M07", merra2 / "Y2019" / f"M{mm:02}"
            dst.mkdir()
            for f in src.iterdir():
                (dst / f.name.replace("201907", f"2019{mm:02}")).write_bytes(f.read_bytes())
    out = _cli("create_ind_CO_emiss", tmp_path / "port", "--sf-dir", sf_dir, "--merra2", merra2,
               "--start-year", 2019, "--end-year", 2019)
    assert out.count("Now processing") == 12
    twin = _twin("create_ind_CO_emiss")
    (tmp_path / "jax").mkdir()
    for mm in range(1, 13):
        twin.build_month(tmp_path / "jax", merra2, sf_dir, 2019, mm)
    assert_same_files(tmp_path / "port", tmp_path / "jax", 12)


def test_merge_soil_ccmi_nei_cli(tmp_path):
    """Two days of every GMI species through the CLI's thread pool, against
    the twin's ``merger`` on each (species, day)."""
    twin = _twin("merge_soil_CCMI_NEI")
    root = tmp_path / "in"
    paths = emission_inputs(root, 2019, 7, "NO")
    for i, (emis, nei) in enumerate(zip(twin.EMISSION_NAMES_GMI, twin.CORRS_NEI_EMIS)):
        if emis == "NO":
            continue
        other = emission_inputs(tmp_path / f"in_{emis}", 2019, 7, emis, nei, seed=i + 1)
        for key in ("ccmi", "nei"):
            for f in Path(other[key]).iterdir():
                dst = Path(paths[key]) / f.name
                if key == "nei":  # one NEI file holds every species
                    with h5py.File(f) as src, h5py.File(dst, "a") as out:
                        out[nei] = src[nei][()]
                else:
                    dst.write_bytes(f.read_bytes())
        scales = Path(paths["scales"]) / "Scales_201607.mat"
        merged = {k: v for k, v in loadmat(str(scales)).items() if not k.startswith("__")}
        merged.update({k: v for k, v in loadmat(str(Path(other["scales"]) / "Scales_201607.mat")).items()
                       if not k.startswith("__")})
        savemat(str(scales), merged)
    args = [f"--{k.replace('_', '-')}" for k in paths]
    argv = [a for pair in zip(args, paths.values()) for a in pair]
    (tmp_path / "port").mkdir()
    _cli("merge_soil_CCMI_NEI", *argv, "--start", "2019-07-12", "--end", "2019-07-14",
         "--out", tmp_path / "port", "--jobs", 3)
    (tmp_path / "jax").mkdir()
    for day in (datetime.date(2019, 7, 12), datetime.date(2019, 7, 13)):
        for emis, nei in zip(twin.EMISSION_NAMES_GMI, twin.CORRS_NEI_EMIS):
            twin.merger(paths, emis, nei, day, str(tmp_path / "jax"))
    assert_same_files(tmp_path / "port", tmp_path / "jax", 2 * len(twin.EMISSION_NAMES_GMI))
