"""The port runs where jax, h5py, yaml and matplotlib are absent, and it
imports nothing of the JAX package: every slice module (and chip_smoke.py)
imports with those and ``oisat_tpu`` blocked in ``sys.modules``, and a CPU
regrid through the port's native plan builder (whose import is lazy), a
MOPITT-like staged month with a Desroziers pass and its daily files, the
job runner's dispatch with its diag fields, and a full OI above a lowered
dense limit (the SLQ knee and the matrix-free solve) and a month step over a
2 x 2 mesh of CPU shards run so blocked; a call that needs
one of the absent packages raises ImportError naming it.  The port's copies of the JAX package's host plan builders
give the JAX package's plans."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

SLICE_MODULES = [
    "oisat_tpu_torch",
    "oisat_tpu_torch._device",
    "oisat_tpu_torch.ops",
    "oisat_tpu_torch.ops.kernels",
    "oisat_tpu_torch.ops.kernels._build",
    "oisat_tpu_torch.ops.kernels.oi_scan",
    "oisat_tpu_torch.ops.kernels.covariance",
    "oisat_tpu_torch.ops.weights",
    "oisat_tpu_torch.ops.oi_full",
    "oisat_tpu_torch.ops.oi_full_matfree",
    "oisat_tpu_torch.native",
    "oisat_tpu_torch.utils",
    "oisat_tpu_torch.utils.lru",
    "oisat_tpu_torch.utils.stages",
    "oisat_tpu_torch.ops.knee",
    "oisat_tpu_torch.ops.oi",
    "oisat_tpu_torch.ops.averaging",
    "oisat_tpu_torch.ops.diagnostics",
    "oisat_tpu_torch.ops.vertical",
    "oisat_tpu_torch.ops.regrid",
    "oisat_tpu_torch.parallel",
    "oisat_tpu_torch.parallel.mesh",
    "oisat_tpu_torch.parallel.analysis",
    "oisat_tpu_torch.datamodel",
    "oisat_tpu_torch.convert",
    "oisat_tpu_torch.regridder",
    "oisat_tpu_torch.obs_operators",
    "oisat_tpu_torch.readers",
    "oisat_tpu_torch.readers.ncio",
    "oisat_tpu_torch.readers.registry",
    "oisat_tpu_torch.readers.ctm",
    "oisat_tpu_torch.readers.facade",
    "oisat_tpu_torch.readers.sensors",
    "oisat_tpu_torch.readers.sensors.common",
    "oisat_tpu_torch.readers.sensors.gosat",
    "oisat_tpu_torch.readers.sensors.mopitt",
    "oisat_tpu_torch.readers.sensors.omi",
    "oisat_tpu_torch.readers.sensors.omps",
    "oisat_tpu_torch.readers.sensors.ssmis",
    "oisat_tpu_torch.readers.sensors.tempo",
    "oisat_tpu_torch.readers.sensors.tropomi",
    "oisat_tpu_torch.ncwriter",
    "oisat_tpu_torch.data",
    "oisat_tpu_torch.data.coastlines_builtin",
    "oisat_tpu_torch.report",
    "oisat_tpu_torch.utils.granule_store",
    "oisat_tpu_torch.utils.profiling",
    "oisat_tpu_torch.driver",
    "oisat_tpu_torch.run",
    "oisat_tpu_torch.run.job",
    "oisat_tpu_torch.run.campaign",
    "oisat_tpu_torch.tools",
    "oisat_tpu_torch.tools.readjust_OI",
    "oisat_tpu_torch.examples",
    "oisat_tpu_torch.examples.synthetic_month",
    "oisat_tpu_torch.entry",
    "chip_smoke",
]

_BLOCKED = ("jax", "jaxlib", "h5py", "yaml", "matplotlib", "oisat_tpu")

# one tiny OMI-shaped orbit regridded on the CPU through the native builder
_REGRID = """
import numpy as np
from oisat_tpu_torch import native
from oisat_tpu_torch.entry import synthetic_orbit
from oisat_tpu_torch.regridder import regrid_granule
lon2d, lat2d = np.meshgrid(np.arange(-20.0, 20.0, 0.625), np.arange(-10.0, 10.25, 0.5))
orbit = synthetic_orbit(1, 0.0, ny=200, nx=20, nz=4, lat_range=(-12.0, 12.0), width_deg=10.0)
g = regrid_granule(1, 0.25, orbit, lon2d, lat2d, "cpu", flag_thresh=0.5)
assert native.available()
assert g is not None and int(g.vcd.isfinite().sum()) > 50
"""

# two MOPITT-shaped days on a coarse CTM grid (so the CTM is not upscaled)
# through the staged driver: conv_ak -> average -> bias_correct -> oi with a
# binned Desroziers pass -> savedaily
_STAGED = """
import tempfile
from types import SimpleNamespace
from oisat_tpu_torch.driver import oisatgmi
from oisat_tpu_torch.entry import synthetic_ctm, synthetic_mopitt_day
lon2d, lat2d = np.meshgrid(np.arange(-180.0, 180.0, 5.0), np.arange(-90.0, 90.1, 4.0))
ctm = synthetic_ctm(lon2d, lat2d, nt=2, nz=6, gas="CO")
grans = [regrid_granule(1, 1.0, synthetic_mopitt_day(1 + d, 1 + d), lon2d, lat2d, "cpu",
                        flag_thresh=0.0) for d in range(2)]
assert not grans[0].ctm_upscaled_needed and grans[0].averaging_kernels.shape[0] == 10
obj = oisatgmi()
obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
obj.conv_ak("MOPITT")
obj.average("2019-07-01", "2019-08-01")
obj.bias_correct("MOPITT", "CO")
obj.oi("MOPITT", desroziers_iterations=1, desroziers_bins=2)
assert obj.oi_diagnostics["n"] > 500 and obj.desroziers_sa_scale_map.shape == lat2d.shape
assert np.isfinite(obj.ctm_averaged_vcd_corrected).sum() > 500
with tempfile.TemporaryDirectory() as folder:
    obj.savedaily(folder, "CO", "201907")
    import os
    assert len(os.listdir(folder)) == 2
"""

# the same month through the job runner's dispatch (a control dictionary, no
# yaml), its diag fields, and what a call that needs an absent package does
_JOB = """
from oisat_tpu_torch.run.job import _analyze
ctrl = {"ctm_error": 50.0, "fused_month": True, "device": "cpu"}
job = oisatgmi()
job.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
_analyze(job, ctrl, "MOPITT", "CO", "2019-07-01", "2019-08-01", ("x", "y"))
fields = job._diag_fields()
assert len(fields) == 11 and fields["scaling_factor"].shape == lat2d.shape
assert np.isfinite(fields["scaling_factor"]).all()
job.settle_device_granules()
from oisat_tpu_torch.readers.ncio import read_nc
from oisat_tpu_torch.run.job import load_control
for call, args, package in ((read_nc, ("absent.nc", "x"), "h5py"),
                            (job.write_to_nc, ("tag", tempfile.gettempdir()), "h5py"),
                            (job.save_state, ("absent.h5",), "h5py"),
                            (job.reporting, ("tag", "CO", tempfile.gettempdir()), "matplotlib"),
                            (load_control, ("absent.yml",), "yaml")):
    try:
        call(*args)
    except ImportError as e:
        assert package in str(e), (package, e)
    else:
        raise AssertionError(f"{call.__name__} did not raise ImportError")
"""

# the matrix-free full OI: a 12 x 16 domain above a lowered dense limit
_FULL = """
from oisat_tpu_torch.ops import oi_full as T
T.DENSE_SCAN_MAX_CELLS = 50
rng = np.random.default_rng(3)
lon2, lat2 = np.meshgrid(np.linspace(-10, 10, 16), np.linspace(30, 41, 12))
xa = np.abs(rng.normal(3, 1, lat2.shape))
res = T.oi_full(xa, xa * 1.1, 0.5 * xa, np.full(lat2.shape, 0.8), lat2, lon2, 300.0,
                regularization_on=True, device="cpu")
assert res.info["precond"] == "jacobi" and np.isfinite(res.xb).all()
"""

# the mesh path: a 2 x 2 mesh of logical CPU shards, one sharded month step
# against the single-device step
_MESH = """
from oisat_tpu_torch.entry import synthetic_full_month
from oisat_tpu_torch.parallel.analysis import full_month_step, make_full_month_step
from oisat_tpu_torch.parallel.mesh import make_mesh
inputs = synthetic_full_month("cpu", G=5, H=9)
fn, shard = make_full_month_step(make_mesh(4, devices=["cpu"] * 4))
got, ref = fn(shard(inputs)), full_month_step(inputs)
assert int(got.oi.reg_index) == int(ref.oi.reg_index)
assert np.allclose(got.oi.xb.numpy(), ref.oi.xb.numpy(), rtol=1e-5, atol=1e-6, equal_nan=True)
"""


def test_slice_imports_without_jax_h5py_yaml_matplotlib():
    code = "\n".join([
        "import importlib, sys",
        f"for m in {_BLOCKED!r}:",
        "    sys.modules[m] = None",
        f"for name in {SLICE_MODULES!r}:",
        "    importlib.import_module(name)",
        "import oisat_tpu_torch",
        "oisat_tpu_torch.oisatgmi",
        _REGRID,
        _STAGED,
        _JOB,
        _FULL,
        _MESH,
        f"leaked = [m for m in {_BLOCKED!r} if sys.modules.get(m) is not None]",
        "leaked += [m for m in sys.modules if m.startswith('oisat_tpu.')]",
        "assert not leaked, leaked",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_no_module_of_the_port_imports_the_jax_package():
    """No import statement of oisat_tpu in the port or chip_smoke.py."""
    import re

    pat = re.compile(r"^\s*(from|import) oisat_tpu(\.|\s|$)")
    files = sorted((REPO / "oisat_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1) if pat.match(line)]
    assert not hits, hits


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("method", [1, 2, 4])
def test_copied_plan_builders_give_the_jax_plans(fast, method):
    """oisat_tpu_torch.ops.weights (and its native builder) against
    oisat_tpu.ops.weights (and oisat_tpu.native): identical plans for the
    scipy and the native builder."""
    from oisat_tpu.ops import weights as jw
    from oisat_tpu_torch.ops import weights as tw

    rng = np.random.default_rng(method)
    ny, nx = 40, 25
    lat = np.linspace(30.5, 45.2, ny)[:, None] * np.ones((ny, nx)) + 0.01 * rng.random((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(-9.8, 9.9, nx)[None, :] + 0.01 * rng.random((ny, nx))
    tlon, tlat = np.meshgrid(np.arange(-10, 10, 0.25), np.arange(30, 46, 0.25))
    if fast:
        got = tw.build_plan_structured(lon, lat, tlon, tlat, method=method, threshold=0.5)
        want = jw.build_plan_structured(lon, lat, tlon, tlat, method=method, threshold=0.5)
        assert got is not None and want is not None
    else:
        got = tw.build_plan(lon, lat, tlon, tlat, method=method, threshold=0.5)
        want = jw.build_plan(lon, lat, tlon, tlat, method=method, threshold=0.5)
    import dataclasses

    assert type(got).__name__ == type(want).__name__ == "SparsePlan"
    for field in dataclasses.fields(want):
        name = field.name
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b, equal_nan=True), name
        else:
            assert a == b, name
