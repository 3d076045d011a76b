"""The port's mesh path (oisat_tpu_torch.parallel) against the JAX package's
(oisat_tpu.parallel) and against the port's own single-device path, on the
CPU: the port's mesh is 8 logical CPU shards (``make_mesh(8, devices=["cpu"]
* 8)``, 2 x 4 obs x grid), the JAX side runs on its 8 virtual CPU devices
(tests/conftest.py), as tests/test_parallel.py does.

Tolerances (tests/test_parallel.py's):

* the sharded curve: rtol 2e-5 against the JAX shard_map'd kernel in
  float32, rtol 1e-12 against the port's unsharded curve in float64;
* the analysis step in float64: rtol 1e-12 / atol 1e-14;
* the month steps: rtol 1e-5 / atol 1e-6 (xb; MOPITT atol 1e-7, GOSAT 1e-4),
  against JAX in float64 (in float32 the synthetic month's AMF sums cancel
  and the two packages' summation orders differ by up to 7e-5,
  tests/test_torch_month.py) and against the port's unsharded step in the
  inputs' float32;
* the weighted month (float32 weights on both sides): rtol 2e-5 / atol 1e-6;
* the matrix-free solve with the JAX sketch fed in: atol 1e-4; the sharded
  sweep within 1e-5 of the largest |Y| of the unsharded one;
* the sharded regrid: bitwise the single-device regrid.

The knee index is equal in every case; a 1 x 1 mesh gives the unsharded step
bitwise; ``shard_inputs`` on one device copies nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from oisat_tpu.parallel import analysis as jan
from oisat_tpu.parallel import make_mesh as jax_make_mesh
from oisat_tpu.parallel.mesh import factor2 as jax_factor2
from oisat_tpu_torch import convert, entry
from oisat_tpu_torch.ops import oi as toi
from oisat_tpu_torch.ops import oi_full_matfree as M
from oisat_tpu_torch.ops.kernels import oi_scan
from oisat_tpu_torch.ops.knee import kneedle_index_np
from oisat_tpu_torch.parallel import analysis as tan
from oisat_tpu_torch.parallel.mesh import factor2, make_mesh
from oisat_tpu_torch.run import job as port_job

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
KINDS = {
    "full": (tan.make_full_month_step, tan.full_month_step, jan.make_full_month_step,
             graft._synthetic_full_month, convert.full_month_inputs, jan.FullMonthInputs),
    "mopitt": (tan.make_mopitt_month_step, tan.mopitt_month_step, jan.make_mopitt_month_step,
               graft._synthetic_mopitt_month, convert.mopitt_month_inputs,
               jan.MopittMonthInputs),
    "gosat": (tan.make_gosat_month_step, tan.gosat_month_step, jan.make_gosat_month_step,
              graft._synthetic_gosat_month, convert.gosat_month_inputs, jan.GosatMonthInputs),
    "ssmis": (tan.make_ssmis_month_step, tan.ssmis_month_step, jan.make_ssmis_month_step,
              graft._synthetic_ssmis_month, convert.ssmis_month_inputs, jan.SsmisMonthInputs),
}
XB_ATOL = {"full": 1e-6, "mopitt": 1e-7, "gosat": 1e-4, "ssmis": 1e-6}
FIELDS = ("sat_vcd", "sat_error", "ctm_vcd", "aux1", "aux2", "scaling_factor")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=CPU8)


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(8)


def _np(t):
    return t.detach().cpu().numpy().astype(np.float64)


def _close(got, want, rtol, atol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True, err_msg=name)


def _bitwise(a, b, name=""):
    assert a.dtype == b.dtype and a.shape == b.shape, name
    assert torch.equal(torch.isnan(a), torch.isnan(b)), name
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), name


def _host(kind, G, H, dt=None):
    """The JAX twin's synthetic month (numpy leaves), in ``dt`` when given;
    the JAX tuple carries table fields the port's dense tuple leaves out."""
    x = KINDS[kind][3](G=G, H=H, W=24)
    if dt is not None:
        x = type(x)(*(np.asarray(f, dt) for f in x))
    return x


# ---- the mesh ---------------------------------------------------------------------

def test_make_mesh_and_factor2_match_jax():
    for n in range(1, 17):
        assert factor2(n) == jax_factor2(n)
    m = make_mesh(8, devices=CPU8)
    assert m.shape == {"obs": 2, "grid": 4} and m.size == 8
    assert m.axis_names == ("obs", "grid") and len(m.flat_devices()) == 8
    assert hash(m) == hash(make_mesh(8, devices=CPU8)) and m == make_mesh(8, devices=CPU8)
    assert make_mesh(3, devices=CPU8).shape == {"obs": 1, "grid": 3}
    assert make_mesh(devices=["cpu"] * 6).shape == {"obs": 2, "grid": 3}
    with pytest.raises(RuntimeError, match="mesh requested 9 devices but the host has 8 "
                                           r"\(check the mesh_devices control key\)"):
        make_mesh(9, devices=CPU8)
    with pytest.raises(RuntimeError, match="mesh_devices"):
        make_mesh(torch.cuda.device_count() + 1)


# ---- the sharded curve -------------------------------------------------------------

def _curve_inputs(dt, n=50_000):
    """tests/test_parallel.py's curve inputs (n not a shard multiple)."""
    rng = np.random.default_rng(5)
    sa = np.abs(rng.normal(2, 1, n)).astype(np.float32)
    so = np.abs(rng.normal(1, 0.5, n)).astype(np.float32)
    sa[rng.random(n) < 0.2] = np.nan
    sa[rng.random(n) < 0.02] = 0.0
    return sa.astype(dt), so.astype(dt)


def test_sharded_curve_matches_jax_sharded_kernel(mesh, jmesh):
    from oisat_tpu.ops.kernels.oi_scan import ak_curve_pallas_sharded

    sa, so = _curve_inputs(np.float32)
    regs = toi.regularization_grid().astype(np.float32)
    want = np.asarray(ak_curve_pallas_sharded(sa, so, regs, jmesh, axis="grid",
                                              rows_per_tile=8))
    got = oi_scan.ak_curve_sharded(torch.as_tensor(sa), torch.as_tensor(so),
                                   torch.as_tensor(regs), mesh)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 2e-5, 0)
    grid = toi.regularization_grid()
    assert kneedle_index_np(grid, got.numpy()) == kneedle_index_np(grid, want)


@pytest.mark.parametrize("n_dev", [2, 3, 8])
def test_sharded_curve_matches_unsharded(n_dev):
    sa, so = (torch.as_tensor(a) for a in _curve_inputs(np.float64))
    regs = torch.as_tensor(toi.regularization_grid())
    m = make_mesh(n_dev, devices=CPU8)
    got = oi_scan.ak_curve_sharded(sa, so, regs, m)
    want = toi.ak_curve(sa, so, regs)
    _close(got.numpy(), want.numpy(), 1e-12, 0)
    grid = toi.regularization_grid()
    assert kneedle_index_np(grid, got.numpy()) == kneedle_index_np(grid, want.numpy())
    again = oi_scan.ak_curve_sharded(sa, so, regs, m)
    assert torch.equal(got, again)  # the fixed-order sum repeats bitwise
    # the plain engine per shard is the same function here (CPU shards)
    plain = oi_scan.ak_curve_sharded(sa, so, regs, m, engine=oi_scan.ak_curve_sums_plain)
    assert torch.equal(got, plain)


def test_sharded_curve_empty_and_all_invalid_shards(mesh):
    """3 grid rows over 4 grid shards (the last shard has no cells), and a
    shard whose cells are all invalid: both add nothing to the sums and the
    count, so the curve is the unsharded one; all cells invalid gives NaN."""
    rng = np.random.default_rng(2)
    sa = np.abs(rng.normal(2, 1, (3, 11)))
    so = np.abs(rng.normal(1, 0.5, (3, 11)))
    sa[1] = np.nan  # shard 1: all invalid
    regs = torch.as_tensor(toi.regularization_grid())
    sa_t, so_t = torch.as_tensor(sa), torch.as_tensor(so)
    parts = [p.numel() for p in torch.tensor_split(sa_t, 4, dim=0)]
    assert parts[-1] == 0
    got = oi_scan.ak_curve_sharded(sa_t, so_t, regs, mesh)
    _close(got.numpy(), toi.ak_curve(sa_t, so_t, regs).numpy(), 1e-12, 0)
    nan = oi_scan.ak_curve_sharded(torch.full_like(sa_t, np.nan), so_t, regs, mesh)
    assert torch.isnan(nan).all()
    u = [torch.empty(0, dtype=torch.float64), torch.full((5,), np.inf, dtype=torch.float64)]
    assert torch.equal(oi_scan.ak_curve_sums_sharded(u, regs), torch.zeros_like(regs))
    assert torch.equal(oi_scan.ak_curve_sums_sharded_plain(u, regs), torch.zeros_like(regs))


def test_oi_over_a_mesh_equals_oi_and_takes_curve_fn(mesh):
    """``oi(mesh=)`` (rows over the grid axis, one knee) against ``oi()``,
    and the JAX ``curve_fn`` hook with the sharded curve in it."""
    rng = np.random.default_rng(3)
    xa = torch.as_tensor(np.abs(rng.normal(3, 1, (17, 24))))
    y = xa * torch.as_tensor(rng.uniform(0.7, 1.4, (17, 24)))
    sa, so = (xa * 0.5) ** 2, torch.as_tensor(np.abs(rng.normal(0.4, 0.1, (17, 24))) ** 2)
    xa[2, :5] = np.nan
    ref = toi.oi(xa, y, sa, so)
    got = toi.oi(xa, y, sa, so, mesh=mesh)
    hook = toi.oi(xa, y, sa, so,
                  curve_fn=lambda a, o, r: oi_scan.ak_curve_sharded(a, o, r, mesh))
    for res in (got, hook):
        assert int(res.reg_index) == int(ref.reg_index)
        for name in ("xb", "averaging_kernel", "increment", "error", "curve"):
            _close(getattr(res, name).numpy(), getattr(ref, name).numpy(), 1e-12, 1e-14, name)
    with pytest.raises(ValueError, match="curve_fn"):
        toi.oi(xa, y, sa, so, mesh=mesh, curve_fn=lambda a, o, r: r)


# ---- the month steps ---------------------------------------------------------------

def _synth_analysis(G=4, H=16, W=24, seed=0):
    """tests/test_parallel.py's synth_inputs as numpy (float64)."""
    rng = np.random.default_rng(seed)

    def f():
        x = rng.normal(3, 1, (G, H, W))
        x[rng.random((G, H, W)) < 0.15] = np.nan
        return np.abs(x)

    return [f() for _ in range(5)]


@pytest.mark.parametrize("run_oi", [True, False])
def test_sharded_analysis_step_matches_jax_and_unsharded(mesh, jmesh, run_oi):
    host = _synth_analysis()
    kw = dict(bias_offset=0.3, bias_slope=0.7, run_oi=run_oi)
    inputs = tan.AnalysisInputs(*(torch.as_tensor(f) for f in host))
    fn, shard = tan.make_analysis_step(mesh, **kw)
    got = fn(shard(inputs))
    ref = tan.analysis_step(inputs, **kw)
    jfn, jshard = jan.make_analysis_step(jmesh, **kw)
    want = jfn(jshard(jan.AnalysisInputs(*(jnp.asarray(f) for f in host))))
    assert int(got.oi.reg_index) == int(ref.oi.reg_index) == int(want.oi.reg_index)
    for name in FIELDS:
        for other in (getattr(ref, name).numpy(), np.asarray(getattr(want, name))):
            _close(_np(getattr(got, name)), other, 1e-12, 1e-14, name)
    for other in (ref.oi.xb.numpy(), np.asarray(want.oi.xb)):
        _close(_np(got.oi.xb), other, 1e-12, 1e-14, "xb")
    _close(_np(got.oi.curve), np.asarray(want.oi.curve), 1e-12, 0, "curve")
    assert int(got.innovation.n) == int(want.innovation.n)
    for name in got.innovation._fields[1:]:
        _close(float(getattr(got.innovation, name)),
               float(getattr(want.innovation, name)), 1e-12, 1e-14, name)


@pytest.fixture(scope="module")
def jax_months(jmesh):
    """The JAX sharded month of each kind on (G, H) = (5, 17), float64."""
    out = {}
    for kind, (_, _, jmaker, _, _, jcls) in KINDS.items():
        fn, shard = jmaker(jmesh)
        out[kind] = fn(shard(_host(kind, 5, 17, np.float64)))
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_sharded_month_step_matches_jax(mesh, jax_months, kind):
    """Every maker on the non-divisible G = 5, H = 17 over 2 x 4, no padding,
    against the JAX maker (which pads and crops) in float64."""
    maker, _, _, _, conv, _ = KINDS[kind]
    fn, shard = maker(mesh)
    got = fn(shard(conv(_host(kind, 5, 17, np.float64), "cpu")))
    want = jax_months[kind]
    assert tuple(got.oi.xb.shape) == (17, 24)
    assert int(got.oi.reg_index) == int(want.oi.reg_index)
    _close(_np(got.oi.xb), np.asarray(want.oi.xb), 1e-5, XB_ATOL[kind], "xb")
    _close(_np(got.oi.curve), np.asarray(want.oi.curve), 1e-5, 0, "curve")
    for name in FIELDS:
        _close(_np(getattr(got, name)), np.asarray(getattr(want, name)), 1e-5, 1e-6, name)
    if kind == "gosat":
        assert torch.isnan(got.ctm_vcd).all()


@pytest.mark.parametrize("G,H,dt", [(4, 16, None), (5, 17, None), (1, 3, np.float64)])
@pytest.mark.parametrize("kind", list(KINDS))
def test_sharded_month_step_matches_unsharded(mesh, kind, G, H, dt):
    """The makers against the port's single-device step: on the inputs'
    float32 at the JAX tests' bounds, and with an empty granule block
    (G = 1) and an empty grid shard (H = 3 over 4) in float64 at rtol 1e-10
    (the synthetic month's AMF sums cancel, so float32 rounding of two
    summation orders would show)."""
    maker, step, _, _, conv, _ = KINDS[kind]
    inputs = conv(_host(kind, G, H, dt), "cpu")
    fn, shard = maker(mesh)
    got = fn(shard(inputs))
    ref = step(inputs)
    rtol, atol = (1e-10, 1e-12) if dt else (1e-5, XB_ATOL[kind])
    assert int(got.oi.reg_index) == int(ref.oi.reg_index)
    _close(got.oi.xb.numpy(), ref.oi.xb.numpy(), rtol, atol, "xb")
    _close(got.oi.curve.numpy(), ref.oi.curve.numpy(), rtol, 0, "curve")
    for name in FIELDS:
        _close(getattr(got, name).numpy(), getattr(ref, name).numpy(), rtol,
               atol if dt else 1e-6, name)


def test_sharded_month_without_oi_and_with_daily_granules(mesh, jmesh):
    """``run_oi=False`` with ``return_granules=True`` and the weighted mean on
    G = 5, H = 17: the averaged fields and the daily granules (in granule
    order) against the unsharded step and the JAX maker (whose daily
    granules trail its padded granules)."""
    kw = dict(weighting="inverse_variance", return_granules=True, run_oi=False,
              bias_offset=0.1, bias_slope=0.9)
    host = _host("full", 5, 17, np.float64)
    inputs = convert.full_month_inputs(host, "cpu")
    fn, shard = tan.make_full_month_step(mesh, **kw)
    out, daily = fn(shard(inputs))
    ref, ref_daily = tan.full_month_step(inputs, **kw)
    jfn, jshard = jan.make_full_month_step(jmesh, **kw)
    jout, jdaily = jfn(jshard(host))
    assert isinstance(daily, tan.DailyGranules) and tuple(daily.vcd.shape) == (5, 17, 24)
    for a, b, w in zip(daily, ref_daily, jdaily):
        _close(a.numpy(), b.numpy(), 1e-12, 1e-14)
        _close(a.numpy(), np.asarray(w)[:5], 1e-12, 1e-14)
    # the inverse-variance weights are float32 in both packages: the
    # weighted means at tests/test_parallel.py's bound for them
    for name in ("sat_vcd", "sat_error", "ctm_vcd", "aux1", "aux2"):
        _close(getattr(out, name).numpy(), getattr(ref, name).numpy(), 2e-5, 1e-6, name)
        _close(getattr(out, name).numpy(), np.asarray(getattr(jout, name)), 2e-5, 1e-6, name)
    assert int(out.oi.reg_index) == int(jout.oi.reg_index) == -1
    assert torch.isnan(out.oi.xb).all() and int(out.innovation.n) == 0
    assert torch.equal(out.scaling_factor, torch.ones_like(out.scaling_factor))


@pytest.mark.parametrize("kind", list(KINDS))
def test_one_by_one_mesh_is_the_unsharded_step_bitwise(kind):
    maker, step, _, _, conv, _ = KINDS[kind]
    inputs = conv(_host(kind, 5, 17), "cpu")
    kw = dict(weighting="inverse_variance", return_granules=True)
    fn, shard = maker(make_mesh(1, devices=["cpu"]), **kw)
    got, got_daily = fn(shard(inputs))
    ref, ref_daily = step(inputs, **kw)
    for a, b in zip(got_daily, ref_daily):
        _bitwise(a, b)
    for name in FIELDS:
        _bitwise(getattr(got, name), getattr(ref, name), name)
    for name in got.oi._fields:
        _bitwise(getattr(got.oi, name), getattr(ref.oi, name), name)
    for name in got.innovation._fields:
        _bitwise(getattr(got.innovation, name), getattr(ref.innovation, name), name)


def test_shard_inputs_on_one_device_copies_nothing(mesh):
    inputs = convert.full_month_inputs(_host("full", 5, 17), "cpu")
    sharded = tan.make_full_month_step(mesh)[1](inputs)
    rows, cols = len(sharded.blocks), len(sharded.blocks[0])
    assert (rows, cols) == (2, 4)
    for i in range(rows):
        for j in range(cols):
            for name, whole in zip(tan.FullMonthInputs._fields, inputs):
                part = getattr(sharded.blocks[i][j], name)
                assert part.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr()
    # the blocks tile the month exactly: granules 3 + 2, rows 5 + 4 + 4 + 4
    assert [b.vcd.shape[0] for b in (sharded.blocks[0][0], sharded.blocks[1][0])] == [3, 2]
    assert [b.vcd.shape[1] for b in sharded.blocks[0]] == [5, 4, 4, 4]


def test_dryrun_multichip_on_cpu_shards():
    reg = entry.dryrun_multichip(8, device="cpu")
    assert set(reg) == {"amf", "opt", "gosat", "ssmis"}
    for kind, maker in (("amf", entry.synthetic_full_month),
                        ("opt", entry.synthetic_mopitt_step_inputs),
                        ("gosat", entry.synthetic_gosat_step_inputs),
                        ("ssmis", entry.synthetic_ssmis_step_inputs)):
        jkind = {"amf": "full", "opt": "mopitt"}.get(kind, kind)
        host = _host(jkind, 4, 16)
        got = maker("cpu")
        for name in type(got)._fields:
            a, b = getattr(got, name).numpy(), np.asarray(getattr(host, name))
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), (kind, name)


# ---- the matrix-free sweeps --------------------------------------------------------

def test_sharded_b_matmat_matches_unsharded(mesh):
    rng = np.random.default_rng(0)
    n, k = 512, 8
    u3 = torch.as_tensor(M._sphere_points(rng.uniform(38, 44, n),
                                          rng.uniform(-3, 3, n)).astype(np.float32))
    sb = torch.as_tensor(np.abs(rng.normal(1, 0.3, n)).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal((n, k)).astype(np.float32))
    ref = M._b_matmat(u3, sb, v, 300.0, 128)
    got = M._b_matmat(u3, sb, v, 300.0, 128, mesh)  # 4 chunks over 8 positions
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    assert torch.equal(got, M._b_matmat(u3, sb, v, 300.0, 128, mesh))
    three = make_mesh(3, devices=CPU8)  # 4 chunks over 3 positions: uneven
    assert float((M._b_matmat(u3, sb, v, 300.0, 128, three) - ref).abs().max()) <= 1e-5 * scale


def test_sharded_matfree_matches_jax_sharded(mesh, jmesh):
    """tests/test_parallel.py's sharded solve, with the JAX Nystrom sketch
    fed in, against the JAX solve on its mesh and the port's unsharded one."""
    from oisat_tpu.ops.oi_full import oi_full_matfree as jax_matfree

    H, W = 16, 32
    rng = np.random.default_rng(5)
    lon, lat = np.meshgrid(np.linspace(-3, 3, W), np.linspace(38, 44, H))
    xa = np.abs(rng.normal(0.8, 0.1, (H, W))).ravel()
    y = (xa.reshape(H, W) * rng.uniform(0.9, 1.2, (H, W))).ravel()
    args = (xa, y, 0.5 * xa, np.full(H * W, 0.1), lat.ravel(), lon.ravel(), 300.0)
    kw = dict(block=128, precond="nystrom", nystrom_k=128, refine=0)
    want = jax_matfree(*args, mesh=jmesh, **kw)
    omega = torch.as_tensor(np.array(jax.random.normal(jax.random.key(0), (H * W, 128),
                                                       jnp.float32)))
    got = M.oi_full_matfree(*args, omega=omega, device="cpu", mesh=mesh, **kw)
    single = M.oi_full_matfree(*args, omega=omega, device="cpu", **kw)
    assert got[4]["cg_resid"] < 1e-3
    for i in (0, 1, 2, 3):
        np.testing.assert_allclose(got[i], np.asarray(want[i]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[i], single[i], rtol=0, atol=1e-4)


def test_oi_full_with_a_mesh_shards_the_large_branch(monkeypatch, mesh):
    """``oi_full(mesh=)`` above a lowered dense limit: the SLQ knee and the
    solve sweep over the mesh and give the mesh-less result; a 1-position
    mesh is dropped (bitwise the mesh-less result)."""
    from oisat_tpu_torch.ops import oi_full as T

    monkeypatch.setattr(T, "DENSE_SCAN_MAX_CELLS", 50)
    rng = np.random.default_rng(3)
    lon2, lat2 = np.meshgrid(np.linspace(-10, 10, 16), np.linspace(30, 41, 12))
    xa = np.abs(rng.normal(3, 1, lat2.shape))
    args = (xa, xa * 1.1, 0.5 * xa, np.full(lat2.shape, 0.8), lat2, lon2, 300.0)
    ref = T.oi_full(*args, regularization_on=True, device="cpu")
    got = T.oi_full(*args, regularization_on=True, device="cpu", mesh=mesh)
    one = T.oi_full(*args, regularization_on=True, device="cpu",
                    mesh=make_mesh(1, devices=["cpu"]))
    assert got.info["precond"] == ref.info["precond"] == "jacobi"
    for a, b, c in zip(got[:4], ref[:4], one[:4]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.nanmax(np.abs(b)))
        assert np.array_equal(c, b, equal_nan=True)


# ---- the regrid --------------------------------------------------------------------

@pytest.fixture
def regrid_mesh_reset():
    from oisat_tpu_torch.regridder import set_regrid_mesh

    yield
    set_regrid_mesh(None)


@pytest.mark.parametrize("grid_size", [0.25, 2.0])
def test_sharded_regrid_is_the_single_device_regrid(mesh, grid_size):
    """The fine grid's rows over 8 shards with the box filter's halo
    (0.25 deg), and the pass-through exit (2.0 deg: the granule grid is
    coarser than the CTM), bitwise."""
    from oisat_tpu_torch.regridder import _REGRID_MESH, regrid_granule, regrid_mesh
    from tests.test_pipeline import ctm_grid, synthetic_granule

    clon, clat = ctm_grid()

    def run():
        g = convert.satellite_amf_from(synthetic_granule(7, 11))
        return regrid_granule(1, grid_size, g, clon, clat, "cpu", flag_thresh=0.5)

    base = run()
    with regrid_mesh(mesh):
        spmd = run()
    assert _REGRID_MESH["mesh"] is None
    assert base.ctm_upscaled_needed == spmd.ctm_upscaled_needed == (grid_size == 2.0)
    for n in ("vcd", "amf", "uncertainty", "pressure_mid", "scattering_weights"):
        _bitwise(getattr(spmd, n), getattr(base, n), n)


def test_sharded_ssmis_regrid_is_the_single_device_regrid(mesh):
    from oisat_tpu_torch.datamodel import satellite_ssmis
    from oisat_tpu_torch.regridder import regrid_mesh, regrid_ssmis_granule

    lat = np.arange(-89.5, 90, 2.0)
    lon = np.arange(-179.5, 180, 2.0)
    lon2, lat2 = np.meshgrid(lon, lat)
    vcd = 20 + 5 * np.sin(lon2 / 20.0) * np.cos(lat2 / 15.0)

    def g():
        return satellite_ssmis(vcd=vcd.copy(), uncertainty=np.full(lat2.shape, 1.0),
                               time=None, latitude_center=lat2, longitude_center=lon2,
                               ctm_upscaled_needed=False, ctm_vcd=[], sensor="SSMIS")

    clon2, clat2 = np.meshgrid(np.arange(-20.0, 10.0, 2.0), np.arange(20.0, 60.0, 2.0))
    base = regrid_ssmis_granule(2.0, g(), clon2, clat2, "cpu")
    with regrid_mesh(mesh):
        spmd = regrid_ssmis_granule(2.0, g(), clon2, clat2, "cpu")
    for n in ("vcd", "uncertainty"):
        _bitwise(getattr(spmd, n), getattr(base, n), n)


def test_regrid_mesh_is_visible_in_worker_threads(mesh):
    """The regrid mesh is process-wide (tests/test_parallel.py's fleet-pool
    case): the readers regrid in worker threads."""
    from concurrent.futures import ThreadPoolExecutor

    from oisat_tpu_torch.regridder import _regrid_mesh_default, regrid_mesh

    with regrid_mesh(mesh):
        with ThreadPoolExecutor(3) as pool:
            seen = list(pool.map(lambda _: _regrid_mesh_default(), range(3)))
    assert all(m is mesh for m in seen)
    assert _regrid_mesh_default() is None  # the context restored


# ---- the driver, the job runner, the example ---------------------------------------

def _omi_session(n=3):
    """A small OMI month regridded on the CPU (examples/synthetic_month)."""
    from types import SimpleNamespace

    from oisat_tpu_torch.driver import oisatgmi
    from oisat_tpu_torch.examples.synthetic_month import make_ctm, make_granule
    from oisat_tpu_torch.regridder import regrid_granule

    ctm, clon, clat = make_ctm()
    grans = [regrid_granule(1, 0.25, make_granule(s, 4 + s), clon, clat, "cpu",
                            flag_thresh=0.5) for s in range(n)]
    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    return obj


ATTRS = ("sat_averaged_vcd", "sat_averaged_error", "ctm_averaged_vcd", "aux1", "aux2",
         "ctm_averaged_vcd_corrected", "ak_OI", "increment_OI", "error_OI")


@pytest.mark.parametrize("kw", [{}, {"desroziers_iterations": 1, "desroziers_bins": 2},
                                {"oi_method": "full"}])
def test_analyze_month_fused_and_oi_with_a_mesh(mesh, kw):
    """``analyze_month_fused(mesh=)`` and the staged ``oi(mesh=)`` against
    their mesh-less runs on the same granules: the same factor, fields at
    the month steps' float32 tolerance."""
    month = ("OMI", "NO2", "2019-07-01", "2019-08-01")
    ref, got = _omi_session(), _omi_session()
    ref.analyze_month_fused(*month, **kw)
    got.analyze_month_fused(*month, mesh=mesh, **kw)
    for name in ATTRS:
        a, b = getattr(got, name), getattr(ref, name)
        _close(a, b, 1e-5, 1e-6 * np.nanmax(np.abs(b)), name)
    assert set(got.oi_diagnostics) == set(ref.oi_diagnostics)
    if "oi_method" not in kw:
        staged = _omi_session()
        staged.sat_averaged_vcd, staged.sat_averaged_error = ref.sat_averaged_vcd, \
            ref.sat_averaged_error
        staged.ctm_averaged_vcd = ref.ctm_averaged_vcd
        staged.oi("OMI", mesh=mesh, **kw)
        plain = _omi_session()
        plain.sat_averaged_vcd, plain.sat_averaged_error = ref.sat_averaged_vcd, \
            ref.sat_averaged_error
        plain.ctm_averaged_vcd = ref.ctm_averaged_vcd
        plain.oi("OMI", **kw)
        for name in ATTRS[5:]:
            _close(getattr(staged, name), getattr(plain, name), 1e-12, 1e-14, name)


def test_mesh_from_ctrl_and_the_over_request(tmp_path, regrid_mesh_reset):
    """The ``mesh_devices`` key (tests/test_parallel.py's cases, with the
    port's ``device`` key): absent / 1 -> None; an integer N of the CPU ->
    N logical shards; ``all`` of the CPU -> one; on the card, more cards
    than the host has raises, before any file is read."""
    cpu = {"device": "cpu"}
    assert port_job.mesh_from_ctrl({}) is None
    assert port_job.mesh_from_ctrl({"mesh_devices": 1, **cpu}) is None
    m = port_job.mesh_from_ctrl({"mesh_devices": 8, **cpu})
    assert m.size == 8 and set(m.axis_names) == {"obs", "grid"} and m.shape["grid"] == 4
    assert port_job.mesh_from_ctrl({"mesh_devices": "all", **cpu}).size == 1
    assert port_job.month_setup({"mesh_devices": 4, **cpu}).size == 4
    from oisat_tpu_torch.regridder import _regrid_mesh_default

    assert _regrid_mesh_default().size == 4  # the readers' regrids run over it
    n = torch.cuda.device_count()
    over = {"mesh_devices": max(n + 1, 2), "device": "cuda"}
    with pytest.raises(RuntimeError, match=f"mesh requested {max(n + 1, 2)} devices but the host "
                                           f"has {n}"):
        port_job.mesh_from_ctrl(over)
    ctrl = dict(over, sensor="OMI", gas="NO2", ctm_name="GMI", ctm_dir=str(tmp_path / "no"),
                sat_dir=str(tmp_path / "no"))
    for call in (port_job.read_month, port_job.run_month):
        with pytest.raises(RuntimeError, match="check the mesh_devices control key"):
            call(ctrl, 2019, 7)
