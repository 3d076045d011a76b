"""The port's OI (oisat_tpu_torch.ops.oi, .knee, .kernels.oi_scan) against the
JAX package on the same numpy inputs, on the CPU.

The JAX side runs as its own tests run it (CPU, x64 on, the Pallas curve
kernel in interpret mode).  Tolerances: float64 rtol 1e-10 / atol 1e-12,
float32 rtol 1e-5 / atol 1e-6 (the two sides sum in different orders), NaN
patterns identical, the knee index exact.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oisat_tpu.ops import oi as jax_oi
from oisat_tpu.ops.kernels.oi_scan import ak_curve_pallas
from oisat_tpu.ops.knee import kneedle_index_np as jax_kneedle_np
from oisat_tpu_torch.ops import oi as port_oi
from oisat_tpu_torch.ops.kernels import oi_scan
from oisat_tpu_torch.ops.knee import kneedle_index_np
from tests.test_oi import make_fields

torch.set_num_threads(1)

# port vs JAX: float32 rtol 1e-5 / atol 1e-6, float64 rtol 1e-10 / atol 1e-12
TOL = {np.float32: dict(rtol=1e-5, atol=1e-6), np.float64: dict(rtol=1e-10, atol=1e-12)}
TDT = {np.float32: torch.float32, np.float64: torch.float64}
CORPUS = json.loads((Path(__file__).parent / "golden" / "knee_corpus.json").read_text())


def _t(a, dt):
    return torch.as_tensor(np.asarray(a, dt))


def assert_parity(got, want, dt, name=""):
    """Same shape, same NaN pattern, values within TOL[dt] (shared by the
    port's parity tests)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    np.testing.assert_allclose(got, want, equal_nan=True, err_msg=name, **TOL[dt])


def test_regularization_grid_is_the_reference_grid():
    assert np.array_equal(port_oi.regularization_grid(), jax_oi.regularization_grid())
    assert port_oi.regularization_grid().size == 99


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1])
def test_ak_curve_plain_matches_jax_scan_and_pallas(dt, seed):
    _, _, sa, so = make_fields(seed)
    regs = jax_oi.regularization_grid().astype(dt)
    got = port_oi.ak_curve(_t(sa, dt), _t(so, dt), _t(regs, dt))
    assert got.dtype == TDT[dt]
    want = np.asarray(jax_oi.ak_curve(jnp.asarray(sa, dt), jnp.asarray(so, dt),
                                      jnp.asarray(regs)))
    assert_parity(got.numpy(), want, dt, "xla scan")
    # the Pallas kernel accumulates in float32: compare at the f32 tolerance
    pal = np.asarray(ak_curve_pallas(sa.astype(np.float32), so.astype(np.float32),
                                     regs.astype(np.float32), rows_per_tile=8,
                                     interpret=True))
    assert_parity(got.numpy(), pal, np.float32, "pallas")
    # "auto" on a CPU tensor is the plain version
    auto = port_oi.ak_curve(_t(sa, dt), _t(so, dt), _t(regs, dt))
    assert torch.equal(auto, got)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("reg_on", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_oi_matches_jax(dt, reg_on, seed):
    xa, y, sa, so = make_fields(seed)
    res = port_oi.oi(*(_t(a, dt) for a in (xa, y, sa, so)), regularization_on=reg_on)
    ref = jax_oi.oi(*(jnp.asarray(a, dt) for a in (xa, y, sa, so)),
                    regularization_on=reg_on)
    assert int(res.reg_index) == int(ref.reg_index)
    assert res.reg_index.dtype == torch.int32
    for name in ("xb", "averaging_kernel", "increment", "error", "curve"):
        got = getattr(res, name)
        assert got.dtype == TDT[dt], name
        assert_parity(got.numpy(), np.asarray(getattr(ref, name)), dt, name)
    assert_parity(float(res.reg_factor), float(ref.reg_factor), dt, "reg_factor")


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_curve_edge_value_cross_product_matches_jax(dt):
    """(0, normal, inf, NaN) for both Sa and So: every case of the validity
    hoist, against the XLA scan and the Pallas kernel (tests/test_oi.py)."""
    vals = np.array([0.0, 1.5, np.inf, np.nan])
    sa2, so2 = np.meshgrid(vals, vals)
    sa, so = sa2.ravel(), so2.ravel()
    regs = jax_oi.regularization_grid()
    got = port_oi.ak_curve(_t(sa, dt), _t(so, dt), _t(regs, dt)).numpy()
    want = np.asarray(jax_oi.ak_curve(jnp.asarray(sa, dt), jnp.asarray(so, dt),
                                      jnp.asarray(regs, dt)))
    assert_parity(got, want, dt)
    pal = np.asarray(ak_curve_pallas(sa.astype(np.float32), so.astype(np.float32),
                                     regs.astype(np.float32), rows_per_tile=8,
                                     interpret=True))
    assert_parity(got, pal, np.float32, "pallas")


def test_inf_observation_variance_keeps_cell():
    sa = np.array([1.0, 2.0])
    so = np.array([1.0, np.inf])
    curve = port_oi.ak_curve(_t(sa, np.float64), _t(so, np.float64),
                             _t(port_oi.regularization_grid(), np.float64))
    np.testing.assert_allclose(float(curve[0]), (0.1 / 1.1) / 2.0, rtol=1e-12)
    res = port_oi.oi(_t([3.0, 5.0], np.float64), _t([4.0, 100.0], np.float64),
                     _t(sa, np.float64), _t(so, np.float64))
    ref = jax_oi.oi(jnp.asarray([3.0, 5.0]), jnp.asarray([4.0, 100.0]),
                    jnp.asarray(sa), jnp.asarray(so))
    assert float(res.xb[1]) == 5.0 and float(res.averaging_kernel[1]) == 0.0
    assert_parity(res.xb.numpy(), np.asarray(ref.xb), np.float64)
    assert int(res.reg_index) == int(ref.reg_index)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_all_invalid_domain_gives_nan_curve_and_first_factor(dt):
    nan = np.full((4, 5), np.nan)
    res = port_oi.oi(*(_t(nan, dt) for _ in range(4)))
    ref = jax_oi.oi(*(jnp.asarray(nan, dt) for _ in range(4)))
    assert torch.isnan(res.curve).all() and np.isnan(np.asarray(ref.curve)).all()
    assert int(res.reg_index) == int(ref.reg_index) == 0
    assert torch.isnan(res.xb).all()


def test_sa_zero_cells_nan_the_averaging_kernel():
    xa, y, sa, so = make_fields(7, zero_frac=0.3)
    res = port_oi.oi(*(_t(a, np.float64) for a in (xa, y, sa, so)))
    ref = jax_oi.oi(*(jnp.asarray(a) for a in (xa, y, sa, so)))
    zero = sa == 0
    assert torch.isnan(res.averaging_kernel[torch.as_tensor(zero)]).all()
    assert_parity(res.averaging_kernel.numpy(), np.asarray(ref.averaging_kernel), np.float64)


def test_negative_y_clamp():
    one = _t([[1.0]], np.float64)
    res = port_oi.oi(one, _t([[-3.0]], np.float64), one, one, regularization_on=False)
    np.testing.assert_allclose(float(res.increment[0, 0]), -0.5)


@pytest.mark.parametrize("i", range(CORPUS["n"]))
def test_kneedle_matches_golden_corpus(i):
    e = CORPUS["entries"][i]
    x = np.asarray(e["x"], np.float64)
    y = np.asarray(e["y"], np.float64)
    with np.errstate(all="ignore"):
        got = kneedle_index_np(x, y)
        assert got == e["expected_index"], e["name"]
        assert got == jax_kneedle_np(x, y)


def test_kernel_engine_refuses_cpu_tensors():
    _, _, sa, so = make_fields(0)
    regs = _t(port_oi.regularization_grid(), np.float64)
    with pytest.raises(ValueError, match="CUDA"):
        oi_scan.ak_curve_sums_kernel(_t(so, np.float64).ravel(), regs)


def test_no_public_callable_above_the_kernels_takes_an_engine_option():
    """The engine is picked by the tensor's device inside each kernel's
    module: no public function or method of the layers above takes a
    parameter naming one."""
    import importlib
    import inspect

    seen = 0
    for name in ("oisat_tpu_torch.driver", "oisat_tpu_torch.parallel.analysis",
                 "oisat_tpu_torch.ops.oi", "oisat_tpu_torch.ops.oi_full",
                 "oisat_tpu_torch.ops.oi_full_matfree"):
        mod = importlib.import_module(name)
        for attr, obj in vars(mod).items():
            if attr.startswith("_") or getattr(obj, "__module__", None) != name:
                continue
            members = ([(f"{attr}.{m}", f) for m, f in vars(obj).items()
                        if not m.startswith("_") and inspect.isfunction(f)]
                       if inspect.isclass(obj) else [(attr, obj)])
            for what, fn in members:
                if not inspect.isfunction(fn):
                    continue
                seen += 1
                params = inspect.signature(fn).parameters
                assert not [p for p in params if p.endswith("impl")], f"{name}.{what}"
    assert seen > 20


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_invalid_cell_term_is_positive_zero(dt):
    """The CUDA kernel skips the cells with u = +inf, which is exact because
    each such term r / (r + inf) is +0.0 (no sign bit) and adding +0.0 to a
    sum that starts at +0.0 leaves it +0.0 and any other sum unchanged."""
    regs = _t(port_oi.regularization_grid(), dt)
    term = regs / (regs + torch.tensor(np.inf, dtype=TDT[dt]))
    assert torch.equal(term, torch.zeros_like(term))
    assert not torch.signbit(term).any()
    zero = torch.zeros((), dtype=TDT[dt])
    assert not torch.signbit(zero + term).any()
    sums = torch.rand(99, dtype=TDT[dt], generator=torch.Generator().manual_seed(0))
    assert torch.equal(sums + term, sums)


def test_plain_sums_and_wrapper_agree_on_cpu():
    u = torch.rand(1000, dtype=torch.float64)
    regs = _t(port_oi.regularization_grid(), np.float64)
    before = oi_scan.ak_curve_sums_kernel.launches
    a = oi_scan.ak_curve_sums(u, regs)
    b = oi_scan.ak_curve_sums_plain(u, regs)
    assert torch.equal(a, b)
    assert oi_scan.ak_curve_sums_kernel.launches == before
    ref = (regs[:, None] / (regs[:, None] + u[None])).sum(1)
    np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=1e-12)
