"""The port's month statistics and analysis steps against the JAX package on
the same numpy inputs, on the CPU: ops.averaging, ops.diagnostics,
parallel.analysis.analysis_step and every AnalysisOutputs leaf of
full_month_step on ``__graft_entry__._synthetic_full_month()``.

Tolerances: float64 rtol 1e-10 / atol 1e-12, float32 rtol 1e-5 / atol 1e-6;
NaN patterns identical; the knee index exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from oisat_tpu.ops import averaging as jav
from oisat_tpu.ops import diagnostics as jdiag
from oisat_tpu.parallel import analysis as jan
from oisat_tpu_torch import convert, entry
from oisat_tpu_torch.ops import averaging as tav
from oisat_tpu_torch.ops import diagnostics as tdiag
from oisat_tpu_torch.parallel import analysis as tan
from tests.test_torch_oi import assert_parity

torch.set_num_threads(1)



def _leaves(tree, prefix=""):
    """(path, leaf) pairs of nested NamedTuples."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}{name}.")
    else:
        yield prefix.rstrip("."), tree


def _stack(seed=0, G=5, H=7, W=9, dt=np.float64):
    rng = np.random.default_rng(seed)
    vcd = rng.normal(3, 1, (G, H, W))
    err = np.abs(rng.normal(0.5, 0.2, (G, H, W)))
    ctm = rng.normal(3, 1, (G, H, W))
    a1 = rng.normal(2, 0.3, (G, H, W))
    a2 = rng.normal(2, 0.3, (G, H, W))
    for f in (vcd, err, ctm, a1, a2):
        f[rng.random((G, H, W)) < 0.3] = np.nan
    vcd[0, 0, 0] = np.inf
    err[1, 1, 1] = np.inf
    err[2, 2, 2] = 0.0
    vcd[:, 3, 3] = np.nan  # a cell with no data
    err[:, 4, 4] = np.nan
    return [f.astype(dt) for f in (vcd, err, ctm, a1, a2)]


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_monthly_stats_matches_jax(dt):
    fields = _stack(dt=dt)
    got = tav.monthly_stats(*(torch.as_tensor(f) for f in fields))
    want = jav.monthly_stats(*(jnp.asarray(f) for f in fields))
    for name in tav.MonthlyAverage._fields:
        assert_parity(getattr(got, name).numpy(), getattr(want, name), dt, name)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_monthly_stats_weighted_matches_jax(dt):
    fields = _stack(1, dt=dt)
    w = np.abs(np.random.default_rng(9).normal(1, 0.5, fields[0].shape)).astype(dt)
    w[0, 1, :] = 0.0
    w[1, 2, :] = np.nan
    w[2, 3, :] = -1.0
    got = tav.monthly_stats_weighted(*(torch.as_tensor(f) for f in fields + [w]))
    want = jav.monthly_stats_weighted(*(jnp.asarray(f) for f in fields + [w]))
    for name in tav.MonthlyAverage._fields:
        assert_parity(getattr(got, name).numpy(), getattr(want, name), dt, name)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_innovation_stats_matches_jax(dt):
    rng = np.random.default_rng(4)
    xa, y, xb = (rng.normal(3, 1, (9, 11)) for _ in range(3))
    sa, so = (np.abs(rng.normal(1, 0.3, (9, 11))) for _ in range(2))
    xa[0, :3] = np.nan
    so[1, :2] = np.inf
    sa[2, 0], so[2, 0] = 0.0, 0.0  # denom 0 -> excluded from chi2 only
    args = [a.astype(dt) for a in (xa, y, xb, sa, so)]
    got = tdiag.innovation_stats(*(torch.as_tensor(a) for a in args))
    want = jdiag.innovation_stats(*(jnp.asarray(a) for a in args))
    assert int(got.n) == int(want.n)
    for name in tdiag.InnovationStats._fields[1:]:
        assert_parity(float(getattr(got, name)), float(getattr(want, name)), dt, name)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_analysis_step_matches_jax(weighted, dt):
    fields = _stack(2, G=6, H=12, W=14, dt=dt)
    fields[2] = np.abs(fields[2])  # a positive prior
    kw = dict(bias_offset=0.32, bias_slope=0.63, error_ctm=40.0, ctm_scale=1.1)
    w = None
    if weighted:
        w = (1.0 / np.where(fields[1] > 0, fields[1], np.nan) ** 2).astype(dt)
    got = tan.analysis_step(convert.analysis_inputs(jan.AnalysisInputs(*fields), "cpu"),
                            weights=None if w is None else torch.as_tensor(w), **kw)
    want = jan.analysis_step(jan.AnalysisInputs(*(jnp.asarray(f) for f in fields)),
                             weights=None if w is None else jnp.asarray(w), **kw)
    assert int(got.oi.reg_index) == int(want.oi.reg_index)
    for (path, g), (_, wv) in zip(_leaves(convert.to_numpy(got)), _leaves(want)):
        assert_parity(g, wv, dt, path)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_analysis_step_without_oi_matches_jax(dt):
    """run_oi=False (the oi_method="full" month): the averaged fields as
    with the OI, NaN OI placeholders, reg_index -1, n = 0, scaling 1."""
    fields = _stack(3, G=6, H=12, W=14, dt=dt)
    fields[2] = np.abs(fields[2])
    kw = dict(bias_offset=0.32, bias_slope=0.63, run_oi=False)
    got = tan.analysis_step(convert.analysis_inputs(jan.AnalysisInputs(*fields), "cpu"), **kw)
    want = jan.analysis_step(jan.AnalysisInputs(*(jnp.asarray(f) for f in fields)), **kw)
    assert int(got.oi.reg_index) == int(want.oi.reg_index) == -1
    assert int(got.innovation.n) == int(want.innovation.n) == 0
    got_leaves, want_leaves = list(_leaves(convert.to_numpy(got))), list(_leaves(want))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert_parity(g, w, dt, path)
    assert torch.equal(got.scaling_factor, torch.ones_like(got.scaling_factor))


def test_full_month_step_without_oi_keeps_the_averaged_fields():
    inputs = entry.synthetic_full_month("cpu")
    with_oi = tan.full_month_step(inputs)
    without = tan.full_month_step(inputs, run_oi=False)
    for name in ("sat_vcd", "sat_error", "ctm_vcd", "aux1", "aux2"):
        a, b = getattr(with_oi, name), getattr(without, name)
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), name
    assert torch.isnan(without.oi.xb).all() and int(without.oi.reg_index) == -1


def _month_pair(weighting, dt):
    """(port, jax) full_month_step outputs on __graft_entry__'s month in ``dt``."""
    host = [np.asarray(x, dt) for x in graft._synthetic_full_month()]
    kw = dict(bias_offset=0.32, bias_slope=0.63, weighting=weighting)
    got = tan.full_month_step(convert.full_month_inputs(tan.FullMonthInputs(*host), "cpu"),
                              **kw)
    want = jan.full_month_step(jan.FullMonthInputs(*(jnp.asarray(x) for x in host)), **kw)
    got_leaves, want_leaves = list(_leaves(convert.to_numpy(got))), list(_leaves(want))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    assert len(got_leaves) == 19
    assert int(got.oi.reg_index) == int(want.oi.reg_index)
    return got_leaves, want_leaves


@pytest.mark.parametrize("weighting", [None, "inverse_variance"])
def test_full_month_step_matches_jax_every_leaf(weighting):
    """Every AnalysisOutputs leaf of the port's full_month_step against the
    JAX step on __graft_entry__._synthetic_full_month() (G=4, Ls=6, Lc=12,
    H=16, W=24), in float64."""
    for (path, g), (_, w) in zip(*_month_pair(weighting, np.float64)):
        assert_parity(g, w, np.float64, path)


@pytest.mark.parametrize("weighting", [None, "inverse_variance"])
def test_full_month_step_float32_as_accurate_as_jax(weighting):
    """The same month in float32.  Its AMF sums extrapolate the scattering
    weights and cancel, so float32 loses ~2e-3 relative against float64 on
    BOTH sides and the two summation orders differ by up to ~7e-5: the port
    must keep the knee, the NaN pattern, and stay within twice the JAX
    package's own float32 error (plus rtol 1e-5 / atol 1e-6) of the
    float64 result."""
    ref = dict(_month_pair(weighting, np.float64)[1])
    got_leaves, want_leaves = _month_pair(weighting, np.float32)
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        r = np.asarray(ref[path], np.float64)
        assert np.array_equal(np.isnan(g), np.isnan(w)), path
        bound = 2.0 * np.abs(w - r) + 1e-5 * np.abs(r) + 1e-6
        ok = np.isnan(g) | (np.abs(g - r) <= bound)
        assert ok.all(), (path, np.nanmax(np.abs(g - r) - bound))


def test_full_month_step_granule_chunks_are_exact(monkeypatch):
    """Chunking the AMF recalculation over granules changes nothing."""
    inputs = entry.synthetic_full_month("cpu", G=5)
    whole = tan.full_month_step(inputs)
    monkeypatch.setattr(tan, "_AMF_CHUNK_CELL_LEVELS", 2 * inputs.ctm_pmid[0].numel())
    chunked = tan.full_month_step(inputs)
    for (path, a), (_, b) in zip(_leaves(whole), _leaves(chunked)):
        assert torch.equal(torch.isnan(a), torch.isnan(b)), path
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), path


def test_entry_inputs_are_the_graft_entry_inputs():
    fn, (inputs,) = entry.entry("cpu")
    assert fn is tan.full_month_step
    host = graft._synthetic_full_month()
    for name in tan.FullMonthInputs._fields:
        a = getattr(inputs, name).numpy()
        b = getattr(host, name)
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), name
    out = fn(inputs)
    assert out.oi.xb.shape == (16, 24)
    assert torch.isfinite(out.scaling_factor).all()


def test_weighting_ak_is_not_ported():
    """"ak" weights need averaging kernels: an AMF month refuses them on both
    sides (the averaging-kernel sensors take them, tests/test_torch_sensors.py)."""
    with pytest.raises(ValueError, match="averaging-kernel"):
        tan.full_month_step(entry.synthetic_full_month("cpu"), weighting="ak")
    host = graft._synthetic_full_month()
    with pytest.raises(ValueError, match="averaging-kernel"):
        jan.full_month_step(jan.FullMonthInputs(*(jnp.asarray(x) for x in host)),
                            weighting="ak")
