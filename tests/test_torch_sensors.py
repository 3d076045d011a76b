"""The port's MOPITT / GOSAT / SSMIS operators and month steps
(oisat_tpu_torch.ops.vertical, .parallel.analysis) against their JAX twins on
the same numpy inputs, on the CPU.

Tolerances.  The vertical operators: float64 at rtol 1e-12 (atol 1e-12 of
the field's largest magnitude: the level sums run in another order), float32
at rtol 1e-5 with atol 1e-5 of the field's largest magnitude (MOPITT's
log-difference sums cancel).  The month steps: every ``AnalysisOutputs``
leaf in float64 at rtol 1e-10 / atol 1e-12 (tests.test_torch_oi.TOL), the
knee index exact.  NaN patterns identical everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from oisat_tpu.ops import vertical as jv
from oisat_tpu.parallel import analysis as jan
from oisat_tpu_torch import convert
from oisat_tpu_torch.ops import vertical as tv
from oisat_tpu_torch.parallel import analysis as tan
from tests.test_torch_month import _leaves
from tests.test_torch_oi import assert_parity

torch.set_num_threads(1)

RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def _assert_close(got, want, dt, name=""):
    """Same shape and NaN / inf pattern, finite values within RTOL[dt] plus
    that much of the field's largest finite magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    assert np.array_equal(np.isinf(got), np.isinf(want)), name
    fin = np.isfinite(want)
    assert fin.sum() > 0.3 * want.size, name
    scale = np.abs(want[fin]).max()
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL[dt], atol=RTOL[dt] * scale,
                               err_msg=name)


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _mopitt_columns(seed=5, H=10, W=12, Ls=9, Lc=12):
    """(ctm_pmid, prof, airpc, sat_pmid, aks, aprior_col, apriori_profile,
    apriori_surface, vcd) with the cells that make the operator branch."""
    rng = np.random.default_rng(seed)
    sat_pmid = np.sort(rng.uniform(100, 900, (Ls, H, W)), axis=0)[::-1].copy()
    ctm_pmid = np.sort(rng.uniform(30, 1010, (Lc, H, W)), axis=0)[::-1].copy()
    prof = np.abs(rng.normal(80, 20, (Lc, H, W)))
    airpc = np.asarray(jv.air_partial_column(rng.uniform(5, 30, (Lc, H, W))))
    aks = rng.uniform(0, 0.6, (Ls + 1, H, W))
    aprior_col = np.abs(rng.normal(2, 0.3, (H, W)))
    apriori_profile = np.abs(rng.normal(80, 15, (Ls, H, W)))
    apriori_surface = np.abs(rng.normal(90, 10, (H, W)))
    vcd = np.abs(rng.normal(2, 0.5, (H, W)))
    vcd[rng.random((H, W)) < 0.2] = np.nan
    vcd[0, 0] = np.inf  # model_vcd NaN, model_xcol kept
    vcd[0, 1], vcd[0, 2], vcd[0, 3], vcd[0, 4], vcd[0, 5] = 1.0, 1.0, 1.0, 1.0, 1.0
    prof[3, 0, 1] = 0.0  # log10 -> -inf in the interpolant
    prof[4, 0, 2] = -5.0  # log10 -> NaN, dropped by the nansum
    prof[0, 0, 3] = 0.0  # the surface component -> -inf
    apriori_profile[:, 0, 4] = np.nan  # an all-NaN column sums to 0
    apriori_profile[2, 1, 0] = 0.0
    airpc[:, 1, 1] = np.nan  # xcol: division by the 0 of an all-NaN column
    airpc[2, 1, 2] = np.inf
    aks[3, 1, 3] = np.nan
    ctm_pmid[[2, 5], 1, 4] = ctm_pmid[[5, 2], 1, 4]  # non-monotone: whole column NaN
    ctm_pmid[3, 1, 5] = np.nan
    sat_pmid[0, 2, 0] = 2000.0  # below the CTM's range: no extrapolation
    return (ctm_pmid, prof, airpc, sat_pmid, aks, aprior_col, apriori_profile,
            apriori_surface, vcd)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_ak_conv_mopitt_fields_matches_jax(dt):
    args = [a.astype(dt) for a in _mopitt_columns()]
    got = tv.ak_conv_mopitt_fields(*_t(args))
    want = jv.ak_conv_mopitt_fields(*_j(args))
    for name, g, w in zip(("model_vcd", "model_xcol"), got, want):
        assert g.dtype == getattr(torch, np.dtype(dt).name), name
        _assert_close(g.numpy(), w, dt, name)
    # the two masks differ on purpose: inf vcd keeps its xcol
    assert torch.isnan(got[0][0, 0]) and not torch.isnan(got[1][0, 0])
    # a non-monotone CTM column interpolates to NaN, which the level sum drops
    assert torch.isfinite(got[0][1, 4])


def _gosat_columns(seed=6, H=8, W=9, Ls=7, Lc=12):
    rng = np.random.default_rng(seed)
    sat_pmid = np.sort(rng.uniform(50, 990, (Ls, H, W)), axis=0)[::-1].copy()
    ctm_pmid = np.sort(rng.uniform(30, 1010, (Lc, H, W)), axis=0)[::-1].copy()
    prof = np.abs(rng.normal(1800, 100, (Lc, H, W)))
    aks = rng.uniform(0, 1.2, (Ls, H, W))
    apriori_profile = np.abs(rng.normal(1800, 80, (Ls, H, W)))
    pw = rng.uniform(0, 0.1, (Ls, H, W))
    x_col = np.abs(rng.normal(1800, 30, (H, W)))
    x_col[rng.random((H, W)) < 0.2] = np.nan
    x_col[0, 0] = np.inf
    x_col[0, 1:6] = 1800.0
    pw[:, 0, 1] = 0.0  # every level masked (<= 0): sums to 0, not NaN
    pw[2, 0, 2] = -0.1
    apriori_profile[:, 0, 3] = np.nan  # an all-NaN column sums to 0
    prof[4, 0, 4] = -3000.0
    aks[1, 0, 5] = np.inf
    ctm_pmid[[1, 4], 1, 0] = ctm_pmid[[4, 1], 1, 0]  # non-monotone
    sat_pmid[0, 1, 1] = 2000.0  # extrapolated below the CTM's range
    return ctm_pmid, prof, sat_pmid, aks, apriori_profile, pw, x_col


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_ak_conv_gosat_fields_matches_jax(dt):
    args = [a.astype(dt) for a in _gosat_columns()]
    got = tv.ak_conv_gosat_fields(*_t(args))
    want = jv.ak_conv_gosat_fields(*_j(args))
    _assert_close(got.numpy(), want, dt)
    assert float(got[0, 1]) == 0.0 and float(got[0, 3]) == 0.0
    assert torch.isnan(got[0, 0]) and torch.isfinite(got[1, 1])


@pytest.mark.parametrize("dt", [np.float16, np.float32, np.float64])
def test_pwv_fields_and_air_partial_column_match_jax(dt):
    rng = np.random.default_rng(7)
    pc = rng.uniform(0, 3, (5, 6, 7)).astype(dt)
    pc[:, 0, 1] = np.nan
    pc[1, 0, 2] = np.inf
    vcd = np.ones((6, 7), np.float32)
    vcd[0, 0], vcd[1, 0] = np.nan, np.inf
    got = tv.pwv_fields(torch.as_tensor(pc), torch.as_tensor(vcd))
    want = jv.pwv_fields(jnp.asarray(pc), jnp.asarray(vcd))
    # float16 inputs are computed in float32; float64 stays float64
    assert got.dtype == (torch.float64 if dt == np.float64 else torch.float32)
    assert np.asarray(want).dtype == got.numpy().dtype
    _assert_close(got.numpy(), want, np.float64 if dt == np.float64 else np.float32)
    assert float(got[0, 1]) == 0.0 and torch.isinf(got[0, 2])
    dp = rng.uniform(5, 30, (4, 3))
    np.testing.assert_allclose(tv.air_partial_column(torch.as_tensor(dp)).numpy(),
                               jv.air_partial_column(jnp.asarray(dp)), rtol=1e-15)
    np.testing.assert_allclose(tv.air_partial_column(dp), jv.air_partial_column(dp),
                               rtol=1e-15)


@pytest.mark.parametrize("kind", ["mopitt", "gosat"])
def test_granule_axis_matches_jax_vmap(kind):
    """The port's explicit leading G axis == the JAX vmap over granules."""
    cols = [(_mopitt_columns if kind == "mopitt" else _gosat_columns)(seed=s)
            for s in range(3)]
    stack = [np.stack([c[i] for c in cols]) for i in range(len(cols[0]))]
    tfn = getattr(tv, f"ak_conv_{kind}_fields")
    jfn = getattr(jv, f"ak_conv_{kind}_fields")
    got = tfn(*_t(stack))
    want = jax.vmap(jfn)(*_j(stack))
    if kind == "gosat":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.shape[0] == 3
        _assert_close(g.numpy(), w, np.float64, kind)


# ---- the month steps -------------------------------------------------------

_MONTHS = {
    "mopitt": (graft._synthetic_mopitt_month, jan.MopittMonthInputs, jan.mopitt_month_step,
               convert.mopitt_month_inputs, tan.mopitt_month_step),
    "gosat": (graft._synthetic_gosat_month, jan.GosatMonthInputs, jan.gosat_month_step,
              convert.gosat_month_inputs, tan.gosat_month_step),
    "ssmis": (graft._synthetic_ssmis_month, jan.SsmisMonthInputs, jan.ssmis_month_step,
              convert.ssmis_month_inputs, tan.ssmis_month_step),
}


def _month_outputs(kind, dt, **kw):
    """(port, jax) outputs of one month step on __graft_entry__'s synthetic
    month (G=4, H=16, W=24, Ls <= 9, Lc=12) in ``dt``."""
    make, jcls, jstep, to_port, tstep = _MONTHS[kind]
    host = make()
    fields = {f: np.asarray(getattr(host, f), dt) for f in to_port(host, "cpu")._fields}
    got = tstep(to_port(type("H", (), fields), "cpu"), bias_offset=0.1, bias_slope=0.9,
                **kw)
    want = jstep(jcls(**{k: jnp.asarray(v) for k, v in fields.items()}), bias_offset=0.1,
                 bias_slope=0.9, **kw)
    return got, want


def _assert_outputs(got, want, dt):
    got_leaves, want_leaves = list(_leaves(convert.to_numpy(got))), list(_leaves(want))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    assert len(got_leaves) == 19
    assert int(got.oi.reg_index) == int(want.oi.reg_index)
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert_parity(g, w, dt, path)


@pytest.mark.parametrize("run_oi", [True, False])
@pytest.mark.parametrize("kind,weighting", [
    ("mopitt", None), ("mopitt", "inverse_variance"), ("mopitt", "ak"),
    ("gosat", None), ("gosat", "inverse_variance"), ("gosat", "ak"),
    ("ssmis", None), ("ssmis", "inverse_variance")])
def test_month_step_matches_jax_every_leaf(kind, weighting, run_oi):
    got, want = _month_outputs(kind, np.float64, weighting=weighting, run_oi=run_oi)
    _assert_outputs(got, want, np.float64)
    if not run_oi:
        assert int(got.oi.reg_index) == -1 and int(got.innovation.n) == 0
    elif kind == "gosat":
        # the OI ran on the xcol pair: xb - aux2 is the increment
        inc = convert.to_numpy(got.oi.increment)
        np.testing.assert_allclose(convert.to_numpy(got.oi.xb) - convert.to_numpy(got.aux2),
                                   inc, rtol=1e-9, atol=1e-9 * np.nanmax(np.abs(inc)),
                                   equal_nan=True)
    if kind == "gosat":
        assert torch.isnan(got.ctm_vcd).all()
    if kind == "ssmis":
        assert torch.isnan(got.aux1).all() and torch.isnan(got.aux2).all()


@pytest.mark.parametrize("kind", ["mopitt", "gosat", "ssmis"])
def test_month_step_return_granules_matches_jax(kind):
    (got, gd), (want, wd) = _month_outputs(kind, np.float64, return_granules=True)
    _assert_outputs(got, want, np.float64)
    assert gd._fields == wd._fields == ("vcd", "ctm_vcd", "uncertainty")
    for name in gd._fields:
        assert getattr(gd, name).shape == (4, 16, 24)
        assert_parity(getattr(gd, name).numpy(), getattr(wd, name), np.float64, name)


@pytest.mark.parametrize("kind", ["mopitt", "gosat", "ssmis"])
def test_month_step_float32_keeps_the_knee(kind):
    """The same months in float32 (the dtype the card runs them in): the
    knee and the NaN patterns of the JAX step, fields at rtol 2e-4 / atol
    2e-5 of the field's largest magnitude (the JAX package's own
    fused-vs-staged bound, tests/test_fused_month.py)."""
    got, want = _month_outputs(kind, np.float32)
    assert int(got.oi.reg_index) == int(want.oi.reg_index)
    for (path, g), (_, w) in zip(_leaves(convert.to_numpy(got)), _leaves(want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.array_equal(np.isnan(g), np.isnan(w)), path
        if np.isfinite(w).any():
            np.testing.assert_allclose(g, w, rtol=2e-4, equal_nan=True, err_msg=path,
                                       atol=2e-5 * np.nanmax(np.abs(w)))


def test_ak_weighting_needs_averaging_kernels():
    from oisat_tpu_torch import entry

    with pytest.raises(ValueError, match="averaging-kernel"):
        tan.ssmis_month_step(convert.ssmis_month_inputs(graft._synthetic_ssmis_month(), "cpu"),
                             weighting="ak")
    with pytest.raises(ValueError, match="unknown weighting"):
        tan.full_month_step(entry.synthetic_full_month("cpu"), weighting="median")


def test_datamodel_twins_have_the_jax_fields_and_stack_granules_matches():
    """satellite_opt / satellite_ssmis carry the JAX containers' field names
    in their order, and stack_granules skips None as the JAX one does."""
    import dataclasses

    from oisat_tpu import datamodel as jdm
    from oisat_tpu_torch import datamodel as tdm

    for name in ("satellite_amf", "satellite_opt", "satellite_ssmis", "ctm_model"):
        got = [f.name for f in dataclasses.fields(getattr(tdm, name))]
        want = [f.name for f in dataclasses.fields(getattr(jdm, name))]
        assert got == want, name
    rng = np.random.default_rng(0)
    grans = [jdm.satellite_ssmis(vcd=rng.normal(size=(3, 4)), uncertainty=rng.random((3, 4)))
             for _ in range(3)]
    grans.insert(1, None)
    ported = [None if g is None else convert.satellite_ssmis_from(g) for g in grans]
    got = tdm.stack_granules(ported, ("vcd", "uncertainty"))
    want = jdm.stack_granules(grans, ("vcd", "uncertainty"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (3, 3, 4) and np.array_equal(got[k], want[k])
