"""The port's vertical operators (oisat_tpu_torch.ops.vertical) against their
JAX twins (oisat_tpu.ops.vertical) on the same numpy inputs, on the CPU.

Tolerances: float64 rtol 1e-10 / atol 1e-12, float32 rtol 1e-5 / atol 1e-6;
NaN patterns identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oisat_tpu.ops import vertical as jv
from oisat_tpu_torch.ops import vertical as tv
from tests.test_vertical import column_setup
from tests.test_torch_oi import assert_parity

torch.set_num_threads(1)



def _columns(seed, Ls=10, Lt=7, H=5, W=6, descending=True, bad=True):
    rng = np.random.default_rng(seed)
    xp = np.sort(rng.uniform(0, 10, (Ls, H, W)), axis=0)
    if descending:
        xp = xp[::-1].copy()
    fp = rng.standard_normal((Ls, H, W))
    xq = rng.uniform(-2, 12, (Lt, H, W))
    if bad:
        xp[3, 0, 0] = np.nan  # NaN abscissa
        xp[:, 1, 1] = xp[::-1, 1, 1] if descending else xp[:, 1, 1]
        xp[2, 1, 1], xp[5, 1, 1] = xp[5, 1, 1], xp[2, 1, 1]  # non-monotonic
        xp[0, 2, 2] = np.inf  # inf abscissa
        xq[0, 3, 3] = np.nan  # NaN query
        xp[4:6, 4, 4] = xp[4, 4, 4]  # a flat step stays monotonic
    return xp, fp, xq


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("extrapolate", [True, False])
def test_interp_linear_batched_matches_jax(dt, descending, extrapolate):
    xp, fp, xq = (a.astype(dt) for a in _columns(1, descending=descending))
    got = tv.interp_linear_batched(torch.as_tensor(xp), torch.as_tensor(fp),
                                   torch.as_tensor(xq), extrapolate)
    want = jv.interp_linear_batched(jnp.asarray(xp), jnp.asarray(fp), jnp.asarray(xq),
                                    extrapolate)
    assert_parity(got.numpy(), want, dt)
    # the bad columns are NaN as a whole (vertical.py:102-115)
    assert torch.isnan(got[:, 0, 0]).all() and torch.isnan(got[:, 2, 2]).all()
    assert torch.isnan(got[:, 1, 1]).all()


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("with_trop", [True, False])
def test_amf_recal_fields_matches_jax(dt, with_trop):
    sat_pmid, sat_sw, ctm_pmid, dp, prof, vcd, amf_old, trop = column_setup()
    pc = np.asarray(jv.partial_column(dp, prof))
    args = [a.astype(dt) for a in (sat_pmid, sat_sw, ctm_pmid, pc, trop, vcd, amf_old)]
    got = tv.amf_recal_fields(*(torch.as_tensor(a) for a in args), with_trop)
    want = jv.amf_recal_fields(*(jnp.asarray(a) for a in args), with_trop)
    for name, g, w in zip(("new_amf", "vcd_corr", "model_vcd"), got, want):
        assert_parity(g.numpy(), w, dt, name)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_amf_recal_granule_axis_matches_jax_vmap(dt):
    """The port's explicit leading G axis == the JAX vmap over granules.
    The satellite columns span the CTM's pressures, so no level is
    extrapolated and the float32 level sums have no cancellation."""
    cols = [column_setup(seed=s, H=6, W=7, Ls=9, Lc=14) for s in range(3)]
    stack = [np.stack([c[i] for c in cols]) for i in range(8)]
    sat_pmid, sat_sw, ctm_pmid, dp, prof, vcd, amf_old, trop = stack
    sat_pmid[:, 0], sat_pmid[:, -1] = 1020.0, 20.0
    pc = dp * prof * 0.02
    args = [a.astype(dt) for a in (sat_pmid, sat_sw, ctm_pmid, pc, trop, vcd, amf_old)]
    got = tv.amf_recal_fields(*(torch.as_tensor(a) for a in args), True)
    want = jax.vmap(lambda *a: jv.amf_recal_fields(*a, True))(*(jnp.asarray(a) for a in args))
    for name, g, w in zip(("new_amf", "vcd_corr", "model_vcd"), got, want):
        assert_parity(g.numpy(), w, dt, name)


@pytest.mark.parametrize("with_trop", [True, False])
def test_amf_recal_noak_fields_matches_jax(with_trop):
    _, _, ctm_pmid, dp, prof, vcd, _, trop = column_setup(2)
    pc = np.asarray(jv.partial_column(dp, prof))
    got = tv.amf_recal_noak_fields(*(torch.as_tensor(a) for a in (ctm_pmid, pc, trop, vcd)),
                                   with_trop)
    want = jv.amf_recal_noak_fields(*(jnp.asarray(a) for a in (ctm_pmid, pc, trop, vcd)),
                                    with_trop)
    assert_parity(got.numpy(), want, np.float64)


def test_partial_column_and_constants_match_jax():
    assert (tv.MAIR, tv.GRAV, tv.N_A) == (jv.MAIR, jv.GRAV, jv.N_A)
    rng = np.random.default_rng(3)
    dp, q = rng.uniform(5, 30, (4, 3)), rng.uniform(0, 2, (4, 3))
    assert_parity(tv.partial_column(torch.as_tensor(dp), torch.as_tensor(q)).numpy(),
           jv.partial_column(jnp.asarray(dp), jnp.asarray(q)), np.float64)
    assert_parity(tv.partial_column(dp, q), jv.partial_column(jnp.asarray(dp), jnp.asarray(q)),
           np.float64)
