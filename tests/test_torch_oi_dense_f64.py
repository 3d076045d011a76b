"""The dense full-OI scan in float64 (``oisat_tpu_torch.ops.oi_full.
oi_full_dense_scan_f64``, which ``_oi_full_dense_branch`` runs on every
device; on a card its C comes from ``csrc/covariance.cu``'s float64
kernel, here from the plain version), at a small size against the
benchmark's plain float64 reference
(``benchmark/reference_full_oi.full_oi``: one ``eigh`` of R^-1/2 B R^-1/2,
the exact mean-AK curve, a blocked Cholesky).

The domains are regional 0.5 x 0.625 deg windows of 1,200-1,440 cells in
the tight regime of a monthly average, sigma_b / sigma_o ~ 100.  There the
float32 scan's curve (the JAX package's, kept as its twin) is off the
float64 one by 20-40 times the steps between its neighbouring factors, so
its knee is rounding noise: 0.5-1.1 here, moving with the number of CPU
threads, against the reference's 1.1.  The tests assert the size of that
error, which does not move.

Tolerance: 1e-7 of the field's largest magnitude, for the scan alone and
for the branch after its float64 tail.  Each side is float64, one through
the eigenvectors of C (the scan's solve and posterior diagonal) or a
Cholesky factor of A (the tail), the other through a Cholesky factor, of
systems whose eigenvalues spread over ~1e7 (C) and more (A); float64
rounding times that spread gives the ~3e-9 read here, so 1e-7 leaves a
factor 30.  The float32 scan misses by 1e-2 to 1e-1.
"""

import numpy as np
import pytest
import torch

from benchmark.reference_full_oi import full_oi
from oisat_tpu_torch.ops import oi_full as T
from oisat_tpu_torch.utils import profiling

torch.set_num_threads(1)

GRID = T.regularization_grid()
L_KM = 300.0
FIELDS = ("xb", "averaging_kernel", "increment", "error")


def _domain(H=30, W=40, seed=0, ratio=100.0):
    """xa, y, sigma_b, sigma_o, lat, lon on an H x W window of the
    MERRA2-GMI pitch over the western US; sigma_b = 0.5 xa (a 50% CTM
    error) and sigma_b / sigma_o drawn around ``ratio``."""
    rng = np.random.default_rng(seed)
    lon, lat = np.meshgrid(-110.0 + 0.625 * np.arange(W), 30.0 + 0.5 * np.arange(H))
    xa = np.abs(2.0 + 0.5 * np.sin(np.radians(lon) * 7.0) + 0.2 * rng.standard_normal((H, W)))
    sb = 0.5 * xa
    so = sb / np.abs(rng.normal(ratio, 0.25 * ratio, (H, W)))
    y = xa + 0.5 * sb * rng.standard_normal((H, W))
    return xa, y, sb, so, lat, lon


def _reference(args):
    xa, y, sb, so, lat, lon = args
    *fields, info = full_oi(*(torch.as_tensor(a) for a in (xa, y, sb, so)), lat, lon, L_KM,
                            torch.float64)
    assert info["curve"] == "exact"
    return [f.numpy().ravel() for f in fields], info


def _close(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    np.testing.assert_allclose(got, want, rtol=0.0, atol=tol * np.nanmax(np.abs(want)),
                               err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float64_scan_picks_the_reference_knee_and_fields(seed):
    args = _domain(seed=seed)
    want, info = _reference(args)
    vec = [torch.as_tensor(a.ravel()) for a in args]
    *got, knee, curve = T.oi_full_dense_scan_f64(*vec, L_KM, GRID)
    assert knee == info["knee"]
    assert curve.dtype == torch.float64 and curve.shape == (GRID.size,)
    for name, g, w in zip(FIELDS, got, want):
        assert g.dtype == torch.float64, name
        _close(g.numpy(), w, 1e-7, name)
    # the JAX package's float32 curve on the same cells: its error is many
    # times the steps the knee is read from (20-40 at the median here)
    f32 = T.oi_full_dense_scan(*(v.float() for v in vec), L_KM, GRID.astype(np.float32))[5]
    c64 = curve.numpy()
    assert np.median(np.abs(f32.numpy() - c64)) > 5.0 * np.median(np.abs(np.diff(c64)))


def _recorded(monkeypatch):
    """The list the float64 scan's calls record their inputs' dtype in."""
    calls = []
    scan = T.oi_full_dense_scan_f64

    def recorded(*a, **k):
        calls.append(a[0].dtype)
        return scan(*a, **k)

    monkeypatch.setattr(T, "oi_full_dense_scan_f64", recorded)
    return calls


@pytest.mark.parametrize("seed", [0, 3])
def test_card_route_takes_the_float64_scan_and_the_reference_factor(monkeypatch, seed):
    """The dense branch as a card runs it (here on the CPU): the float64
    scan, its factor the reference's, the conditioning-gated float64 tail,
    and the four fields at the reference's to 1e-7."""
    args = _domain(H=32, W=45, seed=seed)
    want, info = _reference(args)
    calls = _recorded(monkeypatch)
    cp = T.compact(*args)
    clock = profiling.StageClock(None, "cpu")
    *fields, diag = T._oi_full_dense_branch(cp, L_KM, True, torch.device("cpu"), clock)
    assert calls == [torch.float64]
    assert diag["reg"] == info["reg"]
    assert diag["solver"] == "dense+direct_f64_dev" and diag["exact_diag"]
    assert diag["f64_resid"] <= T.DEVICE_EXACT_RESID_GATE
    for name, g, w, s in zip(FIELDS, fields, want, (cp.scale, 1.0, cp.scale, cp.scale)):
        _close(g * s, w, 1e-7, name)


def test_dense_counters_and_spans_only_while_tracing():
    """``oi_full.dense_cells`` (the valid cells) and ``oi_full.dense_tails``
    (1: the tail ran) and the dense stages' spans land in the registry with
    tracing on; with it off a call records nothing."""
    args = _domain(H=12, W=16, seed=4)
    n = T.compact(*args).idx.size
    profiling.take()
    profiling.enable(False)
    T.oi_full(*args, L_KM, regularization_on=True, device="cpu")
    assert profiling.take() == ([], {})
    profiling.enable(True)
    try:
        res = T.oi_full(*args, L_KM, regularization_on=True, device="cpu")
        spans, counters = profiling.take()
    finally:
        profiling.enable(False)
    assert res.info["solver"] == "dense+direct_f64_dev"
    assert counters["oi_full.dense_cells"] == n
    assert counters["oi_full.dense_tails"] == 1
    names = {s[0] for s in spans}
    for stage in ("covariance", "eigh", "scan_gemms", "knee", "update", "pull", "tail",
                  "tail_resid"):
        assert f"oi_full.{stage}" in names, stage


def test_mild_month_counts_its_cells_and_no_tail():
    args = _domain(H=12, W=16, seed=5, ratio=2.0)
    profiling.take()
    profiling.enable(True)
    try:
        res = T.oi_full(*args, L_KM, regularization_on=True, device="cpu")
        _, counters = profiling.take()
    finally:
        profiling.enable(False)
    assert res.info is None
    assert counters["oi_full.dense_cells"] == T.compact(*args).idx.size
    assert "oi_full.dense_tails" not in counters


def test_the_card_route_copies_its_inputs_once(monkeypatch):
    """The float64 scan's six vectors reach the device in one copy; the
    tail then copies its own four (unit vectors, sigma_b, sigma_o^2, d)."""
    copies = []
    args = _domain(H=12, W=16, seed=6)
    to_device = T.to_device
    monkeypatch.setattr(T, "to_device", lambda x, device, dtype=None: (
        copies.append(np.shape(x)), to_device(x, device, dtype))[1])
    cp = T.compact(*args)
    T._oi_full_dense_branch(cp, L_KM, True, torch.device("cpu"),
                            profiling.StageClock(None, "cpu"))
    n = cp.idx.size
    assert copies == [(6, n), (n, 3), (n,), (n,), (n,)]
