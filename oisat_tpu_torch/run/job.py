"""Month-job runner of the port: ``python -m oisat_tpu_torch.run.job <year> <month>``
with ``control.yml`` in the current directory.

Twin of ``run/job.py`` (reference run/job.py:1-86) on
:class:`oisat_tpu_torch.driver.oisatgmi`: sensor-specific pipeline dispatch
(TEMPO loops 24 UTC hours with per-hour fault tolerance; MOPITT / GOSAT use
the averaging-kernel convolution; SSMIS computes PWV; the rest recalculate
AMFs), month-end date arithmetic included.  It reads the same control keys,
so every ``run/control_*.yml`` runs unchanged.  What differs from the twin:

* ``parity: true`` selects the scipy weight builders by passing
  ``fast_swath=False`` to ``read_data``; no environment variable is set or
  read (the port always runs the full-precision numerics);
* an optional ``device`` key names the device (default: the card; a job
  without one raises, and the CPU is used only when the key says ``cpu``);
* ``mesh_devices`` (:func:`mesh_from_ctrl`) is resolved before any file is
  read: ``all`` or an integer N takes that many cards (more than the host
  has raises), and with ``device: cpu`` N logical CPU shards (``all``: one),
  and made the process's regrid mesh;
* the reader keywords are built by one helper (:func:`reader_kwargs`) for
  :func:`read_month` and :func:`run_month`;
* there is no compile census: nothing is compiled per shape.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from oisat_tpu_torch.driver import oisatgmi
from oisat_tpu_torch.parallel.mesh import make_mesh
from oisat_tpu_torch.regridder import set_regrid_mesh

__all__ = ["load_control", "fused_eligible", "mesh_from_ctrl", "month_window",
           "month_setup", "reader_kwargs", "read_month", "run_month"]


def load_control(path="./control.yml"):
    import yaml

    with open(path, "r") as stream:
        return yaml.safe_load(stream)


def fused_eligible(ctrl) -> bool:
    """Whether the fused month path applies to this control file: the
    ``fused_month`` switch.  ``save_daily``, ``averaging_weighting``,
    ``desroziers_iterations`` and ``oi_method: full`` all compose with it;
    months the fused step cannot express (mixed granule shapes or kinds, no
    scattering weights) fall back at run time via ValueError."""
    return bool(ctrl.get("fused_month"))


def mesh_from_ctrl(ctrl):
    """The mesh the ``mesh_devices`` key asks for (the twin's
    ``mesh_from_ctrl``): absent or 1 runs single-device (None); ``all``
    every visible card and an integer N that many (raising when the host has
    fewer); with the ``device: cpu`` key N logical shards of the CPU, and
    ``all`` one."""
    md = ctrl.get("mesh_devices")
    if not md or md == 1:
        return None
    device = ctrl.get("device")
    if device is not None and torch.device(device).type == "cpu":
        n = 1 if md == "all" else int(md)
        return make_mesh(n, devices=["cpu"] * n)
    return make_mesh(None if md == "all" else int(md))


def month_window(year: int, month: int):
    start = f"{year}-{month:02}-01"
    if month != 12:
        end = f"{year}-{month + 1:02}-01"
    else:
        end = f"{year + 1}-01-01"
    return start, end


def month_setup(ctrl):
    """Run before any file is read: resolve the mesh once
    (:func:`mesh_from_ctrl`; an over-request fails here, not after the
    read) and make it the process's regrid mesh
    (:func:`~oisat_tpu_torch.regridder.set_regrid_mesh`), so the readers'
    regrids run over it.  Returns the mesh (None: single device)."""
    mesh = mesh_from_ctrl(ctrl)
    set_regrid_mesh(mesh)
    return mesh


def reader_kwargs(ctrl) -> dict:
    """The ``read_data`` keywords a control file implies, for
    :func:`read_month` and the TEMPO hour loop alike.  FREE runs pass
    ``read_ak`` as the string "False", as the reference job runner does
    (reference run/job.py:21-23; ``read_data`` normalises it)."""
    return dict(
        averaging=ctrl["ctm_avg"],
        read_ak="False" if ctrl["ctm_name"] == "FREE" else ctrl["read_AK"],
        trop=ctrl["troposphere_only"], num_job=int(ctrl["num_job"]),
        mcip_dir=Path(ctrl.get("mcip_dir") or "."),
        device=ctrl.get("device"), fast_swath=not ctrl.get("parity"))


def _read(ctrl, year: int, month: int, **kw):
    obj = oisatgmi()
    gas, sensor = ctrl["gas"], ctrl["sensor"]
    obj.read_data(ctrl["ctm_name"], Path(ctrl["ctm_dir"]), gas, ctrl["ctm_freq"],
                  sensor + "_" + gas, Path(ctrl["sat_dir"]), f"{year}{month:02}",
                  **reader_kwargs(ctrl), **kw)
    return obj


def read_month(ctrl, year: int, month: int):
    """Reader construction + ``read_data`` (which regrids on the device) for
    one non-TEMPO month.  The campaign prefetch seam: calling this for month
    k+1 while month k's report / netCDF tail runs overlaps the next read
    with host-only work.  Returns the session ready for :func:`_analyze`."""
    month_setup(ctrl)
    if ctrl["sensor"] == "TEMPO":
        raise ValueError("TEMPO months read per-hour inside run_month; "
                         "prefetch is not applicable")
    return _read(ctrl, year, month)


def run_month(ctrl, year: int, month: int, pre_read=None, prefetch_hook=None,
              on_hour=None):
    """One month end to end.  ``pre_read``: a session from
    :func:`read_month` (campaign prefetch); skips the read.
    ``prefetch_hook``: zero-argument callable invoked after THIS month's
    analysis, before the report / netCDF host tail; the campaign uses it to
    start month k+1's read in its prefetch thread.  ``on_hour``: TEMPO only,
    called with each UTC hour before that hour's sub-pipeline."""
    mesh = month_setup(ctrl)
    gas, sensor = ctrl["gas"], ctrl["sensor"]
    start, end = month_window(year, month)

    if sensor == "TEMPO":
        for hour in range(0, 24):
            if on_hour is not None:
                on_hour(hour)
            try:
                obj = _read(ctrl, year, month, tempo_hour=hour)
                # each TEMPO hour is just another fusable month of granules
                _analyze(obj, ctrl, sensor, gas, start, end,
                         savedaily=("./diag_mat/", f"{year}{month:02}_{hour}UTC"),
                         mesh=mesh)
                tag = f"{gas}_{year}{month:02}_{hour}UTC"
                obj.reporting(tag, gas, ctrl["output_pdf_dir"])
                obj.write_to_nc(tag, ctrl["output_nc_dir"])
            except Exception as e:
                print(f"Error processing hour {hour}: {e}")
        return

    obj = pre_read if pre_read is not None else read_month(ctrl, year, month)
    _analyze(obj, ctrl, sensor, gas, start, end,
             savedaily=(ctrl["output_nc_dir"], f"{year}_{month:02}"), mesh=mesh)
    if prefetch_hook is not None:
        prefetch_hook()
    tag = f"{gas}_{year}{month:02}"
    obj.reporting(tag, gas, ctrl["output_pdf_dir"])
    obj.write_to_nc(tag, ctrl["output_nc_dir"])


def _analyze(obj, ctrl, sensor, gas, start, end, savedaily, mesh=None):
    """Fused-or-staged analysis for one batch of granules (a month, or one
    TEMPO UTC hour).  The fused path runs the observation operator +
    averaging + bias + OI as one month step on the granules' device; months
    it cannot express (mixed granule shapes, no scattering weights) raise
    ValueError there and run the staged pipeline instead.  ``oi_method:
    full`` selects the distance-decay background covariance with
    ``length_scale_km`` on either path.  ``mesh``: the one :func:`run_month`
    resolved; a direct caller may omit it (the control file's is used)."""
    if mesh is None:
        mesh = mesh_from_ctrl(ctrl)
    oi_method = ctrl.get("oi_method", "scalar")
    if oi_method not in ("scalar", "full"):
        raise ValueError(f"oi_method must be 'scalar' or 'full', got {oi_method!r}")
    length_scale_km = float(ctrl.get("length_scale_km", 300.0))
    oi_kw = dict(length_scale_km=length_scale_km,
                 desroziers_iterations=ctrl.get("desroziers_iterations", 0),
                 desroziers_bins=ctrl.get("desroziers_bins", 1))
    if fused_eligible(ctrl):
        try:
            obj.analyze_month_fused(
                sensor, gas, start, end, error_ctm=ctrl["ctm_error"],
                weighting=ctrl.get("averaging_weighting"),
                save_daily=(savedaily if ctrl.get("save_daily") else None),
                oi_method=oi_method, mesh=mesh, **oi_kw)
            return
        except ValueError as e:
            print(f"fused month not applicable ({e}); running staged pipeline")
        obj.settle_device_granules()
    if sensor in ("MOPITT", "GOSAT"):
        obj.conv_ak(sensor)
    elif sensor == "SSMIS":
        obj.cal_pwv()
    else:
        obj.recal_amf()
    if ctrl.get("save_daily"):
        obj.savedaily(savedaily[0], gas, savedaily[1])
    obj.average(start, end, gasname=gas, weighting=ctrl.get("averaging_weighting"))
    obj.bias_correct(sensor, gas)
    obj.oi(sensor, error_ctm=ctrl["ctm_error"], method=oi_method, mesh=mesh, **oi_kw)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__.split("\n\n")[0], file=sys.stderr)
        return 2
    run_month(load_control(), int(argv[0]), int(argv[1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
