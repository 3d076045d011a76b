"""The port's benchmark rows that write product files (``bench_tempo``,
``bench_tropomi``, ``bench_campaign_prefetch`` of ``oisat_tpu_torch.bench``)
on the CPU, beside tests/test_torch_bench.py (split off so that the test
workers run the two files side by side).

The bench's TROPOMI and TEMPO files (its writers, bitwise bench.py's: see
tests/test_torch_bench.py) go through both job runners with the parity
builders (``parity: true``; smaller swaths than the rows write), held to
each other by tests/test_torch_job.py's diag comparison; each row prints one
line with bench.py's five keys on the CPU; without h5py each row raises
ImportError naming it, and ``--all`` leaves the three out with one stderr
line each.
"""

import importlib.util
import sys

import numpy as np
import pytest
import torch

from oisat_tpu_torch import bench as B
from oisat_tpu_torch.run import job as port_job
from tests.test_torch_bench import _lines
from tests.test_torch_job import _assert_diag_equal, _jax_module

torch.set_num_threads(1)


def _job_pair(tmp_path, monkeypatch, capsys, sensor, year, month, tag):
    """Both job runners (parity builders) on the files in ``tmp_path``."""
    monkeypatch.chdir(tmp_path)
    for side, run_month in (("jax", _jax_module("job").run_month), ("port", port_job.run_month)):
        ctrl = B._bench_job_ctrl(tmp_path, sensor, year * 100 + month, "cpu")
        ctrl.update(parity=True, output_nc_dir=str(tmp_path / side / "diag"),
                    output_pdf_dir=str(tmp_path / side / "report"))
        run_month(ctrl, year, month)
    capsys.readouterr()
    return _assert_diag_equal(tmp_path / "port" / "diag" / f"{tag}.nc",
                              tmp_path / "jax" / "diag" / f"{tag}.nc")


def test_tropomi_job_month_on_the_bench_files_matches_jax(tmp_path, monkeypatch, capsys):
    (tmp_path / "ctm").mkdir()
    (tmp_path / "sat").mkdir()
    B._write_bench_gmi_pair(tmp_path / "ctm" / "MERRA2_GMI.tavg3_3d_met_Nv.20190715.nc4",
                            tmp_path / "ctm" / "MERRA2_GMI.tavg3_3d_tac_Nv.20190715.nc4",
                            201907, 15)
    B._write_bench_tropomi(tmp_path / "sat" / "S5P_OFFL_L2__NO2____20190701.nc", 1,
                           ny=120, nx=60, seed=0)
    fields = _job_pair(tmp_path, monkeypatch, capsys, "TROPOMI", 2019, 7, "NO2_201907")
    assert np.isfinite(fields["ctm_averaged_vcd_posterior"]).sum() > 100
    line = B.bench_tropomi(orbits=1, device="cpu")
    _lines(capsys, 1)
    assert line["metric"] == "tropomi_month"


def test_tempo_job_hour_on_the_bench_files_matches_jax(tmp_path, monkeypatch, capsys):
    (tmp_path / "ctm").mkdir()
    (tmp_path / "sat").mkdir()
    B._write_bench_gmi_pair(tmp_path / "ctm" / "MERRA2_GMI.tavg3_3d_met_Nv.20230901.nc4",
                            tmp_path / "ctm" / "MERRA2_GMI.tavg3_3d_tac_Nv.20230901.nc4",
                            202309, 1)
    B._write_bench_tempo(tmp_path / "sat" / "TEMPO_NO2_L2_20230901T000000.nc", 0,
                         ny=180, nx=120, seed=100)
    fields = _job_pair(tmp_path, monkeypatch, capsys, "TEMPO", 2023, 9, "NO2_202309_0UTC")
    assert np.isfinite(fields["ctm_averaged_vcd_posterior"]).sum() > 100
    line = B.bench_tempo(days=1, hours=1, device="cpu")
    _lines(capsys, 1)
    assert line["metric"] == "tempo_month_24h" and line["detail"]["diag_files"] == 1


def test_campaign_row_prints_its_line(capsys):
    line = B.bench_campaign_prefetch(months=1, orbits=1, repeats=1, device="cpu")
    _lines(capsys, 1)
    assert line["metric"] == "campaign_prefetch" and len(line["detail"]["pairs"]) == 1


@pytest.mark.parametrize("row", ["bench_tempo", "bench_tropomi", "bench_campaign_prefetch"])
def test_file_rows_need_h5py(monkeypatch, capsys, row):
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py" else _find_spec(name, *a))
    with pytest.raises(ImportError, match="h5py"):
        getattr(B, row)(device="cpu")
    assert not B.file_rows_runnable()
    err = capsys.readouterr().err.splitlines()
    assert [ln.split(":")[1].split()[0] for ln in err] == [m for m, _ in B.FILE_ROWS]
    assert all("h5py" in ln for ln in err)


_find_spec = importlib.util.find_spec
