"""The port's batch submitters (oisat_tpu_torch.run.job_submitter and its two
drop-in shims) against ``run/job_submitter.py`` and its shims, on the CPU.

The same control file gives the same job files in the same order, line for
line, except the job line, which runs ``-m oisat_tpu_torch.run.job``; the
reference's cartesian month set is the twin's on year-crossing windows; the
shims, run as modules with a stand-in scheduler on ``PATH``, write and hand
over the twin shims' files; and ``submit`` raises ImportError naming yaml
where yaml is absent.  Exact everywhere: these are strings and integers.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

from oisat_tpu_torch.run import job_submitter as port
from oisat_tpu_torch.run.campaign import month_list

REPO = Path(__file__).resolve().parent.parent


def _load_twin():
    spec = importlib.util.spec_from_file_location(
        "job_submitter", REPO / "run" / "job_submitter.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


twin = _load_twin()

WINDOWS = [("2005-11", "2006-02"), ("2019-03", "2019-07"), ("2018-12", "2019-01")]


def _control(folder: Path, start: str, end: str, debug: bool) -> Path:
    folder.mkdir(parents=True, exist_ok=True)
    path = folder / "control.yml"
    path.write_text(f"python_bin: /usr/bin/python3\nnum_job: 12\ndebug: {str(debug).lower()}\n"
                    f"start_date: {start}\nend_date: {end}\nsensor: OMI\n")
    return path


def _job_files(folder: Path, scripts) -> list:
    return [(s, (folder / s).read_text().splitlines()) for s in scripts]


def _assert_same_but_the_job_line(got: list, want: list, python_bin: str) -> None:
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert len(g) == len(w), path
        year, month = path[len("./jobs/job_"):-len(".j")].split("_")
        for i, (a, b) in enumerate(zip(g, w)):
            if b == f"{python_bin} ./job.py {year} {month}":
                assert a == f"{python_bin} -m oisat_tpu_torch.run.job {year} {month}", path
            else:
                assert a == b, (path, i)
        assert sum(line.endswith(f" {year} {month}") for line in g) == 1, path


@pytest.mark.parametrize("start,end", WINDOWS)
def test_reference_month_set_is_the_twins(start, end):
    got = port.month_list_reference(start, end)
    assert got == twin.month_list_reference(start, end)
    assert port.month_list(start, end) == twin.month_list(start, end) == month_list(start, end)
    if start == "2005-11":  # the year-crossing quirk, kept verbatim
        assert len(got) == 24 and (2005, 1) in got and (2006, 12) in got


@pytest.mark.parametrize("reference_months", [False, True])
@pytest.mark.parametrize("scheduler", ["sbatch", "qsub"])
def test_dry_run_writes_the_twins_job_files(tmp_path, monkeypatch, scheduler, reference_months):
    out = {}
    for name, mod in (("twin", twin), ("port", port)):
        folder = tmp_path / name
        ctrl = _control(folder, "2005-11", "2006-02", debug=(scheduler == "qsub"))
        monkeypatch.chdir(folder)
        scripts = mod.submit(scheduler=scheduler, control=str(ctrl), dry_run=True,
                             reference_months=reference_months)
        out[name] = _job_files(folder, scripts)
    assert len(out["port"]) == (24 if reference_months else 4)
    _assert_same_but_the_job_line(out["port"], out["twin"], "/usr/bin/python3")


@pytest.mark.parametrize("scheduler", ["sbatch", "qsub"])
def test_shim_modules_submit_the_twins_files(tmp_path, scheduler):
    """``python -m oisat_tpu_torch.run.job_submitter_<scheduler>`` against
    ``python run/job_submitter_<scheduler>.py``, each in its own folder with a
    stand-in scheduler on PATH that records the file it is handed."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / scheduler
    fake.write_text('#!/bin/sh\necho "$1" >> submitted.txt\n')
    fake.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=str(REPO))
    out = {}
    for name, cmd in (("twin", [sys.executable, str(REPO / "run" / f"job_submitter_{scheduler}.py")]),
                      ("port", [sys.executable, "-m", f"oisat_tpu_torch.run.job_submitter_{scheduler}"])):
        folder = tmp_path / name
        _control(folder, "2018-12", "2019-01", debug=False)
        proc = subprocess.run(cmd, cwd=folder, env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        submitted = (folder / "submitted.txt").read_text().split()
        out[name] = _job_files(folder, submitted)
    assert len(out["port"]) == 24  # months 1..12 of 2018 and 2019: the reference's set
    _assert_same_but_the_job_line(out["port"], out["twin"], "/usr/bin/python3")


def test_scripts_are_the_twins_but_the_job_line():
    for debug in (False, True):
        got = port.sbatch_script("py", 8, 2019, 7, debug=debug).splitlines()
        want = twin.sbatch_script("py", 8, 2019, 7, debug=debug).splitlines()
        assert got[:-1] == want[:-1] and got[-1] == "py -m oisat_tpu_torch.run.job 2019 7"
        got = port.qsub_script("py", 2019, 7, debug=debug).splitlines()
        want = twin.qsub_script("py", 2019, 7, debug=debug).splitlines()
        assert got[:-1] == want[:-1] and got[-1] == "py -m oisat_tpu_torch.run.job 2019 7"


def test_submit_without_yaml_raises_import_error_naming_it(tmp_path, monkeypatch):
    ctrl = _control(tmp_path, "2019-07", "2019-07", debug=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="yaml"):
        port.submit(control=str(ctrl), dry_run=True)
    assert not (tmp_path / "jobs").exists()
