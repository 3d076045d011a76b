"""Batch-job emitters: one SLURM/PBS job per (year, month) of the port.

Twin of ``run/job_submitter.py:18-124`` (reference
run/job_submitter_sbatch.py:45-68, run/job_submitter_qsub.py:47-71): the
same scripts, line for line, with the reference's resource shape (170 GB /
12 h SLURM, 3 h PBS), except the job line, which runs the port's job runner
as a package module: ``{python_bin} -m oisat_tpu_torch.run.job {year}
{month}`` (the twin's is ``./job.py``).  The calendar ``month_list`` is
:mod:`oisat_tpu_torch.run.campaign`'s; ``control.yml`` is read with
``run.job.load_control``, so a machine without yaml raises ImportError
naming it.

Usage: python -m oisat_tpu_torch.run.job_submitter [sbatch|qsub]
       (the drop-in shims: python -m oisat_tpu_torch.run.job_submitter_sbatch,
       python -m oisat_tpu_torch.run.job_submitter_qsub)
"""

from __future__ import annotations

import datetime
import os

from oisat_tpu_torch.run.campaign import month_list
from oisat_tpu_torch.run.job import load_control

__all__ = ["month_list", "month_list_reference", "qsub_script", "sbatch_script", "submit"]

JOB_LINE = "{python_bin} -m oisat_tpu_torch.run.job {year} {month}"


def month_list_reference(startdate: str, enddate: str):
    """The reference's month set: cartesian product of the month range and
    the year range touched by the window (reference
    run/job_submitter_sbatch.py:29-48) -- wrong across year boundaries
    (2005-11 .. 2006-02 gives all 24 months of 2005 and 2006, 20 of them
    outside the window),
    kept verbatim so the drop-in shims emit the same job files."""
    start = datetime.date(int(startdate[0:4]), int(startdate[5:7]), 1)
    end = datetime.date(int(enddate[0:4]), int(enddate[5:7]), 26)
    months, years = [], []
    d = start
    while d < end:
        months.append(d.month)
        years.append(d.year)
        d += datetime.timedelta(days=1)
    out = []
    for year in range(min(years), max(years) + 1):
        for month in range(min(months), max(months) + 1):
            out.append((year, month))
    return out


def sbatch_script(python_bin, num_job, year, month, debug=False):
    lines = [
        "#!/bin/bash",
        "#SBATCH -J oi_gmi",
        "#SBATCH --no-requeue",
        "#SBATCH --account=s1043",
        "#SBATCH --ntasks=1",
        f"#SBATCH --cpus-per-task={int(num_job)}",
        "#SBATCH --mem=170G",
        "#SBATCH --qos=debug" if debug else "#SBATCH -t 12:00:00",
        "#SBATCH -o oi_gmi-%j.out",
        "#SBATCH -e oi_gmi-%j.err",
        JOB_LINE.format(python_bin=python_bin, year=year, month=month),
    ]
    return "\n".join(lines) + "\n"


def qsub_script(python_bin, year, month, debug=False):
    lines = [
        "#!/bin/bash",
        "#PBS -l select=6:ncpus=4:mpiprocs=4:model=ivy",
        "#PBS -l walltime=3:00:00",
        "#PBS -N oi_gmi",
        "#PBS -j oe",
        "#PBS -m abe",
        "#PBS -o oi_gmi.out",
        "#PBS -e oi_gmi.err",
        "#PBS -W group_list=s1395",
    ]
    if debug:
        lines.append("#PBS -q devel")
    lines += ["cd $PBS_O_WORKDIR", JOB_LINE.format(python_bin=python_bin, year=year, month=month)]
    return "\n".join(lines) + "\n"


def submit(scheduler="sbatch", control="./control.yml", dry_run=False,
           reference_months=False):
    """Write ``./jobs/job_<year>_<month>.j`` for every month of the control
    file's window and hand each to ``scheduler`` (``dry_run``: write only);
    returns the paths.  ``reference_months=True`` (the drop-in shims)
    reproduces the reference's cartesian month set; the default is the
    calendar sequence (:func:`month_list`)."""
    ctrl = load_control(control)
    os.makedirs("./jobs", exist_ok=True)
    scripts = []
    pick = month_list_reference if reference_months else month_list
    for year, month in pick(ctrl["start_date"], ctrl["end_date"]):
        if scheduler == "sbatch":
            body = sbatch_script(ctrl["python_bin"], ctrl["num_job"], year, month,
                                 debug=ctrl.get("debug", False))
        else:
            body = qsub_script(ctrl["python_bin"], year, month,
                               debug=ctrl.get("debug", False))
        path = f"./jobs/job_{year}_{month}.j"
        with open(path, "w") as f:
            f.write(body)
        scripts.append(path)
        if not dry_run:
            os.system(f"{scheduler} {path}")
    return scripts


if __name__ == "__main__":
    import sys

    submit(scheduler=sys.argv[1] if len(sys.argv) > 1 else "sbatch")
