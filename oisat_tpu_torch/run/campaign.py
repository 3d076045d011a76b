"""In-process campaign sweep of the port: many (year, month) jobs on one card.

Twin of ``run/campaign.py`` over :mod:`oisat_tpu_torch.run.job`.  The
reference fans months out as independent SLURM/PBS jobs
(run/job_submitter_*.py) because each CPU month takes hours; on the card a
month is seconds to minutes, so a multi-month or multi-year campaign runs as
one process.  Month-level fault tolerance replaces manual resubmission: a
failed month is retried once, then logged and skipped.

Usage: python -m oisat_tpu_torch.run.campaign [control.yml]
       (sweeps start_date..end_date)
"""

from __future__ import annotations

import sys
import traceback

from oisat_tpu_torch._device import default_device
from oisat_tpu_torch.run.job import load_control, read_month, run_month
from oisat_tpu_torch.utils.profiling import log, report, stage

__all__ = ["month_list", "run_campaign"]


def month_list(startdate: str, enddate: str):
    """The calendar sequence of (year, month) from ``startdate`` through
    ``enddate`` inclusive (``run/job_submitter.py:month_list``): 2005-11 ..
    2006-02 yields exactly [(2005, 11), (2005, 12), (2006, 1), (2006, 2)]."""
    y, m = int(startdate[0:4]), int(startdate[5:7])
    ye, me = int(enddate[0:4]), int(enddate[5:7])
    out = []
    while (y, m) <= (ye, me):
        out.append((y, m))
        m += 1
        if m == 13:
            y, m = y + 1, 1
    return out


def run_campaign(ctrl, retries: int = 1, prefetch=None):
    """Sweep months; with ``prefetch`` (control key ``campaign_prefetch``,
    default on for non-TEMPO sensors) month k+1's ``read_data`` (file IO,
    the granules' regrid on the device) runs in ONE background thread while
    month k's report + netCDF host tail executes (``run_month`` fires
    ``prefetch_hook`` after the analysis).  Months are independent (the
    reference fans them out as separate scheduler jobs), so the overlap
    cannot change results; reads never overlap each other (at most one
    prefetch thread), preserving ``num_job`` semantics within each read.
    A failed prefetch falls back to an inline read on the month's own
    attempt (and its retry path always reads inline).

    Default: on only on multi-core hosts (``os.cpu_count() > 1``); on one
    core the prefetch thread's host work contends with the report leg's
    matplotlib time.  The control key forces either way."""
    import os

    # a campaign with no card (and no ``device: cpu``) raises here, once,
    # instead of failing month after month inside the retry loop
    default_device(ctrl.get("device"))
    months = month_list(ctrl["start_date"], ctrl["end_date"])
    if prefetch is None:
        prefetch = bool(ctrl.get("campaign_prefetch",
                                 (os.cpu_count() or 1) > 1))
    prefetch = prefetch and ctrl.get("sensor") != "TEMPO"
    ex = None
    pending = {}
    if prefetch and len(months) > 1:
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor(max_workers=1)

    def _kick(ym):
        def kick():
            if ex is not None and ym is not None and ym not in pending:
                pending[ym] = ex.submit(read_month, ctrl, *ym)
        return kick

    failed = []
    try:
        for i, (year, month) in enumerate(months):
            nxt = months[i + 1] if i + 1 < len(months) else None
            for attempt in range(retries + 1):
                try:
                    pre = None
                    if attempt > 0 and pending:
                        # the retry reads inline; drain any in-flight
                        # prefetch first so the 'reads never overlap'
                        # invariant holds.  Results stay cached in their
                        # futures for their months.
                        for f in pending.values():
                            try:
                                f.result()
                            except Exception:
                                pass  # its month will read inline
                    fut = pending.pop((year, month), None)
                    if fut is not None and attempt == 0:
                        try:
                            pre = fut.result()
                        except Exception:
                            traceback.print_exc()
                            log("prefetch failed; reading inline",
                                year=year, month=month)
                    with stage("month", year=year, month=month):
                        run_month(ctrl, year, month, pre_read=pre,
                                  prefetch_hook=_kick(nxt))
                    log("month done", year=year, month=month)
                    break
                except Exception:
                    traceback.print_exc()
                    if attempt == retries:
                        failed.append((year, month))
                        log("month FAILED after retries", year=year, month=month)
    finally:
        if ex is not None:
            ex.shutdown(wait=True)
    log("campaign finished", months=len(months), failed=failed)
    print(report())
    return failed


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ctrl = load_control(argv[0] if argv else "./control.yml")
    return 1 if run_campaign(ctrl) else 0


if __name__ == "__main__":
    sys.exit(main())
