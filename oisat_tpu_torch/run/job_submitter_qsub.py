"""PBS submitter of the port, drop-in name (twin of ``run/job_submitter_qsub.py``).

Emits the reference's exact month set (cartesian min..max months x years --
see :func:`oisat_tpu_torch.run.job_submitter.month_list_reference`).

Usage: python -m oisat_tpu_torch.run.job_submitter_qsub   (reads ./control.yml)
"""
from oisat_tpu_torch.run.job_submitter import submit

if __name__ == "__main__":
    submit(scheduler="qsub", reference_months=True)
