"""Job runners of the port: ``python -m oisat_tpu_torch.run.job <year> <month>``
(one month from ``control.yml``) and ``python -m oisat_tpu_torch.run.campaign``
(every month of ``start_date..end_date`` in one process)."""
