"""oisat_tpu_torch: the PyTorch + CUDA port of oisat_tpu.

The same satellite<->model optimal-interpolation analysis as the JAX package
beside it (``oisat_tpu``), written for one NVIDIA Hopper GPU.  The modules
mirror the JAX layout so each counterpart is easy to find:

  host:   QA mask -> sparse interpolation plan  (ops.weights / native: the
          port's own copies of the JAX package's numpy, scipy and C++ code)
  device: regridder.regrid_granule      (ops.regrid gather + box filter)
          parallel.analysis.full_month_step
              = ops.vertical.amf_recal_fields -> ops.averaging.monthly_stats
                -> bias -> ops.oi.oi (curve: CUDA kernel ops.kernels.oi_scan)
                -> ops.diagnostics.innovation_stats
  host:   driver.oisatgmi.analyze_month_fused (one device->host pull)
  full:   oi_method="full" -> ops.oi_full.oi_full (covariance: CUDA kernel
          ops.kernels.covariance; eigh scan + exact float64 tail on the card)
  kinds:  satellite_amf (above), satellite_opt (MOPITT / GOSAT averaging-
          kernel convolution; readers.sensors.gosat fills the sparse GOSAT
          soundings first) and satellite_ssmis (regridder.regrid_ssmis_granule,
          precipitable water): parallel.analysis.mopitt_month_step /
          gosat_month_step / ssmis_month_step
  staged: driver.oisatgmi.recal_amf / conv_ak / cal_pwv (obs_operators)
          -> average (ops.averaging.averaging) -> bias_correct -> oi
          (scalar or full, Desroziers re-estimation) -> savedaily
  files:  driver.oisatgmi.read_data (readers: ncio, the CTM readers, the
          per-sensor readers; decode on host threads, regrid on the device)
          -> ... -> write_to_nc (ncwriter) / reporting (report, data);
          save_state / load_state (utils.granule_store)
  jobs:   run.job (one control.yml month: fused, staged or fallback
          dispatch; TEMPO's hour loop), run.campaign (months in one
          process), run.job_submitter / job_submitter_sbatch /
          job_submitter_qsub (one SLURM or PBS job per month),
          tools.readjust_OI, examples.synthetic_month
  edges:  downloader (every input product's archive), tools.convert2EXT /
          createOHfields / create_ind_CO_emiss / merge_soil_CCMI_NEI
          (ExtData and emission files from diag and MERRA2-GMI files)

The package imports torch, numpy and scipy, and nothing of jax or of
``oisat_tpu``; h5py, yaml and matplotlib are imported inside the functions
that read or write files, and requests, bs4 and earthaccess inside the
downloader's methods.  Whatever reads files or runs a job computes on
the card unless the caller names another device.  Tensors are created on
the device the caller names; a CUDA tensor always goes through the
hand-written kernel, a CPU tensor through its plain PyTorch version.

Importing the package tunes glibc's allocator for the host path's multi-MB
numpy temporaries, as ``oisat_tpu`` does (``OISAT_MALLOC_TUNE=0`` opts out).
"""

__version__ = "0.1.0"

__all__ = ["oisatgmi", "__version__"]


def _tune_host_allocator() -> bool:
    """Keep large NumPy temporaries on glibc's reused heap; True when tuned.

    Twin of ``oisat_tpu/__init__.py:25-55``.  By default glibc serves
    allocations over ~128 KB with a fresh ``mmap`` and returns them to the
    OS on free, so every multi-MB NumPy temporary in the per-granule host
    path (field stacking, CTM slicing, dtype casts) pays first-touch page
    faults each time.  Raising ``M_MMAP_THRESHOLD`` (clamped by glibc to
    32 MiB) and ``M_TRIM_THRESHOLD`` makes those buffers heap-backed and
    retained, so the faults are paid once per size class.  Cost: process
    RSS stays at its high-water mark.  Disable with ``OISAT_MALLOC_TUNE=0``.
    """
    import ctypes
    import os
    import sys

    if os.environ.get("OISAT_MALLOC_TUNE", "1") != "1":
        return False
    if not sys.platform.startswith("linux"):
        return False
    try:
        mallopt = ctypes.CDLL("libc.so.6").mallopt
    except (OSError, AttributeError):
        return False  # non-glibc libc: default allocator behavior is fine
    mallopt(-3, 32 * 1024 * 1024)  # M_MMAP_THRESHOLD
    mallopt(-1, 256 * 1024 * 1024)  # M_TRIM_THRESHOLD
    return True


HOST_ALLOCATOR_TUNED = _tune_host_allocator()


def __getattr__(name):
    # lazy, like oisat_tpu: `import oisat_tpu_torch` stays cheap
    if name == "oisatgmi":
        from oisat_tpu_torch.driver import oisatgmi

        return oisatgmi
    raise AttributeError(f"module 'oisat_tpu_torch' has no attribute {name!r}")
