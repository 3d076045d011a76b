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
          process), tools.readjust_OI, examples.synthetic_month

The package imports torch, numpy and scipy, and nothing of jax or of
``oisat_tpu``; h5py, yaml and matplotlib are imported inside the functions
that read or write files.  Whatever reads files or runs a job computes on
the card unless the caller names another device.  Tensors are created on
the device the caller names; a CUDA tensor always goes through the
hand-written kernel, a CPU tensor through its plain PyTorch version.
"""

__version__ = "0.1.0"

__all__ = ["oisatgmi", "__version__"]


def __getattr__(name):
    # lazy, like oisat_tpu: `import oisat_tpu_torch` stays cheap
    if name == "oisatgmi":
        from oisat_tpu_torch.driver import oisatgmi

        return oisatgmi
    raise AttributeError(f"module 'oisat_tpu_torch' has no attribute {name!r}")
