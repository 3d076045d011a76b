"""The port runs where jax, h5py, yaml and matplotlib are absent: every slice
module (and chip_smoke.py) imports with those blocked in ``sys.modules``."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SLICE_MODULES = [
    "oisat_tpu_torch",
    "oisat_tpu_torch._device",
    "oisat_tpu_torch.ops",
    "oisat_tpu_torch.ops.kernels",
    "oisat_tpu_torch.ops.kernels._build",
    "oisat_tpu_torch.ops.kernels.oi_scan",
    "oisat_tpu_torch.ops.knee",
    "oisat_tpu_torch.ops.oi",
    "oisat_tpu_torch.ops.averaging",
    "oisat_tpu_torch.ops.diagnostics",
    "oisat_tpu_torch.ops.vertical",
    "oisat_tpu_torch.ops.regrid",
    "oisat_tpu_torch.parallel",
    "oisat_tpu_torch.parallel.analysis",
    "oisat_tpu_torch.datamodel",
    "oisat_tpu_torch.convert",
    "oisat_tpu_torch.regridder",
    "oisat_tpu_torch.driver",
    "oisat_tpu_torch.entry",
    "chip_smoke",
]

_BLOCKED = ("jax", "jaxlib", "h5py", "yaml", "matplotlib")


def test_slice_imports_without_jax_h5py_yaml_matplotlib():
    code = "\n".join([
        "import importlib, sys",
        f"for m in {_BLOCKED!r}:",
        "    sys.modules[m] = None",
        f"for name in {SLICE_MODULES!r}:",
        "    importlib.import_module(name)",
        "import oisat_tpu_torch",
        "oisat_tpu_torch.oisatgmi",
        f"leaked = [m for m in {_BLOCKED!r} if sys.modules.get(m) is not None]",
        "assert not leaked, leaked",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
