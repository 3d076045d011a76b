"""No module of the benchmark loads JAX or the JAX package: each is
imported in a fresh interpreter and the loaded top-level names are read
whole (``oisat_tpu_torch`` is not ``oisat_tpu``)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.harness import FORBIDDEN_MODULES, forbidden_loaded
from benchmark.spec import HERE, ROOT

MODULES = sorted(["benchmark." + p.stem for p in HERE.glob("*.py") if p.stem != "__init__"])


@pytest.mark.parametrize("module", MODULES)
def test_module_loads_no_jax(module):
    code = ("import importlib, json, sys; importlib.import_module(%r); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % module)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                      "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & set(FORBIDDEN_MODULES), top & set(FORBIDDEN_MODULES)


def test_metric_readers_load_no_jax():
    code = ("import json, sys; from benchmark.spec import load_benchmark, metric_reader; "
            "[metric_reader(m['name']) for m in load_benchmark()['per_layer']]; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                      "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert not set(json.loads(out.stdout.strip().splitlines()[-1])) & set(FORBIDDEN_MODULES)


def test_granule_kinds_load_no_jax():
    code = ("import json, sys; from benchmark.reference import KINDS, granule_kind; "
            "[granule_kind(p.stem) for p in KINDS.glob('*.py')]; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                      "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert not set(json.loads(out.stdout.strip().splitlines()[-1])) & set(FORBIDDEN_MODULES)


def test_names_are_compared_whole():
    assert forbidden_loaded({"oisat_tpu_torch": 1, "oisat_tpu_torch.driver": 1}) == []
    assert forbidden_loaded({"oisat_tpu.ops": 1, "jax": 1, "jaxlib.xla": 1, "flaxen": 1}) == [
        "jax", "jaxlib.xla", "oisat_tpu.ops"]
