"""Configurations, mixes, metrics and limits are found by name, and a new
file is picked up with no edit to any file of the harness."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmark.spec import HERE, ROOT, load_benchmark, load_cell, metric_reader

CELLS = ("omi_no2.scalar_month", "mopitt_co.scalar_month")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = load_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.mix["control"]["oi_method"] == "scalar"
    assert {m["name"] for m in cell.end_to_end} == {"month_s", "setup_s"}
    assert cell.per_layer and set(cell.limits)


def test_every_metric_has_a_reader():
    bench = load_benchmark()
    for m in bench["per_layer"]:
        assert callable(metric_reader(m["name"]))
        assert m["moves"] == "month_s"


def test_every_config_file_is_under_paths_and_named():
    bench = load_benchmark()
    for c in bench["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert set(c["reduced"]) == set(data["reduced"])


def test_a_new_cell_is_files_only(tmp_path):
    """A copy of the benchmark with one more mix, metric and cell, added as
    files and BENCHMARK.json entries: the unchanged harness finds them."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark")
    bench = load_benchmark()
    (root / "benchmark" / "mixes" / "quarter_month.json").write_text(json.dumps(
        {"why": "a test mix", "control": {"oi_method": "scalar"}}))
    (root / "benchmark" / "metrics" / "device.months.py").write_text(
        "def read(ctx):\n    return float(len(ctx.months))\n")
    bench["workloads"].append({"name": "omi_no2.quarter_month", "config": "omi_no2_gmi",
                               "traffic": "quarter_month", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "device.months", "unit": "months", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "month_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("omi_no2.quarter_month", root=root)
    assert cell.mix["why"] == "a test mix"
    assert "device.months" in [m["name"] for m in cell.per_layer]
    read = metric_reader("device.months", root=root)

    class Ctx:
        months = [1, 2, 3]

    assert read(Ctx()) == 3.0


def test_a_new_granule_kind_is_a_file_only(tmp_path, monkeypatch):
    """A kind added as one file of ``kinds/`` is generated, run through the
    program, regridded and judged by the unchanged harness, at a tiny size
    on the CPU."""
    from benchmark import check as C
    from benchmark import generators as G
    from benchmark import program
    from benchmark import reference as R
    from benchmark.tests.tiny import tiny_cell

    kinds = tmp_path / "kinds"
    shutil.copytree(HERE / "kinds", kinds)
    (kinds / "omi_copy.py").write_text(
        "from benchmark.reference import granule_kind\n"
        "_base = granule_kind('omi_orbit')\n"
        "CONTAINER, FIELDS2, FIELDS3 = _base.CONTAINER, _base.FIELDS2, _base.FIELDS3\n"
        "container_fields, operator = _base.container_fields, _base.operator\n"
        "def make(seeds, block, month):\n"
        "    return [dict(g, kind='omi_copy') for g in _base.make(seeds, block, month)]\n")
    monkeypatch.setattr(R, "KINDS", kinds)
    cell = tiny_cell("omi_no2.scalar_month")
    cell.config["granules"]["kind"] = "omi_copy"
    raw, ctm, lon2d, lat2d = G.make_month(cell.config, 13)
    assert {g["kind"] for g in raw} == {"omi_copy"}
    ctrl = program.control_dict(cell.config, cell.mix, "cpu")
    m = program.run_month(raw, program.to_ctm(ctm), lon2d, lat2d, cell.config, ctrl, "cpu")
    checks = C.check(cell, 13, raw, ctm, m, "cpu")
    assert all(v <= lim for v, lim in checks.values()), checks
    with pytest.raises(KeyError, match="no granule kind"):
        R.granule_kind("no_such_kind")


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        load_cell("no_such.cell")
