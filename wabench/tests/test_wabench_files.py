"""The benchmark's files: every data file parses, BENCHMARK.json keeps to
its form, the configurations are the presets they name, and a new cell,
configuration, traffic mix or metric is found from new files and entries
alone."""

import dataclasses
import json
import re
import shutil

import pytest

from repro_torch.core import managers
from wabench import cell as cells

ROOT = cells.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def data_files():
    return sorted((ROOT / "wabench").glob("*/*.json"))


@pytest.mark.parametrize("path", data_files(), ids=lambda p: p.name)
def test_every_data_file_parses(path):
    assert isinstance(json.loads(path.read_text()), dict)


def test_benchmark_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["wabench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("wabench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in names
        assert (ROOT / "wabench" / "traffic"
                / f"{w['traffic']}.json").exists()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert (ROOT / "wabench" / "metrics" / f"{m['name']}.py").exists()
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_configuration_is_its_preset_on_the_table2_drive(config):
    cfg = json.loads((ROOT / config["file"]).read_text())
    knobs = {k: v for k, v in cfg["manager"].items() if k != "preset"}
    preset = getattr(managers, cfg["manager"]["preset"])()
    assert knobs == dataclasses.asdict(preset)
    g = cfg["geometry"]
    assert (g["n_luns"], g["blocks_per_lun"], g["pages_per_block"]) == (
        8, 1024, 128)
    assert g["n_luns"] == g["channels"] * g["luns_per_channel"]
    assert g["lba_pba"] == 0.70 and g["page_size_bytes"] == 16384
    assert cfg["derived"]["logical_pages"] == int(8 * 1024 * 128 * 0.70)
    assert cfg["reduced"] == config["reduced"] == []


def test_new_cell_is_found_from_new_files_alone(tmp_path):
    """A later change adds a configuration, a traffic mix, a metric and a
    cell by new files and entries; every file already there stays as it
    was."""
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "wabench" / sub, tmp_path / "wabench" / sub)
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in tmp_path.rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / BENCH["configs"][0]["file"]).read_text())
    cfg["name"] = "table2_wolf_new"
    (tmp_path / "wabench/configs/table2_wolf_new.json").write_text(
        json.dumps(cfg))
    (tmp_path / "wabench/traffic/uniform_new.json").write_text(json.dumps({
        "drives": 2, "check_drives": 1,
        "phases": [{"events": 100, "groups": [{"frac": 1.0,
                                               "weight": 1.0}]}]}))
    (tmp_path / "wabench/metrics/new_counter.py").write_text(
        "def read(rec):\n    return rec['counts']['rounds'] * 2.0\n")
    bench["configs"].append({
        "name": "table2_wolf_new", "source": "x",
        "file": "wabench/configs/table2_wolf_new.json", "reduced": [],
        "why": "x"})
    bench["workloads"].append({
        "name": "new_cell", "config": "table2_wolf_new",
        "traffic": "uniform_new", "chips": 1, "why": "x"})
    bench["per_layer"].append({
        "name": "new_counter", "unit": "rounds", "better": "lower",
        "source": "program_counter", "layer": "run loop",
        "moves": "events_per_s", "workloads": ["new_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    c = cells.load_cell("new_cell", tmp_path)
    assert c["config"]["name"] == "table2_wolf_new"
    assert c["traffic"]["drives"] == 2
    assert [m["name"] for m in c["per_layer"]] == ["new_counter"]
    assert {m["name"] for m in c["end_to_end"]} == {
        m["name"] for m in BENCH["end_to_end"]}
    assert cells.reader("new_counter", tmp_path)(
        {"counts": {"rounds": 3}}) == 6.0
    old = cells.load_cell(BENCH["workloads"][0]["name"], tmp_path)
    assert "new_counter" not in [m["name"] for m in old["per_layer"]]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in tmp_path.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_reader_loads(metric):
    assert callable(cells.reader(metric["name"]))


def test_command_runs_the_package_under_paths():
    assert (ROOT / "wabench" / "run.py").is_file()
    assert BENCH["command"] == ["python3", "-m", "wabench.run"]
