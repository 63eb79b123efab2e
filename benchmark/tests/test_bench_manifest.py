"""The manifest and the files it names."""

import json
import re

import pytest
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = spec.manifest()


def test_manifest_has_the_contract_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_every_name_and_unit_is_plain():
    names = ([c["name"] for c in MAN["configs"]]
             + [w["name"] for w in MAN["workloads"]]
             + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in MAN["workloads"]]:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in MAN["workloads"]]
                 + [m["layer"] for m in MAN["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_what_the_contract_asks(w):
    cell = spec.cell(w["name"])
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
    assert w["chips"] == 1
    assert cell.spec["config"] == w["config"]
    for k in ("unanswered", "decode_failed", "property_faults",
              "rmse_worst"):
        assert k in cell.spec["limits"]


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_its_reader(m):
    assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_each_configuration_file(c):
    assert c["file"] == f"benchmark/configs/{c['name']}.json"
    cfg = json.loads((spec.ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in MAN["workloads"])
