"""run.py started from its command line, and a whole run on the CPU with the
timed path broken underneath: `correct` has to come out false for every
fault a cell can have and for the control, and true without them."""

import shutil
import subprocess
import sys

import pytest
import run as R
from harness import faults, spec

from helpers import args, tiny

CMD = ["benchmark/run.py", "--workload", "defaults1mp-single", "--seed",
       "2147483999", "--seconds", "1", "--trace", "0"]


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, *CMD], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "no result" in p.stderr


def test_alone_it_exits_nonzero_and_prints_no_result(tmp_path):
    shutil.copytree(spec.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, *CMD], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""


@pytest.mark.parametrize("name", ["defaults1mp-single", "defaults1mp-batch"])
def test_a_sound_run_is_correct(name):
    res, check = R.run(args(name, seconds=2.0, trace=1), tiny(name),
                       device="cpu")
    assert res["correct"], (res, check)
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert all(c["value"] <= c["limit"] for c in check.values())
    assert list(check) == ["unanswered", "decode_failed", "property_faults",
                           "rmse_worst"]
    assert res["mode"] is None and res["mode_faults"] == []  # off the card
    host = res["host"]
    assert host["cpus"] >= 1 and host["torch_threads"] >= 1
    assert host["wall_s"] > 0 and host["process_cpu_s"] > 0


def test_the_quality_metric_reads_the_checked_files():
    name = "defaults1mp-single"
    res, check = R.run(args(name, seconds=1.0), tiny(name), device="cpu")
    q = res["metrics"]["rmse_levels"]
    assert q["unit"] == "levels"
    assert 0 < q["value"] <= check["rmse_worst"]["value"]


def test_another_mode_than_the_cell_states_prints_no_result(monkeypatch,
                                                           capsys):
    from harness.session import Session

    name = "defaults1mp-single"
    cell = tiny(name)
    assert cell.spec["mode"] == {"device_filters": True}
    monkeypatch.setattr(Session, "mode", lambda self: {
        "rtt_ms": 4.2, "device_filters": False})
    monkeypatch.setattr(R, "card_check", lambda chips: None)
    monkeypatch.setattr(spec, "cell", lambda n: cell)
    real = R.run
    monkeypatch.setattr(R, "run", lambda a, c: real(a, c, device="cpu"))
    rc = R.main(["--workload", name, "--seed", "2147483999", "--seconds",
                 "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 4 and out == ""
    assert "device_filters" in err and "no result" in err


def test_a_span_missed_by_the_span_clock_stops_a_traced_run(monkeypatch):
    from harness import devtrace

    monkeypatch.setattr(devtrace.SpanClock, "start", lambda self: None)
    name = "defaults1mp-single"
    with pytest.raises(RuntimeError, match="span clock"):
        R.run(args(name, seconds=1.0, trace=1), tiny(name), device="cpu")


@pytest.mark.parametrize("name,fault", [
    ("defaults1mp-single", "stale"), ("defaults1mp-single", "flip"),
    ("defaults1mp-batch", "stale"), ("defaults1mp-batch", "half"),
    ("defaults1mp-batch", "flip")])
def test_a_planted_fault_makes_the_run_incorrect(name, fault):
    res, check = R.run(args(name, seconds=3.0), tiny(name), device="cpu",
                       wrap=faults.FAULTS[fault])
    assert res["attempted"] >= 2 * tiny(name).spec.get("list_length", 1)
    assert not res["correct"], (fault, check)


def test_the_control_is_incorrect():
    name = "defaults1mp-single"
    cell = tiny(name)
    settings = {**cell.config["encoder"], **faults.CONTROLS["depth8"]}
    res, check = R.run(args(name, seconds=1.0), cell, device="cpu",
                       settings=settings)
    assert not res["correct"]
    assert check["property_faults"]["value"] >= 4 * res["attempted"]


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.manifest()["workloads"]])
def test_each_cell_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483998", "--seconds", "5", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    import json

    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert list(line)[-1] == "check"
