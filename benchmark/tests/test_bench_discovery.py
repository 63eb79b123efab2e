"""A configuration, a cell and a metric are added as files, and found by
name, with no file of the benchmark edited."""

import hashlib
import json
import shutil

import pytest
import run as R
from harness import spec

from helpers import args


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(bench)

    cfg = json.loads((bench / "configs" / "cavif-defaults-1mp.json")
                     .read_text())
    cfg.update(name="tiny-q60", source="https://example.org/tiny")
    cfg["encoder"]["quality"] = 60
    cfg["image"].update(height=64, width=48)
    (bench / "configs" / "tiny-q60.json").write_text(json.dumps(cfg))
    (bench / "workloads" / "tiny-single.json").write_text(json.dumps({
        "config": "tiny-q60", "entry": "encode_rgb", "loop": "closed",
        "streams": 2, "pool": 3, "warmup": [1],
        "profile": {"start_s": 0.2, "seconds": 1.0},
        "limits": {"unanswered": 0, "decode_failed": 0,
                   "property_faults": 0, "rmse_worst": 12.0},
        "why": "a test cell"}))
    (bench / "metrics" / "tiny.bytes_per_image.py").write_text(
        "def read(win, cell):\n"
        "    n = sum(a.avif is not None for a in win.answers)\n"
        "    return win.avif_bytes / n if n else None\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-q60", "source": cfg["source"],
                           "file": "benchmark/configs/tiny-q60.json",
                           "reduced": [], "why": "a test configuration"})
    man["workloads"].append({"name": "tiny-single", "config": "tiny-q60",
                             "traffic": "single", "chips": 1,
                             "why": "a test cell"})
    man["end_to_end"].append({"name": "tiny.bytes_per_image", "unit": "B",
                              "better": "lower", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["tiny-single"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    after = _digests(bench)
    assert all(after[k] == v for k, v in before.items())
    assert len(after) == len(before) + 3

    monkeypatch.setattr(spec, "BENCH", bench)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    cell = spec.cell("tiny-single")
    assert cell.config["name"] == "tiny-q60"
    assert {m["name"] for m in cell.end_to_end} == {
        "tiny.bytes_per_image", "avif_bpp", "rmse_levels", "setup_s"}
    result, check = R.run(args("tiny-single", seconds=1.5), cell,
                          device="cpu")
    assert result["correct"], (result, check)
    assert result["attempted"] >= 2
    assert set(result["metrics"]) == {"tiny.bytes_per_image", "avif_bpp",
                                      "rmse_levels", "setup_s"}
    assert result["metrics"]["tiny.bytes_per_image"]["unit"] == "B"


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
