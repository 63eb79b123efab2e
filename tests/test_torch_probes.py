"""The port's device probes (cavif_tpu_torch/tools/card_probe.py,
card_probe2.py) and scaling bench (tools/scale_bench.py) on the CPU.

The probes run to their end at size 128 with device "cpu" (the block
search's plain version) and return every section's numbers; without a
card their default device, "cuda", raises: no probe falls back to the
CPU. The scaling bench runs one and two gloo ranks and prints one JSON
line with the reference's keys. Times here are CPU times and are not
checked."""

import contextlib
import io
import json
import re
from pathlib import Path

import pytest
import torch

from cavif_tpu_torch.tools import card_probe, card_probe2, scale_bench

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(n)


def _run(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def test_card_probe_runs_on_cpu():
    out, lines = _run(card_probe.run, "cpu", 128)
    assert list(out) == [f.__name__ for f in card_probe.PROBES]
    assert sorted(out["plain_search"]) == [8, 16, 32]
    assert sorted(out["k3_search"]) == [8, 16]
    assert out["host_pass1"]["min_ms"] > 0
    assert len(lines) == 1 + 1 + 2 + 3 + 1 + 2 + 1, lines
    assert lines[0].startswith("backend: cpu")
    assert any(ln.startswith("partition program (8/16/32, plain version")
               for ln in lines)


def test_card_probe2_runs_on_cpu():
    out, lines = _run(card_probe2.run, "cpu", 128)
    assert list(out) == [f.__name__ for f in card_probe2.PROBES]
    assert sorted(out["v0_resident"]) == [8, 16, 32]
    assert len(lines) == 1 + 3 + 1 + 1 + 1 + 1, lines
    assert all("[K3's plain version on cpu]" in ln for ln in lines
               if ln.startswith("V"))


PROBE_FNS = [(m, f) for m in (card_probe, card_probe2)
             for f in m.PROBES + (m.run,)]


@pytest.mark.parametrize("mod,fn", PROBE_FNS,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}.{f.__name__}"
                              for m, f in PROBE_FNS])
def test_probes_default_to_the_card(mod, fn):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="cuda"):
        fn()


def test_scale_bench_on_gloo():
    _, lines = _run(scale_bench.main, ["--device", "cpu", "--n", "2",
                                       "--size", "128"])
    assert len(lines) == 1, lines
    res = json.loads(lines[0])
    ref_keys = re.findall(r'"(\w+)": ', (ROOT / "tools" / "scale_bench.py")
                          .read_text().split("print(json.dumps({", 1)[1])
    assert list(res) == ref_keys == ["mp_s_1proc", "mp_s_2proc", "scaling",
                                     "note"]
    assert res["mp_s_1proc"] > 0 and res["mp_s_2proc"] > 0
    assert res["scaling"] == pytest.approx(res["mp_s_2proc"]
                                           / res["mp_s_1proc"])
    assert "gloo" in res["note"] and "the CPU" in res["note"]


def test_scale_bench_retries_a_rendezvous_timeout_once():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("rank 1 of 2 exited 1: Socket Timeout: "
                               "timed out waiting for the store")
        return 1.5

    assert scale_bench._retry_gloo(flaky) == 1.5 and len(calls) == 2
    with pytest.raises(RuntimeError, match="boom"):
        scale_bench._retry_gloo(lambda: (_ for _ in ()).throw(
            RuntimeError("boom")))
