"""The port's dry-run entry points (cavif_tpu_torch/entry.py) against the
repository's __graft_entry__.py on the CPU.

entry() returns the port's Pass1Program of the reference's key and the
reference's example arguments; its packed output may differ from the
reference's jitted program's on fewer than 1e-3 of the entries (the
decision-module rule; expected: none). It is the program run_pass1_batch
runs, bit for bit. dryrun_multichip(n) spawns n gloo ranks on the CPU as a
(data, tile) mesh laid out as the reference lays out n devices; its
packed output must equal the meshless one byte for byte."""

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from cavif_tpu_torch import entry as ent
from cavif_tpu_torch.ops import device_pass1 as dp


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """Torch on one thread here and in the spawned ranks: the suite runs
    several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def packed():
    fn, args = ent.entry("cpu")
    with torch.inference_mode():
        return fn(*args).numpy()


def test_entry_matches_reference(packed):
    fn, example = ref_entry.entry()
    _, args = ent.entry("cpu")
    assert np.array_equal(args[0].numpy(), example[0])
    assert [float(a) for a in args[1:4]] == [float(a) for a in example[1:4]]
    assert list(args[4:]) == [int(a) for a in example[4:]]
    want = np.asarray(fn(*example))
    assert packed.shape == want.shape and packed.dtype == want.dtype
    diff = int((packed != want).sum())
    assert diff < 1e-3 * want.size, (diff, want.size)
    print(f"entry: {diff} of {want.size} packed entries differ")


def test_entry_is_the_batch_program(packed):
    spec = dp.program_spec(ent.H, ent.W, 3, ent.KW["min_px"],
                           ent.KW["max_px"])
    assert packed.shape == (2, ent.width())
    assert ent.width() == sum(nby * nbx for (_, _, (nby, nbx)) in spec)
    grids = dp.run_pass1_batch(ent.batch(2), device="cpu", **ent.KW)
    assert np.array_equal(ent.pack(grids), packed)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_is_the_references(n):
    data, tile = ent.mesh_shape(n)
    assert data * tile == n
    assert (data, tile) == ((n // 2, 2) if n % 2 == 0 else (n, 1))


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_gloo_equals_meshless(n, packed):
    """n = 1: one rank as (1, 1); n = 2: two ranks as (1, 2), each
    computing one 64-row band with its halo. b = 2 in both, the entry
    batch, so the output must be entry()'s bytes."""
    out = ent.dryrun_multichip(n, device="cpu")
    assert out.shape == packed.shape and out.dtype == np.int8
    assert out.tobytes() == packed.tobytes()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="cuda"):
        ent.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        ent.dryrun_multichip(1)


# A rank of the launcher test: rank 1 writes 1 MiB to its error output
# (more than a pipe holds) and exits 3; rank 0 waits until rank 1 has
# written it all, as a rank waits for another in a collective ("wait"),
# or forever ("hang").
RANK_CODE = """
import os, sys, time
opt = dict(zip(sys.argv[2::2], sys.argv[3::2]))
mode, mark = sys.argv[1], os.path.join(os.environ["RANKS_TMP"], "written")
if opt["--rank"] == "1":
    sys.stderr.write("x" * (1 << 20) + "\\nrank one fails\\n")
    sys.stderr.flush()
    open(mark, "w").close()
    sys.exit(3)
while mode == "hang" or not os.path.exists(mark):
    time.sleep(0.05)
print("rank zero done")
"""


@pytest.mark.parametrize("mode", ["wait", "hang"])
def test_run_ranks_reports_the_failing_rank(mode, tmp_path, monkeypatch):
    """No rank blocks on its output while another waits for it: the
    launcher reports rank 1's exit (and, where rank 0 never ends, rank 0
    as still running at the deadline) well before RANK_TIMEOUT, keeps
    every rank's output in log_dir and leaves no process behind."""
    import subprocess
    import sys
    import time

    from cavif_tpu_torch.parallel import ranks

    monkeypatch.setenv("RANKS_TMP", str(tmp_path))
    started = []
    real_popen = subprocess.Popen

    def popen(*a, **kw):
        started.append(real_popen(*a, **kw))
        return started[-1]

    monkeypatch.setattr(subprocess, "Popen", popen)
    timeout = 30.0 if mode == "wait" else 6.0
    t0 = time.time()
    with pytest.raises(RuntimeError) as e:
        ranks.run_ranks([sys.executable, "-c", RANK_CODE, mode], 2,
                        timeout=timeout, log_dir=str(tmp_path / "logs"))
    assert time.time() - t0 < timeout + 10
    msg = str(e.value)
    assert "rank 1 of 2 exited 3" in msg and "rank one fails" in msg
    assert (f"rank 0 of 2 still running after {timeout:.0f} s" in msg) == \
        (mode == "hang")
    assert len(started) == 2 and all(p.poll() is not None for p in started)
    logs = tmp_path / "logs"
    assert (logs / "rank1.err").stat().st_size > 1 << 20
    assert ((logs / "rank0.out").read_text() == "rank zero done\n") == \
        (mode == "wait")
