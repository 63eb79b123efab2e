"""The (data, tile) mesh of the PyTorch/CUDA port (cavif_tpu_torch.parallel
.mesh, with the mesh paths of ops/device_pass1.run_pass1_batch,
ops/block_search and parallel/batch) on the CPU, held against the port's
meshless runs and against the JAX reference (cavif_tpu).

A band is exact by construction: with one superblock row of halo and the
band's global first row, every block sees what it sees in the whole plane.
So the band neighbours and the band programs must equal the whole plane's
exactly, and the four-process gloo rehearsal (data = 2, tile = 2) must give
on every rank the bytes of the meshless run. Against the reference the
port keeps its standing tolerances: the block search's costs within
rtol 1e-4 + atol 8 with equal modes and codes (tests/test_torch_block_search
.py), pass 1's grids differing on fewer than 1e-3 of the entries (the
decision-module rule)."""

import hashlib
import io
import os
import socket
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from PIL import Image

import cavif_tpu_torch
from cavif_tpu.ops import block_search as ref_bs
from cavif_tpu.ops import device_pass1 as ref_dp
from cavif_tpu_torch.container.parse import read_avif
from cavif_tpu_torch.ops import block_search as bs
from cavif_tpu_torch.ops import device_pass1 as dp
from cavif_tpu_torch.parallel import batch as pbatch
from cavif_tpu_torch.parallel import mesh as shard
from cavif_tpu_torch.parallel import plane_mode_search_batch

ROOT = str(Path(__file__).resolve().parent.parent)
DC_Q, AC_Q, LAM = 499, 616, 296.45
SEARCH = (499, 616, 30.0, 10)  # dc_q, ac_q, lam, bit depth of the search
P1_KW = dict(depth=10, tile_px=(128, 64), min_px=8, max_px=64,
             use_deltas=False, dc_q=DC_Q, ac_q=AC_Q, lam=LAM)
PASS1_SHAPES = [(s, s) for s in (4, 8, 16, 32, 64)] + list(dp.RECT_SHAPES)
TILE_SPLITS = [(64, 64), (128, 64), (192, 128)]
PARTS = ("pass1_ycbcr", "pass1_mono", "partition", "mode_batch", "encode")


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    lum = np.clip(120 + 70 * np.sin(x / 23.0) * np.cos(y / 17.0)
                  + rng.normal(0, 6, x.shape), 0, 255)
    return np.dstack([lum, np.clip(lum + 15, 0, 255),
                      np.clip(lum - 20, 0, 255)]).astype(np.uint8)


def _planes(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 1024, (n, h, w)).astype(
        np.int32)


def _inputs() -> dict:
    """Every input of the rehearsal, made from seeds: pass 1's two-image
    batch (3 superblock rows: bands of 2 and 1 over tile = 2, the second
    band starting on row 128, a tile row of tile_px (128, 64) only
    globally), the block-search planes of tests/test_parallel.py, three
    planes of 96 rows for plane_mode_search_batch (shares of 2 and 1
    planes and of 2 and 1 block rows), and the mixed images of
    tests/test_multihost.py:142-154."""
    rng = np.random.default_rng(0)
    imgs = [
        rng.integers(0, 256, (128, 192, 3), np.uint8),
        rng.integers(0, 256, (96, 128, 3), np.uint8),
        rng.integers(0, 256, (128, 192, 3), np.uint8),
    ]
    rgba = rng.integers(0, 256, (128, 192, 4), np.uint8)
    rgba[..., 3] = 255
    rgba[30:90, 40:150, 3] = rng.integers(0, 255, (60, 110), np.uint8)
    srcs = np.stack([_image(192, 128, 1), _image(192, 128, 2)])
    return dict(
        srcs=srcs, mono=np.ascontiguousarray(srcs[..., 1]),
        planes=np.random.default_rng(3).integers(0, 1024, (4, 128, 128))
        .astype(np.int32),
        planes32=_planes(3, 96, 64, 1),
        img0=imgs[0], img1=imgs[1], img2=imgs[2], img3=rgba,
    )


def _encoder():
    return replace(cavif_tpu_torch.Encoder.new().with_quality(70)
                   .with_speed(4), device="cpu")


def _run_all(x: dict, mesh) -> dict:
    """Every mesh entry point on the inputs, as {part: {name: array}}."""
    out = {p: {} for p in PARTS}
    for part, src, model in (("pass1_ycbcr", x["srcs"], "ycbcr"),
                             ("pass1_mono", x["mono"], "mono")):
        grids = dp.run_pass1_batch(src, model=model, mesh=mesh,
                                   device="cpu", **P1_KW)
        for b, g in enumerate(grids):
            for ((bw, bh), name), v in g.items():
                out[part][f"{b}/{bw}x{bh}/{name}"] = v
    tiers, codes = bs.plane_partition_search(x["planes"], *SEARCH,
                                             mesh=mesh, device="cpu")
    for n, (m, c) in tiers.items():
        out["partition"][f"modes{n}"] = m
        out["partition"][f"costs{n}"] = c
    for n, c in codes.items():
        out["partition"][f"codes{n}"] = c
    out["mode_batch"]["modes"] = plane_mode_search_batch(
        x["planes32"], *SEARCH, mesh=mesh, device="cpu")
    imgs = [x[f"img{i}"] for i in range(4)]
    for i, data in enumerate(pbatch.encode_batch_sharded(imgs, _encoder(),
                                                         mesh=mesh)):
        out["encode"][f"avif{i}"] = np.frombuffer(data, np.uint8)
    return out


def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        v = np.ascontiguousarray(arrays[k])
        h.update(f"{k}:{v.dtype}:{v.shape}".encode())
        h.update(v.tobytes())
    return h.hexdigest()


def _flat(out: dict) -> dict:
    return {f"{p}/{k}": v for p, d in out.items() for k, v in d.items()}


# One rank of the rehearsal: gloo on the CPU, the kernels' plain versions.
# argv: rank, world size, port, data size, tile size, output directory.
WORKER = f"""
import os, sys
from datetime import timedelta
sys.path.insert(0, {ROOT!r})
sys.path.insert(0, {str(Path(__file__).resolve().parent)!r})
rank, world, port, dn, tn = (int(a) for a in sys.argv[1:6])
out_dir = sys.argv[6]
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                        world_size=world, rank=rank,
                        timeout=timedelta(seconds=300))
from torch.distributed.device_mesh import init_device_mesh
mesh = init_device_mesh("cpu", (dn, tn), mesh_dim_names=("data", "tile"))
print("joined", flush=True)
import test_torch_mesh as T
x = T._inputs()
res = T._flat(T._run_all(x, mesh))
def refuses(call):
    try:
        call()
    except ValueError:
        return True
    return False
if dn == 1:
    odd = init_device_mesh("cpu", (1,), mesh_dim_names=("rows",))
    res["refused"] = np.asarray(refuses(lambda: T.bs.plane_mode_search(
        x["planes32"], *T.SEARCH, mesh=odd, device="cpu")))
np.savez(os.path.join(out_dir, f"rank{{rank}}.npz"), **res)
dist.barrier()
dist.destroy_process_group()
print("done", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(world, dn, tn, out_dir):
    port = _free_port()
    env = {**os.environ, "CAVIF_TPU_SHARDED_STEAL": "0",
           "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(port),
         str(dn), str(tn), str(out_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def _finish(procs, deadline):
    """Wait for every worker; kill them all on the first timeout. Returns
    [(rc, stdout, stderr)]."""
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            raise
        outs.append((p.returncode, out, err))
    return outs


def _rendezvous_timed_out(outs) -> bool:
    """A rank that never joined the group, with a timeout in its error:
    the TCP rendezvous of a loaded machine, not a result."""
    return any(rc != 0 and "joined" not in out and "timed out" in err.lower()
               for rc, out, err in outs)


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """The four-rank (2, 2) and the one-rank (1, 1) gloo runs, started
    together, beside the meshless run in this process. Returns
    ({rank: arrays} of the (2, 2) mesh, arrays of the (1, 1) mesh,
    meshless arrays). The rendezvous is retried once, on fresh ports, when
    it timed out."""
    for attempt in range(2):
        d4 = tmp_path_factory.mktemp("mesh22")
        d1 = tmp_path_factory.mktemp("mesh11")
        groups = [_start(4, 2, 2, d4), _start(1, 1, 1, d1)]
        try:
            if attempt == 0:
                threads = torch.get_num_threads()
                mp = pytest.MonkeyPatch()
                mp.setenv("CAVIF_TPU_SHARDED_STEAL", "0")
                torch.set_num_threads(1)
                try:
                    meshless = _flat(_run_all(_inputs(), None))
                finally:
                    torch.set_num_threads(threads)
                    mp.undo()
            deadline = time.time() + 420
            outs = [_finish(g, deadline) for g in groups]
        except BaseException:
            for g in groups:
                for p in g:
                    p.kill()
            raise
        flat = [o for g in outs for o in g]
        if attempt == 0 and _rendezvous_timed_out(flat):
            continue
        for rc, out, err in flat:
            assert rc == 0 and "done" in out, err[-3000:]
        ranks = {r: dict(np.load(d4 / f"rank{r}.npz")) for r in range(4)}
        return ranks, dict(np.load(d1 / "rank0.npz")), meshless
    raise AssertionError("unreachable")


def _part(arrays: dict, part: str) -> dict:
    return {k: v for k, v in arrays.items() if k.startswith(part + "/")}


# -- exact bands -----------------------------------------------------------


def _band_cases(H, unit):
    """Every band of H split over tile = 2, 3 and 4, with its halo."""
    for tile in (2, 3, 4):
        for band in shard.bands(H, unit, tile):
            yield band, shard.halo(band, H, unit)


@pytest.mark.parametrize("tile_px", TILE_SPLITS, ids=str)
@pytest.mark.parametrize("shape", PASS1_SHAPES, ids=str)
def test_pass1_band_neighbours_are_exact(shape, tile_px):
    """_nbrs of a halo'd band with its global first row, cropped, equals
    the whole plane's, at every band edge (on a tile row or not)."""
    bw, bh = shape
    planes = torch.from_numpy(_planes(3, 7 * 64, 128, 5))
    whole = dp._nbrs(planes, bw, bh, 10, tile_px)
    for (y0, y1), (h0, h1) in _band_cases(7 * 64, 64):
        band = dp._nbrs(planes[:, h0:h1], bw, bh, 10, tile_px, row0=h0)
        r0, r1 = (y0 - h0) // bh, (y1 - h0) // bh
        for k in ("above_s", "left_s", "al_s", "dc", "ext"):
            assert torch.equal(band[k][:, r0:r1],
                               whole[k][:, y0 // bh : y1 // bh]), (k, y0, y1)


def test_pass1_band_neighbours_need_the_global_row():
    """Without its global first row, a band whose halo starts off a tile
    row sees a tile boundary that is not there (row 128 is a tile row of
    tile_px (128, 64), its local row 64 is not)."""
    planes = torch.from_numpy(_planes(1, 192, 64, 6))
    whole = dp._nbrs(planes, 8, 8, 10, (128, 64))
    band = dp._nbrs(planes[:, 64:], 8, 8, 10, (128, 64))
    assert not torch.equal(band["ext"][:, 8:], whole["ext"][:, 16:])


@pytest.mark.parametrize("n", (4, 8, 16, 32))
def test_search_band_neighbours_are_exact(n):
    """The block search's _neighbors on a band with max_n = 32 rows of
    halo, cropped, equals the whole plane's: it needs no band offset."""
    planes = torch.from_numpy(_planes(2, 7 * 32, 96, 7))
    whole = bs._neighbors(planes, n, 10)
    for (y0, y1), (h0, h1) in _band_cases(7 * 32, 32):
        band = bs._neighbors(planes[:, h0:h1], n, 10)
        r0, r1 = (y0 - h0) // n, (y1 - h0) // n
        for k, v in whole.items():
            assert torch.equal(band[k][:, r0:r1], v[:, y0 // n : y1 // n]), \
                (k, y0, y1)


@pytest.mark.parametrize("model", ["ycbcr", "mono"])
def test_band_programs_stack_to_the_whole_program(model):
    """Pass1Program on the halo'd bands of a two-image batch, each grid
    cropped to its band and the bands stacked, equals the whole program's
    packed output exactly (bands of 2, 2 and 1 superblock rows; tile rows
    every 192 px, so two band edges fall inside a tile)."""
    H, W, P = 5 * 64, 64, 3 if model == "ycbcr" else 1
    imgs = np.stack([_image(H, W, 8), _image(H, W, 9)])
    src = torch.from_numpy(imgs if model == "ycbcr"
                           else np.ascontiguousarray(imgs[..., 0]))
    key = (10, model, P, 8, 64, True, 23.0, 2.0, 4.0)
    args = (dp._f32(DC_Q), dp._f32(AC_Q), dp._f32(LAM), 192, 64)
    with torch.inference_mode():
        whole = dp._program((H, W) + key, "f32", "cpu")(src, *args)
        parts = []
        for (y0, y1) in shard.bands(H, 64, 3):
            h0, h1 = shard.halo((y0, y1), H, 64)
            prog = dp._program((h1 - h0, W) + key, "f32", "cpu")
            parts.append((y0, y1, h0, prog.spec,
                          prog(src[:, h0:h1], *args, row0=h0)))
    spec = dp.program_spec(H, W, P, 8, 64)
    assert spec == dp._program((H, W) + key, "f32", "cpu").spec
    off = [0] * len(parts)
    got = []
    for k, ((bw, bh), name, (nby, nbx)) in enumerate(spec):
        rows = []
        for i, (y0, y1, h0, pspec, packed) in enumerate(parts):
            nby_band = pspec[k][2][0]
            g = packed[:, off[i] : off[i] + nby_band * nbx]
            rows.append(g.reshape(2, nby_band, nbx)
                        [:, (y0 - h0) // bh : (y1 - h0) // bh])
            off[i] += nby_band * nbx
        got.append(torch.cat(rows, 1).reshape(2, -1))
    assert torch.equal(torch.cat(got, 1), whole)


# -- the gloo rehearsal ----------------------------------------------------


def test_mesh_ranks_agree(rehearsal):
    ranks, _, _ = rehearsal
    digests = {r: _digest(a) for r, a in ranks.items()}
    assert len(set(digests.values())) == 1, digests


@pytest.mark.parametrize("part", PARTS)
def test_mesh_equals_meshless(rehearsal, part):
    """Rank 0 of the (2, 2) mesh returns the meshless run's arrays and
    AVIF bytes exactly (digests of each part)."""
    ranks, _, meshless = rehearsal
    got, ref = _part(ranks[0], part), _part(meshless, part)
    assert sorted(got) == sorted(ref)
    assert _digest(got) == _digest(ref), [
        k for k in ref if not np.array_equal(got[k], ref[k])]


def test_mesh_encode_decodes_with_alpha(rehearsal):
    ranks, _, _ = rehearsal
    avifs = [ranks[0][f"encode/avif{i}"].tobytes() for i in range(4)]
    for data, (h, w) in zip(avifs, [(128, 192), (96, 128), (128, 192),
                                    (128, 192)]):
        dec = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert dec.shape[:2] == (h, w)
    assert read_avif(avifs[3]).alpha_item, "alpha stream missing"


def test_uneven_plane_batch_is_sharded_where_the_reference_refuses(
        rehearsal):
    """N = 3 planes over data = 2: the reference's NamedSharding raises
    ValueError, while the port gives the ranks 2 and 1 planes (as the
    reference's run_pass1_batch pads its B) and returns the meshless
    modes."""
    ranks, _, meshless = rehearsal
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    planes = _inputs()["planes32"]
    assert planes.shape[0] == 3
    with pytest.raises(ValueError):
        ref_bs.plane_partition_search(planes, *SEARCH,
                                      mesh=Mesh(devs, ("data", "tile")))
    assert np.array_equal(ranks[0]["mode_batch/modes"],
                          meshless["mode_batch/modes"])


def test_one_rank_mesh_equals_meshless(rehearsal):
    """A (1, 1) mesh gives the meshless bytes; a mesh named other than
    "data" / "tile" raises ValueError."""
    _, one, meshless = rehearsal
    assert int(one.pop("refused")) == 1
    assert _digest(one) == _digest(meshless)


def test_mesh_refuses_what_is_not_a_mesh():
    x = _inputs()
    for call in (
        lambda m: dp.run_pass1_batch(x["mono"], model="mono", mesh=m,
                                     device="cpu", **P1_KW),
        lambda m: bs.plane_partition_search(x["planes"], *SEARCH, mesh=m,
                                            device="cpu"),
        lambda m: plane_mode_search_batch(x["planes32"], *SEARCH, mesh=m,
                                          device="cpu"),
        lambda m: pbatch.encode_batch_sharded([x["img1"]], _encoder(),
                                              mesh=m),
    ):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call(object())


@pytest.mark.parametrize("H, tile", [(64, 3), (64, 5), (64, 7)])
def test_indivisible_rows_refused_like_the_reference(H, tile):
    """H not divisible by the tile axis: the reference's run_pass1_batch
    raises ValueError at its NamedSharding, and the port's check does too
    (the mesh entry points call it before any rank computes)."""
    devs = np.array(jax.devices()[:tile]).reshape(1, tile)
    src = np.zeros((2, H, 64), np.uint8)
    with pytest.raises(ValueError):
        ref_dp.run_pass1_batch(src, model="mono", **P1_KW,
                               mesh=Mesh(devs, ("data", "tile")))
    with pytest.raises(ValueError, match="tile"):
        shard.check_divisible("H", H, tile, "tile")


# -- against the reference -------------------------------------------------


def test_partition_search_mesh_matches_reference_mesh(rehearsal):
    """The reference's plane_partition_search over Mesh((4, 2)) on the
    conftest's virtual CPU devices against the port's (2, 2) rehearsal on
    the same planes: modes and codes equal, costs within rtol 1e-4 +
    atol 8."""
    ranks, _, _ = rehearsal
    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    tiers, codes = ref_bs.plane_partition_search(
        _inputs()["planes"], *SEARCH, mesh=Mesh(devs, ("data", "tile")))
    got = ranks[0]
    for n, (m, c) in tiers.items():
        assert np.array_equal(got[f"partition/modes{n}"], m), n
        np.testing.assert_allclose(got[f"partition/costs{n}"], c,
                                   rtol=1e-4, atol=8)
    for n, c in codes.items():
        assert np.array_equal(got[f"partition/codes{n}"], c), n


@pytest.mark.parametrize("model", ["ycbcr", "mono"])
def test_pass1_mesh_matches_reference(rehearsal, model):
    """The port's mesh grids against the reference's meshless
    run_pass1_batch: fewer than 1e-3 of the entries differ."""
    ranks, _, _ = rehearsal
    x = _inputs()
    ref = ref_dp.run_pass1_batch(x["srcs"] if model == "ycbcr" else x["mono"],
                                 model=model, **P1_KW)
    got = _part(ranks[0], f"pass1_{model}")
    diff = tot = 0
    for b, g in enumerate(ref):
        for ((bw, bh), name), v in g.items():
            mine = got[f"pass1_{model}/{b}/{bw}x{bh}/{name}"]
            assert mine.shape == v.shape and mine.dtype == v.dtype
            diff += int((mine != v).sum())
            tot += v.size
    print(f"\n{model}: the mesh grids differ from the reference's on {diff} "
          f"of {tot}")
    assert diff < 1e-3 * tot
