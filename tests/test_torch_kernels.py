"""The two pass-1 kernel wrappers of the PyTorch/CUDA port and their
constant tables (the system's "weights").

On the CPU a wrapper runs its plain PyTorch version and launches nothing;
the CUDA kernels themselves are checked against those plain versions on the
card by chip_smoke.py. The constant tables the port builds must be
bit-equal to the ones cavif_tpu's numpy builders give, for every block
shape and flag, and ShapeCost must run from the reference's own dict."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cavif_tpu.av1 import tables as ref_tables
from cavif_tpu.av1.transforms import AC_BIAS, dct2_matrix, get_gain
from cavif_tpu.ops import device_pass1 as ref_dp
from cavif_tpu_torch.ops import device_pass1 as dp
from cavif_tpu_torch.ops import pass1_kernels as pk

ROOT = Path(__file__).resolve().parent.parent
ALL_SHAPES = [(s, s) for s in dp.SQ_TIERS + (64,)] + list(dp.RECT_SHAPES)


@pytest.fixture(scope="module", autouse=True)
def _close_reference_tables():
    """Reading the reference's tables leaves its .npz archive open in this
    process. A later test in the same worker that forks a process pool
    (tests/test_parallel.py) would hand that one file offset to every
    child, and their concurrent reads fail (BadZipFile). Close it when the
    module is done; the next reader reopens it."""
    yield
    from cavif_tpu.av1 import tables

    if tables._npz.cache_info().currsize:
        tables._npz().close()
        tables._npz.cache_clear()


def _ref_consts(bw, bh, use_deltas):
    """The constant tables of cavif_tpu's _cost_body, built with its own
    numpy builders, under the port's key names."""
    dirs = ref_dp._dir_cands(use_deltas)
    mdir = ref_dp._dir_matrix(dirs, bw, bh)
    _, _, pen = ref_dp._cand_tables(use_deltas)
    n2 = bh * bw
    cw_c, ch_c = min(bw, 32), min(bh, 32)
    ncoded = cw_c * ch_c
    coded_idx = np.asarray(
        [r * bw + c for r in range(ch_c) for c in range(cw_c)], np.int64)
    kron_f64 = np.kron(dct2_matrix(bh, np.float64),
                       dct2_matrix(bw, np.float64)).T[:, coded_idx]
    sm_h = np.asarray(ref_tables.get(f"sm_weights_{bh}"), np.int32)
    sm_w = np.asarray(ref_tables.get(f"sm_weights_{bw}"), np.int32)
    out = dict(
        mdir=mdir,
        kt=np.ascontiguousarray(kron_f64.astype(np.float32)),
        whv=np.asarray([float(sm_h[y]) for y in range(bh) for _ in range(bw)],
                       np.float32),
        wwv=np.asarray([float(sm_w[x]) for _ in range(bh) for x in range(bw)],
                       np.float32),
        pen=pen,
        gain=np.asarray(np.float32(get_gain(cw_c, ch_c))),
        ac_bias=np.asarray(AC_BIAS, np.float32),
    )
    if ncoded == n2:
        E, cdir = mdir.shape[0], len(dirs)
        mk3 = np.einsum("ecj,jk->eck",
                        mdir.astype(np.float64).reshape(E, cdir, n2), kron_f64)
        out["mk"] = np.ascontiguousarray(
            mk3.reshape(E, cdir * ncoded).astype(np.float32))
        out["cc"] = (0.5 * kron_f64.sum(axis=0)).astype(np.float32)
    return out


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__ or ())))


def _bf16_bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("use_deltas", [False, True])
@pytest.mark.parametrize("bw,bh", ALL_SHAPES)
def test_constants_bit_equal(bw, bh, use_deltas):
    ref = _ref_consts(bw, bh, use_deltas)
    mine = dp.shape_consts(bw, bh, use_deltas)
    assert sorted(ref) == sorted(mine)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(mine[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    # the bf16 matrices the kernels read round like the reference's
    # pre-rounded Pallas constants (RNE)
    if "mk" in mine:
        body = ref_dp._cost_body(bw, bh, 10, use_deltas, False)
        cl = _closure(body)
        cl_dir = _closure(cl["_fused_dir_cost"])
        cl_nd = _closure(cl["_fused_nd_cost"])
        sc = dp.ShapeCost(bw, bh, 10, use_deltas, "bf16")
        ncols = sc.cdir * sc.n2
        assert np.array_equal(_bf16_bits(sc.mk),
                              _bf16_bits(cl_dir["_mk_bf16"][:, :ncols]))
        assert np.array_equal(_bf16_bits(sc.kt), _bf16_bits(cl_nd["_kt_bf16"]))
        assert np.array_equal(sc.whv.numpy(), cl_nd["_whv"][0])
        assert np.array_equal(sc.wwv.numpy(), cl_nd["_wwv"][0])


@pytest.mark.parametrize("bw,bh", [(8, 8), (32, 16), (64, 64)])
def test_shape_cost_runs_from_reference_dict(bw, bh):
    ud = min(bw, bh) >= 8 and max(bw, bh) < 64
    rng = np.random.default_rng(3)
    planes = torch.from_numpy(
        rng.integers(0, 1024, (3, 128, 128)).astype(np.int32))
    a = dp.ShapeCost.from_numpy(_ref_consts(bw, bh, ud), bw=bw, bh=bh,
                                depth=10, use_deltas=ud)
    b = dp.ShapeCost(bw, bh, 10, ud)
    args = (planes, 499.0, 616.0, 296.45, (64, 128))
    assert torch.equal(a(*args), b(*args))


def _kernel_args(bw, bh, R, matmul):
    rng = np.random.default_rng(11)
    ud = min(bw, bh) >= 8
    sc = dp.ShapeCost(bw, bh, 10, ud, matmul)
    n2, E = sc.n2, sc.E
    f = lambda *s: torch.from_numpy(rng.uniform(0, 1023, s).astype(np.float32))
    q = torch.from_numpy(dp._lane_quant(n2, 120, 150, sc.gain, sc.ac_bias))
    quant = dict(inv=q[0], scale=q[1], bias=q[2], lam=40.0)
    blocks = f(R, n2).floor()
    nd = dict(above=f(R, bw).floor(), left=f(R, bh).floor(),
              sc=f(R, 2).floor(), blocks=blocks, kt=sc.kt, whv=sc.whv,
              wwv=sc.wwv, **quant)
    dr = dict(ext=f(R, E).floor(), bkt=pk._mm(blocks, sc.kt), mk=sc.mk,
              cc=sc.cc, **quant)
    return nd, dr


@pytest.mark.parametrize("matmul", ["f32", "bf16"])
@pytest.mark.parametrize("bw,bh", [(4, 4), (16, 8), (32, 32)])
def test_wrappers_take_plain_version_on_cpu(bw, bh, matmul):
    nd, dr = _kernel_args(bw, bh, 37, matmul)
    pk.reset_launches()
    got_nd = pk.nd_cost(**nd)
    got_dr = pk.dir_cost(**dr)
    assert pk.LAUNCHES == {"dir_cost": 0, "nd_cost": 0}
    assert torch.equal(got_nd, pk.nd_cost_ref(**nd))
    assert torch.equal(got_dr, pk.dir_cost_ref(**dr))
    assert got_nd.shape == (37, 5) and got_dr.dtype == torch.float32
    cdir = dr["mk"].shape[1] // (bw * bh)
    assert got_dr.shape == (37, cdir)
    assert bool(torch.isfinite(got_nd).all() and torch.isfinite(got_dr).all())


def test_plain_versions_match_materialized_chain():
    """The |coef|-domain lane cost of the plain versions equals the
    sign-split quantizer chain of the reference's XLA path."""
    nd, dr = _kernel_args(16, 16, 23, "f32")
    R, n2 = dr["bkt"].shape
    cp = dr["ext"] @ dr["mk"]
    coef = dr["bkt"][:, None, :] - (cp.view(R, -1, n2) * (1.0 / 32.0)
                                    + dr["cc"])
    t = coef * dr["inv"]
    lv = torch.sign(t) * torch.floor(t.abs() + dr["bias"])
    errc = coef - lv * dr["scale"]
    u = errc * errc + dr["lam"] * (lv.abs() + 2.0 * (lv != 0.0))
    torch.testing.assert_close(pk.dir_cost_ref(**dr), u.sum(-1),
                               rtol=1e-6, atol=0.0)


def test_import_needs_no_nvcc_or_gpu():
    """Importing the kernels modules (and the whole port) and running the
    wrappers on CPU tensors never starts nvcc."""
    code = f"""
import subprocess, sys
sys.path.insert(0, {str(ROOT)!r})
def refuse(*a, **k):
    raise AssertionError("a process was started: %r" % (a,))
subprocess.Popen = refuse
import torch
import cavif_tpu_torch
from cavif_tpu_torch.ops import block_search as bs
from cavif_tpu_torch.ops import cuda_build
from cavif_tpu_torch.ops import pass1_kernels as pk
from cavif_tpu_torch.ops import search_kernels as sk
from cavif_tpu_torch.ops import proto_kernels as prk
from cavif_tpu_torch.tools import dir_ablation, dir_proto
mk = torch.zeros(17, 8 * 16)
v = torch.zeros(16)
out = pk.dir_cost(torch.zeros(4, 17), torch.zeros(4, 16), mk, v, v, v, v, 1.0)
assert out.shape == (4, 8)
planes = torch.zeros(1, 16, 16, dtype=torch.int32)
kw = bs.search_inputs(planes, 8, 10, 100, 120, 30.0)
assert sk.mode_cost(**kw).shape == (4, 13)
args = (torch.zeros(4, 17), torch.zeros(4, 16), mk.bfloat16(), v, v, v, v, 1.0)
assert prk.fused_dir_cost(*args, reduce="loop").shape == (4, 8)
assert prk.dir_ablation(*args, variant="no_sign").shape == (4, 8)
assert cuda_build._libs == {{}}
assert prk.LAUNCHES == {{"fused_dir_cost": 0, "dir_ablation": 0}}
assert pk.LAUNCHES == {{"dir_cost": 0, "nd_cost": 0}}
assert sk.LAUNCHES == {{"mode_cost": 0}}
print("ok")
"""
    env = {**os.environ, "PATH": "/usr/bin:/bin",
           "CUDA_HOME": "/nonexistent", "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
