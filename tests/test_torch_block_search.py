"""The whole-plane block search of the PyTorch/CUDA port
(cavif_tpu_torch.ops.block_search, kernel K3's plain version in
ops/search_kernels.py) held against the JAX reference
(cavif_tpu.ops.block_search and ops/pallas_search.py) on the CPU.

The same seeded numpy planes go through both. The port runs on the CPU,
where its K3 wrapper takes the plain PyTorch version; the reference runs its
XLA formulation, and its Pallas kernel in the Pallas interpreter.

Tolerances. Neighbours and predictors are integers and must be equal. The
costs pass a float DCT and then floor() at every quantizer level: two f32
summation orders that differ in the last bit can move a coefficient across a
level boundary and change that (block, candidate) cost by about lambda.
So fewer than 1e-3 of the (block, candidate) costs may differ by more than
rtol 1e-4 plus atol 8 (the policy of tests/test_torch_pass1.py), and the
picked modes must be equal except where the reference itself prices the
two picks within rtol 1e-5 (a near-tie, often exact: two predictors that
give the same block), which summation order alone decides. The reference's
XLA search returns only argmin and min; its 13 costs per block are read at
its own argmin call. At n = 32 the reference's Pallas kernel rounds its
products to bf16, so the port is held there to the reference's own
bf16 standard (tests/test_pallas_search.py:108-119)."""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavif_tpu.av1.predict import predict_dir_batch as ref_predict_dir_batch
from cavif_tpu.ops import block_search as ref_bs
from cavif_tpu.ops import pallas_search as ref_ps
from cavif_tpu_torch.av1.predict import predict_dir_batch
from cavif_tpu_torch.ops import block_search as bs
from cavif_tpu_torch.ops import search_kernels as sk

SIZES = (4, 8, 16, 32)
# quantizers of a Q80 10-bit frame; lambda of tests/test_pallas_search.py
DC_Q, AC_Q, LAM = 499, 616, 30.0


def _planes(h, w, seed, count=2):
    """Diagonal ramps plus noise, as tests/test_pallas_search.py makes them,
    and a smooth shaded plane (many near-flat blocks, where ties live)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    ramp = np.clip(((x * 5 + y * 3) % 1024) + rng.integers(-80, 80, (h, w)),
                   0, 1023)
    smooth = np.clip(512 + 300 * np.sin(x / 21.0) * np.cos(y / 13.0)
                     + rng.normal(0, 4, (h, w)), 0, 1023)
    out = [ramp, ramp[::-1], smooth, smooth[:, ::-1]][:count]
    return np.ascontiguousarray(np.stack(out).astype(np.int32))


@lru_cache(maxsize=None)
def _ref_search(n):
    """The reference XLA search of tier n, jitted, returning its
    (N, nby, nbx, 13) costs (taken where the search calls argmin over
    them) beside its (modes, min costs)."""
    search = ref_bs._search_body(n, 10)

    def run(planes, dc_q, ac_q, lam):
        seen = {}
        argmin = jnp.argmin

        def grab(x, axis=None, **kw):
            seen["cost"] = x
            return argmin(x, axis=axis, **kw)

        jnp.argmin = grab
        try:
            modes, mins = search(planes, dc_q, ac_q, lam)
        finally:
            jnp.argmin = argmin
        return seen["cost"], modes, mins

    return jax.jit(run)


def _ref_costs(planes, n, lam=LAM):
    out = _ref_search(n)(jnp.asarray(planes), jnp.float32(DC_Q),
                         jnp.float32(AC_Q), jnp.float32(lam))
    return tuple(np.asarray(v) for v in out)


def _port_costs(planes, n, lam=LAM, dtype=torch.float32):
    kw = bs.search_inputs(torch.from_numpy(planes), n, 10, DC_Q, AC_Q, lam)
    kw["dct"] = kw["dct"].to(dtype)
    N, H, W = planes.shape
    return sk.mode_cost_ref(**kw).view(N, H // n, W // n, -1).numpy()


def _hold(ref, got, label, costs=True):
    """The policy of the module docstring on full (..., 13) cost tensors,
    printing the counts (pytest -s shows them). Returns the number of
    costs beyond rtol 1e-4 + atol 8; costs=False leaves that count to
    the caller."""
    blocks = ref[..., 0].size
    pick = got.argmin(-1)
    ref_min = ref.min(-1)
    ref_at_pick = np.take_along_axis(ref, pick[..., None], -1)[..., 0]
    flips = pick != ref.argmin(-1)
    gap = (ref_at_pick - ref_min) / np.abs(ref_min)
    real = int((flips & (gap > 1e-5)).sum())
    d = np.abs(got - ref)
    off = int((d > 1e-4 * np.abs(ref) + 8.0).sum())
    print(f"\n{label}: argmin flips {int(flips.sum())} of {blocks} "
          f"({real} beyond near-ties); costs beyond rtol 1e-4 + atol 8 "
          f"{off} of {ref.size}; max |d| {float(d.max()):.4g}")
    assert real == 0, (real, int(flips.sum()), blocks)
    assert off < 1e-3 * ref.size or not costs, (off, ref.size)
    return off


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("n", SIZES)
def test_neighbors_exact(n, depth):
    rng = np.random.default_rng(n + depth)
    planes = rng.integers(0, 1 << depth, (2, 4 * n, 6 * n)).astype(np.int32)
    ref = ref_bs._neighbors(jnp.asarray(planes), n, depth)
    got = bs._neighbors(torch.from_numpy(planes), n, depth)
    assert sorted(ref) == sorted(got)
    for k, v in ref.items():
        r = np.asarray(v)
        g = got[k].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, k
        assert np.array_equal(g, r), k


@pytest.mark.parametrize("n", SIZES)
def test_dir_preds_exact(n):
    """The two-tap table reproduces the port's predict_dir_batch (and the
    reference's) bit for bit for the six diagonals at delta 0."""
    rng = np.random.default_rng(3)
    B = 9
    ae = rng.integers(0, 1024, (B, 2 * n))
    le = rng.integers(0, 1024, (B, 2 * n))
    al = rng.integers(0, 1024, (B,))
    want = predict_dir_batch(list(sk.DIAG_MODES), ae, le, al, n, n)
    assert np.array_equal(
        want, ref_predict_dir_batch(list(ref_bs.DIAG_MODES), ae, le, al, n, n))
    ext = torch.from_numpy(
        np.concatenate([al[:, None], ae, le], 1).astype(np.int32))
    got = sk.dir_preds(ext, torch.from_numpy(sk.dir_taps(n)))
    assert np.array_equal(got.view(B, 6, n, n).numpy(), want)


@pytest.mark.parametrize("n", SIZES)
def test_dir_taps_equal_reference_matrix(n):
    """The tap table, written as a dense matrix, is the reference's
    constant directional matrix pallas_search._dir_matrix(n)."""
    e0, w0, e1, w1 = (t.numpy() for t in sk._unpack_taps(
        torch.from_numpy(sk.dir_taps(n))))
    dense = np.zeros((4 * n + 1, 6 * n * n))
    cols = np.arange(6 * n * n)
    np.add.at(dense, (e0.reshape(-1), cols), w0.reshape(-1))
    np.add.at(dense, (e1.reshape(-1), cols), w1.reshape(-1))
    assert np.array_equal(dense.astype(np.float32), ref_ps._dir_matrix(n))


@pytest.mark.parametrize("n", SIZES)
def test_mode_cost_ref_matches_search_body(n):
    """K3's plain version against the reference's XLA search: all 13
    costs of every block, the picked modes and the min costs."""
    planes = _planes(128, 128, n, count=4)
    ref, ref_modes, ref_mins = _ref_costs(planes, n)
    got = _port_costs(planes, n)
    assert got.shape == ref.shape == ref_modes.shape + (13,)
    _hold(ref, got, f"n={n} vs XLA")
    modes, mins = bs.plane_mode_search_costs(planes, DC_Q, AC_Q, LAM, 10,
                                             n=n, device="cpu")
    assert modes.dtype == np.int8 and mins.dtype == np.float32
    assert np.array_equal(modes, got.argmin(-1))
    assert np.array_equal(mins, got.min(-1))
    d = np.abs(mins - ref_mins)
    assert int((d > 1e-4 * np.abs(ref_mins) + 8.0).sum()) < 1e-3 * d.size


def _pallas_costs(planes, n, chunk=8):
    N, H, W = planes.shape
    tensors = ref_ps._prep(n, 10)(jnp.asarray(planes))
    qvec = jnp.asarray([[float(DC_Q), float(AC_Q), float(LAM)]], jnp.float32)
    run = ref_ps._pallas_kernel(n, 10, chunk, True)
    costs = np.asarray(run(*tensors, qvec))[:, :13]
    return costs.reshape(N, H // n, W // n, 13)


def test_mode_cost_ref_matches_pallas_interpreter_n16():
    """Against the reference's Pallas kernel (f32 at n = 16) in the
    interpreter, as tests/test_pallas_search.py runs it."""
    planes = _planes(64, 64, 11)
    ref = _pallas_costs(planes, 16)
    got = _port_costs(planes, 16)
    _hold(ref, got, "n=16 vs Pallas")
    modes = bs.plane_mode_search(planes, DC_Q, AC_Q, LAM, 10, n=16,
                                 device="cpu")
    want = ref_ps.plane_mode_search_pallas(planes, DC_Q, AC_Q, LAM, 10,
                                           n=16, chunk=8, interpret=True)
    assert np.array_equal(want, ref.argmin(-1))
    assert np.array_equal(modes, got.argmin(-1))


def test_mode_cost_ref_matches_pallas_interpreter_n32():
    """At n = 32 the Pallas kernel rounds ext, the directional matrix, the
    residual and the Kronecker DCT to bf16; the port stays in f32. The
    reference's own standard for that tier: the picks agree on at least
    3/4 of the blocks, and where they differ the port's pick costs at
    most 2% more than the Pallas pick under a float64 oracle (the port's
    plain version in float64)."""
    planes = _planes(128, 128, 11)
    pallas = _pallas_costs(planes, 32)
    got = _port_costs(planes, 32)
    oracle = _port_costs(planes, 32, dtype=torch.float64)
    pm, gm = pallas.argmin(-1), got.argmin(-1)
    agree = float((pm == gm).mean())
    print(f"\nn=32 vs Pallas (bf16): modes agree on {agree:.3f}")
    assert agree >= 0.75, agree
    for idx in np.argwhere(pm != gm):
        c = oracle[tuple(idx)]
        g, r = int(gm[tuple(idx)]), int(pm[tuple(idx)])
        assert c[g] <= c[r] * 1.02, (tuple(idx), g, r, c[g], c[r])
    rel = np.abs(pallas.min(-1) - got.min(-1)) / (np.abs(got.min(-1)) + 1.0)
    assert float(np.median(rel)) < 0.02


def test_plane_partition_search_matches_reference():
    """Multi-tier search + NONE/SPLIT DP on 4 x 128 x 128 planes."""
    rng = np.random.default_rng(3)
    planes = rng.integers(0, 1024, (4, 128, 128)).astype(np.int32)
    t0, c0 = ref_bs.plane_partition_search(planes, DC_Q, AC_Q, LAM, 10)
    t1, c1 = bs.plane_partition_search(planes, DC_Q, AC_Q, LAM, 10,
                                       device="cpu")
    assert sorted(t0) == sorted(t1) == [8, 16, 32]
    assert sorted(c0) == sorted(c1) == [16, 32]
    off = size = 0  # the cost policy over all three tiers' costs
    for n in t0:
        (rm, rc), (gm, gc) = t0[n], t1[n]
        assert gm.shape == rm.shape and gm.dtype == rm.dtype
        assert gc.shape == rc.shape and gc.dtype == rc.dtype
        ref = _ref_costs(planes, n)[0]
        off += _hold(ref, _port_costs(planes, n), f"partition tier {n}",
                     costs=False)
        size += ref.size
        assert np.array_equal(rm, ref.argmin(-1))
        near = np.take_along_axis(ref, gm[..., None].astype(np.int64),
                                  -1)[..., 0] <= rc * (1 + 1e-5)
        assert bool(((gm == rm) | near).all()), n
        assert int((np.abs(gc - rc) > 1e-4 * np.abs(rc) + 8.0).sum()) \
            < 1e-3 * rc.size
    assert off < 1e-3 * size, (off, size)
    for n in c0:
        assert c1[n].dtype == c0[n].dtype
        diff = int((c1[n] != c0[n]).sum())
        print(f"\ncodes {n}: differ {diff} of {c0[n].size}")
        assert diff < 1e-3 * c0[n].size or diff == 0


def test_plain_backend_and_wrapper_on_cpu(monkeypatch):
    """On the CPU the K3 wrapper runs its plain version and counts no
    launch. backend="auto" prices through the wrapper (K3 on a CUDA
    tensor) and "plain" through the plain version alone, which is what
    chip_smoke.py's card-side comparison of the two rests on."""
    planes = _planes(64, 64, 2)
    kw = bs.search_inputs(torch.from_numpy(planes), 8, 10, DC_Q, AC_Q, LAM)
    sk.reset_launches()
    a = sk.mode_cost(**kw)
    assert sk.LAUNCHES == {"mode_cost": 0}
    assert torch.equal(a, sk.mode_cost_ref(**kw))
    assert a.shape == (2 * 8 * 8, 13) and a.dtype == torch.float32

    calls = []

    def spy(name, fn):
        def wrapped(**k):
            calls.append((name, k["blocks"].shape[1]))
            return fn(**k)
        return wrapped

    monkeypatch.setattr(bs, "mode_cost", spy("wrapper", sk.mode_cost))
    monkeypatch.setattr(bs, "mode_cost_ref", spy("plain", sk.mode_cost_ref))
    for backend, name in (("auto", "wrapper"), ("plain", "plain")):
        calls.clear()
        bs.plane_partition_search(planes, DC_Q, AC_Q, LAM, 10, min_n=4,
                                  device="cpu", backend=backend)
        assert calls == [(name, n) for n in SIZES], backend
        calls.clear()
        bs.plane_mode_search(planes, DC_Q, AC_Q, LAM, 10, n=16,
                             device="cpu", backend=backend)
        assert calls == [(name, 16)], backend
    assert sk.LAUNCHES == {"mode_cost": 0}


def test_search_refuses_what_it_does_not_support():
    planes = _planes(64, 64, 2)
    with pytest.raises(TypeError):
        bs.plane_partition_search(planes, DC_Q, AC_Q, LAM, 10, mesh=object(),
                                  device="cpu")
    with pytest.raises(ValueError):
        bs.plane_mode_search(planes, DC_Q, AC_Q, LAM, 10, backend="pallas",
                             device="cpu")
    with pytest.raises(ValueError):
        bs.plane_mode_search(planes[:, :48], DC_Q, AC_Q, LAM, 10, n=32,
                             device="cpu")


@pytest.mark.parametrize("device", ["cuda", None])
def test_plane_mode_search_raises_without_cuda(device):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the search runs on it")
    planes = _planes(64, 64, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        bs.plane_mode_search(planes, DC_Q, AC_Q, LAM, 10, n=16, device=device)
    with pytest.raises(RuntimeError, match="cuda"):
        bs.plane_partition_search(planes, DC_Q, AC_Q, LAM, 10, device=device)
