#!/usr/bin/env python3
"""Card-side check of the PyTorch/CUDA port (cavif_tpu_torch) on one GPU.

    python3 chip_smoke.py     # needs one CUDA card

Phases, each of which fails the run (exit code != 0) when it fails:

1. card: the GPU's name, power limit and maximum SM clock (nvidia-smi),
   torch and CUDA versions;
2. build: nvcc compiles the four kernel sources from cavif_tpu_torch/csrc/
   (one process per source, all started together);
3. kernels: for each of the ten block shapes that the 1024x1024 Q80 speed-4
   encode prices, the real ShapeCost inputs of the test image go through
   K1 and K2, called as ShapeCost.forward calls them (with its packed
   constant tiles), and through their plain PyTorch versions (both with
   bf16 matmul inputs): the argmin over candidates must differ on fewer
   than 1e-3 of the rows and fewer than 1e-3 of the costs may lie beyond
   rtol 2e-4; the kernel on R - 37 rows gives those rows bit for bit, and
   two launches are bit-equal; each shape's blocks, registers and shared
   memory per block are printed. Times (CUDA events) of the kernel, the
   plain version and one
   torch.matmul of the bf16 product alone, beside the least time the card
   could take for the same work (the larger of the bytes' time and the
   operations' time: tensor-core FLOPs beside the CUDA cores' FP32 FLOPs
   and epilogue instructions); then K3 (the block search's 13-candidate
   costs) on the three 10-bit YCbCr planes of the same image at the same
   quantizers, for each n in {4, 8, 16, 32}: argmin against its plain
   version below 1e-3 of the blocks and the costs bit-equal, CUDA-event
   times of kernel, plain version and a torch.matmul pair computing the 13
   candidates' D R D^T alone, and the bound;
   then the prototype harnesses' kernels K4 (fused_dir_cost) and K5
   (dir_ablation) on the harness inputs of a 1024x1024 three-plane frame at
   every tier b in {4, 8, 16, 32} (cavif_tpu_torch/tools/dir_proto.build),
   with MK's tiles packed once outside the timed calls: K4 in both reduce
   modes at every tile (rows per block, lanes per chunk), K5 in every
   variant at the default tile, each against its plain version (bf16
   inputs): argmin below 1e-3 of the rows and fewer than 1e-3 of the costs
   beyond rtol 2e-4 (for mm_only and red_bf16: 2^-8 of the summed lane
   values' magnitudes); K4 on fewer rows gives the same rows bit for bit,
   K5 "full" equals K4 "matmul"; times beside the plain version, one
   torch.matmul of the bf16 product and the bound; per (tier, tile) the
   blocks, registers and shared memory per block and the host's time per
   call; K5's split as shares of "full"; K4 on K1's real inputs of the
   four square shapes, timed beside K1, where K4 "loop" at the default
   tile must give K1's costs bit for bit (one kernel template); then one
   counted call of each harness per tier (four launches each);
4. the main path at full size: Encoder.new().with_quality(80).with_speed(4)
   on the 1024x1024 RGB test image, and on an RGBA variant, with every
   kernel's launch count set to 0 just before and read just after; the AVIF
   is parsed; the colour stream is held against the port's host C++ cascade
   (device="off"): bytes at most 1.05x and PSNR of the decoder-exact
   pre-filter reconstruction (FrameEncoder._recon_full) at least the
   host's minus 0.1 dB; the whole
   device pass 1 on a 256x256 input agrees with the CPU plain path;
5. the block-search path at full size: plane_partition_search (tiers
   8-32: three K3 launches) and plane_mode_search at n = 16 (one), each
   with K3's count set to 0 just before and read just after; the same
   partition search with backend="plain" (the plain version on the card)
   gives the same modes, costs and codes; at 256x256 the card's modes and
   codes agree with device="cpu";
6. the batched path: encode_batch_sharded on four 1024x1024 RGB images and
   one RGBA image (host stealing off), K1/K2 launch counts (one launch
   per block shape and sub-batch, not per image), every AVIF parsed, the
   four colour streams inside the host envelope as in phase 4, wall time
   and MP/s, beside the same images encoded one after another and through
   encode_batch (the hybrid card + host scheduler);
7. one JSON line listing the kernels, the card line, and last the JSON
   result line.

Without a CUDA card, or outside a checkout of the repository, it exits
non-zero and prints no result. Long output (nvcc's ptxas report) goes to
chiprun_out/chip_smoke_build.txt.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
SHAPES = ((4, 4), (8, 8), (16, 16), (32, 32),
          (8, 4), (4, 8), (16, 8), (8, 16), (32, 16), (16, 32))
SIZE = 1024
QUALITY, SPEED = 80, 4
ARGMIN_TOL = 1e-3
# K1, K2, K4, K5 against their plain versions: rtol on each cost (a level flip at a
# quantizer boundary moves a cost by about lam, so a share below ARGMIN_TOL
# may exceed it); for mm_only and red_bf16 bf16's relative rounding of the
# summed lane values instead
COST_RTOL = 2e-4
BF16_REL = 2.0 ** -8
PROTO_TIERS = (4, 8, 16, 32)
REPLACES = {
    "dir_cost": "cavif_tpu/ops/device_pass1.py:594",  # _fused_dir_cost
    "nd_cost": "cavif_tpu/ops/device_pass1.py:475",   # _fused_nd_cost
    "mode_cost": "cavif_tpu/ops/pallas_search.py:101",  # _pallas_kernel
    "fused_dir_cost": "tools/pallas_proto.py:74",  # pallas_fused
    "dir_ablation": "tools/pallas_proto2.py:17",   # make
}
SOURCES = {
    "dir_cost": "cavif_tpu_torch/csrc/pass1_dir_cost.cu",
    "nd_cost": "cavif_tpu_torch/csrc/pass1_nd_cost.cu",
    "mode_cost": "cavif_tpu_torch/csrc/mode_search_cost.cu",
    "fused_dir_cost": "cavif_tpu_torch/csrc/dir_cost_tc.cu",
    "dir_ablation": "cavif_tpu_torch/csrc/dir_cost_tc.cu",
}


def _test_image(h: int, w: int, seed: int = 42) -> np.ndarray:
    """Photo-like synthetic content: smooth shading + texture + edges
    (the repository benchmark's generator; seed 42 is its image)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = (
        110 + 80 * np.sin(x / 97.0) * np.cos(y / 61.0)
        + 40 * np.sin((x + 2 * y) / 31.0)
    )
    texture = rng.normal(0.0, 6.0, size=(h, w))
    edges = 60.0 * ((x // 128 + y // 128) % 2)
    lum = np.clip(base + texture + edges * 0.3, 0, 255)
    r = np.clip(lum + 18 * np.sin(y / 83.0), 0, 255)
    b = np.clip(lum - 22 * np.cos(x / 71.0), 0, 255)
    return np.stack([r, lum, b], axis=-1).astype(np.uint8)


def _peaks(name: str, sms: int, clock_hz: float) -> dict:
    """Rates of the card: bytes/s of device memory, dense bf16 tensor-core
    FLOP/s and f32 FMA FLOP/s outside the tensor cores (data sheet), and
    FP32 instructions/s (one per CUDA-core lane per clock: 128 lanes per SM
    at the card's maximum SM clock)."""
    if "PCIe" in name:
        rates = (2.0e12, 756e12, 51e12)
    elif "NVL" in name:
        rates = (3.9e12, 835e12, 60e12)
    elif "H200" in name:
        rates = (4.8e12, 989e12, 67e12)
    else:  # H100 SXM
        rates = (3.35e12, 989e12, 67e12)
    return dict(zip(("bytes", "bf16", "f32"), rates),
                instr=float(sms) * 128.0 * clock_hz)


def _bound(peaks, nbytes, bf16_flops=0.0, f32_flops=0.0, instr=0.0):
    """(ms, "bytes" or "operations", (bytes ms, tensor-core ms, CUDA-core
    ms)): the least time of a kernel that reads its inputs once and writes
    its output once. Tensor-core products run beside the CUDA cores; f32
    FMA FLOPs and other FP32 instructions share the CUDA cores and add."""
    t_bytes = nbytes / peaks["bytes"] * 1e3
    t_tc = bf16_flops / peaks["bf16"] * 1e3
    t_cc = (f32_flops / peaks["f32"] + instr / peaks["instr"]) * 1e3
    t_ops = max(t_tc, t_cc)
    return (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations",
            (t_bytes, t_tc, t_cc))


def _cuda_ms(torch, fn, reps: int, host: bool = False):
    """CUDA-event ms per call of `fn` over `reps` calls after a warm-up;
    with host=True also the host's ms per call to issue them (when the two
    are close, the calls are bound by the host, not the card)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issued = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    return (ms, issued) if host else ms


def _psnr(ref_planes, rec_planes, h, w, depth) -> float:
    peak = float((1 << depth) - 1)
    err = 0.0
    n = 0
    for a, b in zip(ref_planes, rec_planes):
        d = a[:h, :w].astype(np.float64) - b[:h, :w].astype(np.float64)
        err += float((d * d).sum())
        n += d.size
    return 10.0 * np.log10(peak * peak / max(err / n, 1e-12))


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    clock = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"devices {torch.cuda.device_count()}; {sms} SMs, max SM clock "
          f"{clock} MHz")
    return smi, sms, float(clock) * 1e6


def phase_build(cb):
    t0 = time.perf_counter()
    done = cb.build()
    secs = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.txt"), "w") as f:
        for name, (_, log) in done.items():
            f.write(f"== {name}\n{log}\n")
    for name, (done_s, log) in done.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name} done at {done_s:.2f} s: "
              + " | ".join(regs[-2:]))
    print(f"[build] {len(done)} kernel sources built in {secs:.2f} s")
    # load the libraries now, so the first timed launch pays no dlopen
    for name in done:
        cb.load(name)


def _shape_inputs(torch, dp, geo, planes, use_deltas):
    """{(bw, bh): (ShapeCost, nd kwargs, dir kwargs)} at the encoder's own
    quantizers, lambda and tile split for this frame."""
    out = {}
    for (bw, bh) in SHAPES:
        ud = bool(use_deltas) and min(bw, bh) >= 8 and max(bw, bh) < 64
        sc = dp._shape_cost(bw, bh, geo.depth, ud, "bf16", planes.device)
        _, nd, dr = sc.kernel_inputs(
            planes, geo.dc_q, geo.ac_q, dp._f32(geo.lam), (geo.th, geo.tw))
        out[(bw, bh)] = (sc, nd, dr)
    return out


# FP32 CUDA-core instructions per element of each kernel's epilogue,
# counted from its source (an |x| folds into its operand): K1
# (dir_tc.cuh, FULL) per (row, candidate, lane): cp / 32 + cc, bkt - .,
# lane_cost (11, pass1_tc.cuh), the lane sum; K2 (pass1_nd_cost.cu) per
# (row, predictor, lane): lane_cost and the sum, plus per (row, pixel) the
# five predictors, residuals and their bf16 rounding (the tensor-core
# sources keep both epilogues' arithmetic, so the counts are unchanged);
# K4/K5 (dir_tc.cuh lane_value, the same arithmetic as the first K4's) per
# (row, candidate, lane), the lane sum included
EPI_INSTR = {"dir_cost": 15, "nd_cost": 12, "nd_pixel": 47,
             "full": 15, "mm_only": 2, "no_quant": 5, "no_sign": 15,
             "red_bf16": 16}


def phase_kernels(torch, pk, dp, geo, planes, use_deltas, peaks):
    """K1 and K2 at the ten block shapes, called as ShapeCost.forward calls
    them (with its packed tiles), against their plain versions: argmin
    below 1e-3 of the rows, fewer than 1e-3 of the costs beyond COST_RTOL,
    R - 37 rows give those rows bit for bit, two launches bit-equal; launch
    geometry (blocks, registers, shared memory), times and bounds."""
    inputs = _shape_inputs(torch, dp, geo, planes, use_deltas)
    rows = []
    for (bw, bh), (sc, nd, dr) in inputs.items():
        R, n2, E, cdir = nd["blocks"].shape[0], sc.n2, sc.E, sc.cdir
        # library yardsticks: the bf16 products alone (the port never
        # calls these)
        ext16 = dr["ext"].to(torch.bfloat16)
        res16 = (nd["blocks"][:, None, :] - pk.nd_preds(
            nd["above"], nd["left"], nd["sc"][:, 0], nd["sc"][:, 1],
            nd["whv"], nd["wwv"])).reshape(R * 5, n2).to(torch.bfloat16)
        work = {
            "dir_cost": dict(
                kern=lambda kw: pk.dir_cost(**kw, mk_tiles=sc.mk_tiles),
                plain=pk.dir_cost_ref, kw=dr, per_row=("ext", "bkt"),
                lib=lambda: torch.matmul(ext16, dr["mk"]),
                flops=2.0 * R * E * cdir * n2,
                instr=EPI_INSTR["dir_cost"] * float(R) * cdir * n2,
                bytes=4.0 * R * (E + n2 + cdir) + 2.0 * E * cdir * n2
                + 16.0 * n2,
            ),
            "nd_cost": dict(
                kern=lambda kw: pk.nd_cost(**kw, kt_tiles=sc.kt_tiles),
                plain=pk.nd_cost_ref, kw=nd,
                per_row=("above", "left", "sc", "blocks"),
                lib=lambda: torch.matmul(res16, nd["kt"]),
                flops=5 * 2.0 * R * n2 * n2,
                instr=(5 * EPI_INSTR["nd_cost"] + EPI_INSTR["nd_pixel"])
                * float(R) * n2,
                bytes=4.0 * R * (bw + bh + 2 + n2 + 5) + 2.0 * n2 * n2
                + 20.0 * n2,
            ),
        }
        for name, w in work.items():
            kw = w["kw"]
            what = f"{name} {bw}x{bh}"
            got = w["kern"](kw)
            # the second launch packs its constant tiles inside the call
            again = getattr(pk, name)(**kw)
            ref = w["plain"](**kw)
            torch.cuda.synchronize()
            mism, max_abs, over = _hold(
                torch, what, got, ref, COST_RTOL * ref.abs().clamp_min(1.0))
            rel = float(((got - ref).abs() / ref.abs().clamp_min(1.0)).max())
            if not torch.equal(got, again):
                raise AssertionError(f"{what}: two launches differ")
            # the ragged edge: fewer rows give the same rows bit for bit
            Rr = R - 37
            part = w["kern"]({k: (v[:Rr] if k in w["per_row"] else v)
                              for k, v in kw.items()})
            if not torch.equal(part, got[:Rr]):
                raise AssertionError(f"{what}: {Rr} rows differ from the "
                                     f"first rows of {R}")
            del again, part
            info = pk.kernel_info(name, R, bw, bh, cdir)
            ms, host_ms = _cuda_ms(torch, lambda: w["kern"](kw), 20,
                                   host=True)
            plain_ms = _cuda_ms(torch, lambda: w["plain"](**kw), 5)
            lib_ms = _cuda_ms(torch, w["lib"], 20)
            bound, by, terms = _bound(peaks, w["bytes"], bf16_flops=w["flops"],
                                      instr=w["instr"])
            row = dict(
                name=name, shape=f"{bw}x{bh}", rows=R, argmin_mismatch=mism,
                beyond_tol=over, max_abs_err=max_abs, max_rel_err=rel, ms=ms,
                host_ms=host_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=by, **info,
            )
            rows.append(row)
            print("[kernels] %-8s %-5s R=%-7d argmin %.2e  beyond tol %.2e  "
                  "max|d| %.4g rel %.3g  kernel %.4f ms  plain %.4f ms  "
                  "matmul %.4f ms  bound %.4f ms (%s; bytes %.4f, tensor "
                  "cores %.4f, CUDA cores %.4f)" % (
                      name, row["shape"], R, mism, over, max_abs, rel, ms,
                      plain_ms, lib_ms, bound, by, *terms))
            print("[kernels] %-8s %-5s blocks %d (+%d chunk-sum), %d "
                  "registers, %d B shared memory per block; host %.4f ms "
                  "per call; ragged edge and repeat launch bit-equal" % (
                      name, row["shape"], info["blocks"], info["sum_blocks"],
                      info["registers"], info["smem_bytes"], host_ms))
        del ext16, res16
    torch.cuda.synchronize()
    return rows


def phase_encode(torch, pk, img):
    from cavif_tpu_torch import Encoder
    from cavif_tpu_torch.container.parse import read_avif
    from cavif_tpu_torch.utils import trace

    enc = Encoder.new().with_quality(QUALITY).with_speed(SPEED)
    h, w = img.shape[:2]
    t0 = time.perf_counter()
    enc.encode_rgb(img)  # first use: constant tables, native build
    print(f"[encode] first encode (set-up included) "
          f"{time.perf_counter() - t0:.3f} s")

    pk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = enc.encode_rgb(img)
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    print(f"[encode] rgb {w}x{h} Q{QUALITY} s{SPEED}: {wall:.4f} s, "
          f"{len(res.avif_file)} bytes, launches {launches}")
    # the stage split comes from a second, traced encode
    trace.set_enabled(True)
    t0 = time.perf_counter()
    enc.encode_rgb(img)
    traced = time.perf_counter() - t0
    stages = dict(trace.LAST)
    trace.set_enabled(False)
    print(f"[encode] traced encode {traced:.4f} s, stages " + json.dumps(
        {k: round(v, 5) for k, v in sorted(stages.items(),
                                            key=lambda kv: -kv[1])}))
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched in the encode")
    info = read_avif(res.avif_file)
    if (info.width, info.height, info.bit_depth) != (w, h, 10):
        raise AssertionError(f"parsed AVIF header {info}")

    # RGBA: the alpha stream adds a mono device pass 1
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = np.clip((xx + yy) * 255 // (w + h - 2), 0, 255).astype(np.uint8)
    rgba = np.dstack([img, alpha])
    pk.reset_launches()
    t0 = time.perf_counter()
    res_a = enc.encode_rgba(rgba)
    wall_a = time.perf_counter() - t0
    launches_a = dict(pk.LAUNCHES)
    print(f"[encode] rgba {w}x{h}: {wall_a:.4f} s, "
          f"{len(res_a.avif_file)} bytes, launches {launches_a}")
    for name, n in launches_a.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched (rgba)")
    info_a = read_avif(res_a.avif_file)
    if info_a.alpha_item is None:
        raise AssertionError("rgba AVIF carries no alpha item")

    host = replace(enc, device="off").encode_rgb(img)
    print(f"[encode] host cascade AVIF {len(host.avif_file)} bytes, "
          f"card {len(res.avif_file)} bytes")
    return launches


def phase_quality(img):
    """Colour stream on the card vs the host cascade, measured on the
    decoder-exact reconstruction before the output-only loop filters."""
    from cavif_tpu_torch.av1.config import AV1Config
    from cavif_tpu_torch.av1.encoder import FrameEncoder
    from cavif_tpu_torch.av1.speed import SpeedTweaks
    from cavif_tpu_torch.ops import colorspace
    from cavif_tpu_torch.ops.quality import quality_to_quantizer

    h, w = img.shape[:2]
    q = quality_to_quantizer(float(QUALITY))
    planes = colorspace.rgb_to_ycbcr_host(img, depth=10)
    res = {}
    for dev in (None, "off"):
        cfg = AV1Config(
            width=w, height=h, bit_depth=10, quantizer=q,
            tweaks=SpeedTweaks.from_preset(SPEED, q), chroma_sampling="444",
            full_range=True, matrix_coefficients=6, threads=None,
            tune="psnr", device=dev,
        )
        fe = FrameEncoder(planes, cfg, src8=img)
        data = fe.encode()
        # the decoder-exact reconstruction (the native tile coder fills
        # this stack; the Python one fills planes[p].recon)
        recon = fe._recon_full()
        psnr = _psnr([planes[..., p] for p in range(3)], list(recon), h, w,
                     10)
        res[dev or "cuda"] = (len(data), psnr)
    (cb, cp), (hb, hp) = res["cuda"], res["off"]
    print(f"[quality] colour stream: card {cb} B, {cp:.4f} dB; host {hb} B, "
          f"{hp:.4f} dB (limits: bytes <= {1.05 * hb:.0f}, "
          f"PSNR >= {hp - 0.1:.4f})")
    if cb > 1.05 * hb or cp < hp - 0.1:
        raise AssertionError("card encode outside the host envelope")
    return dict(card_bytes=cb, card_psnr=cp, host_bytes=hb, host_psnr=hp)


def phase_small_reference(dp, geo, img):
    """Whole device pass 1 at 256x256 on the card vs the same program on
    the CPU (plain versions), both with bf16 matmul inputs."""
    small = np.ascontiguousarray(img[:256, :256])
    kw = dict(depth=10, model="ycbcr", num_planes=3, tile_px=(256, 256),
              min_px=4, max_px=32, use_deltas=True, dc_q=geo.dc_q,
              ac_q=geo.ac_q, lam=geo.lam, matmul="bf16")
    card = dp.run_pass1(small, device="cuda", **kw)
    cpu = dp.run_pass1(small, device="cpu", **kw)
    tot = diff = 0
    for k, v in cpu.items():
        if card[k].shape != v.shape:
            raise AssertionError(f"grid {k} shape {card[k].shape}")
        tot += v.size
        diff += int((card[k] != v).sum())
    print(f"[small] 256x256 pass 1: card vs CPU plain differ on {diff} of "
          f"{tot} packed entries")
    if diff >= 1e-3 * tot:
        raise AssertionError("card pass 1 disagrees with the CPU plain path")


def phase_search_kernel(torch, sk, bs, geo, planes, peaks):
    """K3 against its plain version on the card at the four tiers of the
    1 MP frame's three planes."""
    rows = []
    for n in sk.SIZES:
        kw = bs.search_inputs(planes, n, geo.depth, geo.dc_q, geo.ac_q,
                              geo.lam)
        NB = kw["blocks"].shape[0]
        got = sk.mode_cost(**kw)
        ref = sk.mode_cost_ref(**kw)
        torch.cuda.synchronize()
        if tuple(got.shape) != (NB, 13) or not bool(
                torch.isfinite(got).all()):
            raise AssertionError(f"mode_cost n={n}: bad costs {got.shape}")
        mism = float((got.argmin(1) != ref.argmin(1)).float().mean())
        diff = (got - ref).abs()
        max_abs = float(diff.max())
        rel = float((diff / ref.abs().clamp_min(1.0)).max())
        # library yardstick: the 13 candidates' D R D^T alone, as one
        # batched torch.matmul pair (the port never calls it)
        preds = torch.cat([
            sk.nondir_preds(kw["above"], kw["left"], kw["scal"], kw["smw"]),
            sk.dir_preds(kw["ext"], kw["taps"]).view(NB, 6, n, n)], 1)
        res = (kw["blocks"][:, None] - preds).float()
        d, dt = kw["dct"], kw["dct"].T.contiguous()
        ms = _cuda_ms(torch, lambda: sk.mode_cost(**kw), 20)
        plain_ms = _cuda_ms(torch, lambda: sk.mode_cost_ref(**kw), 5)
        lib_ms = _cuda_ms(torch, lambda: torch.matmul(torch.matmul(d, res),
                                                      dt), 20)
        del preds, res
        # the two DCT passes as f32 FLOPs (4 n^3 per candidate); the
        # quantizer, about 11 FP32 instructions per coefficient, beside them
        nbytes = 4.0 * NB * (n * n + 2 * n + 2 + 4 * n + 1 + 13) \
            + 4.0 * (6 * n * n + n + n * n)
        bound, by, terms = _bound(peaks, nbytes,
                                  f32_flops=13.0 * NB * 4.0 * n ** 3,
                                  instr=13.0 * NB * 11.0 * n * n)
        row = dict(
            name="mode_cost", shape=f"{n}x{n}", rows=NB,
            argmin_mismatch=mism, max_abs_err=max_abs, max_rel_err=rel,
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound, bound_by=by,
        )
        rows.append(row)
        print("[k3] n=%-2d NB=%-6d argmin %.2e  max|d| %.4g rel %.3g  "
              "kernel %.4f ms  plain %.4f ms  matmul pair %.4f ms  "
              "bound %.4f ms (%s; bytes %.4f, CUDA cores %.4f)" % (
                  n, NB, mism, max_abs, rel, ms, plain_ms, lib_ms,
                  bound, by, terms[0], terms[2]))
        if mism >= ARGMIN_TOL:
            raise AssertionError(
                f"mode_cost n={n}: argmin differs on {mism:.2e} of blocks "
                f"(limit {ARGMIN_TOL})")
        # K3 does the plain version's f32 operations in the same order, so
        # its costs are bit-equal: any difference is a fault, even one that
        # leaves the argmin alone (a constant or scale off on a candidate)
        if max_abs > 0.0:
            raise AssertionError(
                f"mode_cost n={n}: costs differ from the plain version by "
                f"up to {max_abs:.6g} (bit-equal expected)")
    torch.cuda.synchronize()
    return rows


def _hold(torch, what, got, ref, tol):
    """Raise unless `got` has `ref`'s shape, is finite, picks another
    candidate than `ref` on fewer than ARGMIN_TOL of the rows and differs
    by more than `tol` (elementwise) on fewer than ARGMIN_TOL of the costs.
    Returns (argmin mismatch, max |d|, share beyond tol)."""
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: bad costs {tuple(got.shape)}")
    mism = float((got.argmin(1) != ref.argmin(1)).float().mean())
    diff = (got - ref).abs()
    over = float((diff > tol).float().mean())
    if mism >= ARGMIN_TOL or over >= ARGMIN_TOL:
        raise AssertionError(
            f"{what}: argmin differs on {mism:.2e} of rows, {over:.2e} of "
            f"costs beyond the tolerance (limits {ARGMIN_TOL})")
    return mism, float(diff.max()), over


def phase_proto(torch, prk, pk, dp, dir_proto, dir_ablation, inputs, peaks):
    """K4 and K5 on the harness inputs of a 1024x1024 three-plane frame at
    every tier (both reduce modes and every tile for K4, every variant at
    the default tile for K5), each with MK's tiles packed once outside the
    timed calls, against its plain version with bf16-rounded inputs; launch
    geometry per (tier, tile); K5's split as shares of "full"; K4 on K1's
    real square-shape inputs, where "loop" at the default tile must give
    K1's costs bit for bit; then one counted harness call of each per
    tier."""
    rows, data = [], {}
    for b in PROTO_TIERS:
        R = 3 * (SIZE // b) ** 2
        d = data[b] = dir_proto.build(b, R, 0)
        kw = dir_proto.from_numpy(d, "cuda")
        kw["mk"] = kw["mk"].to(torch.bfloat16)
        E, n2, C = d["E"], d["n2"], d["C"]
        tiles = {t: prk.pack_tiles(kw["mk"], n2, t) for t in prk.TILES}
        nbytes = 4.0 * R * (E + n2 + C) + 2.0 * E * C * n2 + 16.0 * n2
        flops = 2.0 * R * E * C * n2
        # library yardstick: the bf16 product alone (the port never calls
        # it)
        ext16 = kw["ext"].to(torch.bfloat16)
        lib_ms = _cuda_ms(torch, lambda: torch.matmul(ext16, kw["mk"]), 10)
        del ext16
        ref = prk.fused_dir_cost_ref(**kw)
        tol = COST_RTOL * ref.abs().clamp_min(1.0)
        plain_ms = _cuda_ms(torch, lambda: prk.fused_dir_cost_ref(**kw), 3)
        bound, by, terms = _bound(peaks, nbytes, bf16_flops=flops,
                                  instr=EPI_INSTR["full"] * float(R) * C * n2)
        print("[proto] tier %-2d R=%-6d E=%-3d C=%d n2=%-4d plain %.4f ms  "
              "matmul %.4f ms  bound %.4f ms (%s; bytes %.4f, tensor cores "
              "%.4f, CUDA cores %.4f)" % (b, R, E, C, n2, plain_ms, lib_ms,
                                          bound, by, *terms))
        first, host = {}, {}
        for reduce in prk.REDUCE_MODES:
            for tile in prk.TILES:
                def run():
                    return prk.fused_dir_cost(**kw, reduce=reduce, tile=tile,
                                              mk_tiles=tiles[tile])
                got = run()
                torch.cuda.synchronize()
                what = f"k4 tier {b} {reduce} {tile[0]}x{tile[1]}"
                mism, max_abs, over = _hold(torch, what, got, ref, tol)
                ms, host[reduce, tile] = _cuda_ms(torch, run, 10, host=True)
                first.setdefault(reduce, got)
                rows.append(dict(
                    name="fused_dir_cost", tier=b, mode=reduce, tile=tile,
                    argmin_mismatch=mism, max_abs_err=max_abs, ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                    bound_by=by))
                print(f"[proto] {what:<28} argmin {mism:.2e}  max|d| "
                      f"{max_abs:.6g}  beyond tol {over:.2e}  kernel "
                      f"{ms:.4f} ms")
            # the ragged edge: fewer rows give the same rows bit for bit
            Rr = R - 37
            part = prk.fused_dir_cost(
                **{**kw, "ext": kw["ext"][:Rr], "bkt": kw["bkt"][:Rr]},
                reduce=reduce, mk_tiles=tiles[prk.DEFAULT_TILE])
            if not torch.equal(part, first[reduce][:Rr]):
                raise AssertionError(f"k4 tier {b} {reduce}: {Rr} rows "
                                     f"differ from the first rows of {R}")
        for tile in prk.TILES:
            geo = {m: prk.kernel_info(R, E, n2, C, tile, reduce=m)
                   for m in prk.REDUCE_MODES}
            g = geo["matmul"]
            print("[proto] k4 tier %-2d %dx%-2d blocks %d (+%d chunk-sum), "
                  "registers %d matmul / %d loop, %d / %d B shared memory "
                  "per block; host %.4f / %.4f ms per call" % (
                      b, tile[0], tile[1], g["blocks"], g["sum_blocks"],
                      g["registers"], geo["loop"]["registers"],
                      g["smem_bytes"], geo["loop"]["smem_bytes"],
                      host["matmul", tile], host["loop", tile]))
        split = {}
        for variant in prk.VARIANTS:
            def run():
                return prk.dir_ablation(**kw, variant=variant,
                                        mk_tiles=tiles[prk.DEFAULT_TILE])
            got = run()
            vref = prk.dir_ablation_ref(**kw, variant=variant)
            if variant in prk.BF16_REDUCE:
                vtol = BF16_REL * prk.ablation_lanes(
                    **kw, variant=variant).abs().sum(-1)
            else:
                vtol = COST_RTOL * vref.abs().clamp_min(1.0)
            torch.cuda.synchronize()
            what = f"k5 tier {b} {variant}"
            mism, max_abs, over = _hold(torch, what, got, vref, vtol)
            del vtol
            if variant == "full" and not torch.equal(got, first["matmul"]):
                raise AssertionError(f"{what}: differs from K4 'matmul'")
            ms = split[variant] = _cuda_ms(torch, run, 10)
            vplain_ms = _cuda_ms(
                torch, lambda: prk.dir_ablation_ref(**kw, variant=variant), 3)
            vbound, vby, vterms = _bound(
                peaks, nbytes, bf16_flops=flops,
                instr=EPI_INSTR[variant] * float(R) * C * n2)
            rows.append(dict(
                name="dir_ablation", tier=b, mode=variant,
                tile=prk.DEFAULT_TILE, argmin_mismatch=mism,
                max_abs_err=max_abs, ms=ms, plain_ms=vplain_ms,
                library_ms=lib_ms, bound_ms=vbound, bound_by=vby))
            print(f"[proto] {what:<28} argmin {mism:.2e}  max|d| "
                  f"{max_abs:.6g}  beyond tol {over:.2e}  kernel {ms:.4f} "
                  f"ms  plain {vplain_ms:.4f} ms  bound {vbound:.4f} ms "
                  f"({vby}; CUDA cores {vterms[2]:.4f})")
        print(f"[proto] k5 tier {b} split, shares of full "
              f"({split['full']:.4f} ms): " + ", ".join(
                  f"{v} {split[v] / split['full']:.3f}"
                  for v in ("mm_only", "no_quant", "no_sign")))
        del kw, ref, tol, first, got, vref, tiles
        torch.cuda.empty_cache()

    # K4 on K1's own inputs: the four square shapes of the encode; "loop"
    # at the default tile with K1's tiles is K1's kernel instantiation
    for s in (4, 8, 16, 32):
        sc, _, dr = inputs[(s, s)]
        ref = pk.dir_cost_ref(**dr)
        tol = COST_RTOL * ref.abs().clamp_min(1.0)
        k1 = pk.dir_cost(**dr, mk_tiles=sc.mk_tiles)
        line = []
        for reduce in prk.REDUCE_MODES:
            def run():
                return prk.fused_dir_cost(**dr, reduce=reduce,
                                          mk_tiles=sc.mk_tiles)
            got = run()
            torch.cuda.synchronize()
            mism, max_abs, over = _hold(torch, f"k4 real {s}x{s} {reduce}",
                                        got, ref, tol)
            if reduce == "loop" and not torch.equal(got, k1):
                raise AssertionError(f"k4 real {s}x{s}: K4 'loop' at the "
                                     "default tile differs from K1")
            line.append(f"K4 {reduce} {_cuda_ms(torch, run, 10):.4f} ms "
                        f"(argmin {mism:.2e}, max|d| {max_abs:.6g}, beyond "
                        f"tol {over:.2e})")
        k1_ms = _cuda_ms(
            torch, lambda: pk.dir_cost(**dr, mk_tiles=sc.mk_tiles), 10)
        print(f"[k4] real {s}x{s} R={dr['ext'].shape[0]} "
              f"cdir={ref.shape[1]}: {'; '.join(line)}; K1 {k1_ms:.4f} ms; "
              "K4 loop == K1 bit for bit")
    torch.cuda.synchronize()

    # the counted run: one call of each harness per tier, at its defaults
    outs = {}
    prk.reset_launches()
    for b, d in data.items():
        kw = dir_proto.from_numpy(d, "cuda")
        k4 = dir_proto.fused(d)(kw["ext"], kw["bkt"])
        f, ext, bkt = dir_ablation.make(d, "full")
        outs[b] = (k4, f(ext, bkt))
    torch.cuda.synchronize()
    launches = dict(prk.LAUNCHES)
    print(f"[proto] counted harness calls over tiers {PROTO_TIERS}: "
          f"launches {launches}")
    if launches != {"fused_dir_cost": len(data), "dir_ablation": len(data)}:
        raise AssertionError(f"K4/K5 launches {launches}, expected "
                             f"{len(data)} each")
    for b, (k4, k5) in outs.items():
        if not torch.equal(k4, k5):
            raise AssertionError(f"tier {b}: harness K4 and K5 'full' differ")
    return rows, launches


def phase_block_search(torch, sk, bs, geo, img):
    """The block-search entry points at full size on the card, with K3's
    launch count read around each; then 256x256 card vs CPU."""
    from cavif_tpu_torch.ops import colorspace

    planes = np.ascontiguousarray(
        colorspace.rgb_to_ycbcr_host(img, depth=10).transpose(2, 0, 1))
    args = (geo.dc_q, geo.ac_q, geo.lam, 10)
    sk.reset_launches()
    t0 = time.perf_counter()
    tiers, codes = bs.plane_partition_search(planes, *args, min_n=8,
                                             max_n=32)
    wall = time.perf_counter() - t0
    part = sk.LAUNCHES["mode_cost"]
    for n, (m, c) in tiers.items():
        if m.shape != (3, SIZE // n, SIZE // n) or not np.isfinite(c).all():
            raise AssertionError(f"partition tier {n}: {m.shape}")
        if int(m.min()) < 0 or int(m.max()) > 12:
            raise AssertionError(f"partition tier {n}: mode out of range")
    sk.reset_launches()
    t0 = time.perf_counter()
    modes = bs.plane_mode_search(planes, *args, n=16)
    wall16 = time.perf_counter() - t0
    one = sk.LAUNCHES["mode_cost"]
    print(f"[search] plane_partition_search 3x{SIZE}x{SIZE} tiers 8-32: "
          f"{wall:.4f} s, K3 launches {part}; plane_mode_search n=16: "
          f"{wall16:.4f} s, K3 launches {one}")
    if part != 3 or one != 1:
        raise AssertionError(f"K3 launches {part} / {one}, expected 3 / 1")
    if modes.shape != (3, SIZE // 16, SIZE // 16):
        raise AssertionError(f"plane_mode_search shape {modes.shape}")

    # the whole partition search again on the plain version, on the card
    tp, cp = bs.plane_partition_search(planes, *args, min_n=8, max_n=32,
                                       backend="plain")
    dm = sum(int((tiers[n][0] != tp[n][0]).sum()) for n in tp)
    dcost = max(float(np.abs(tiers[n][1] - tp[n][1]).max()) for n in tp)
    dc = sum(int((codes[n] != cp[n]).sum()) for n in cp)
    print(f"[search] full size K3 vs backend=\"plain\": modes differ on "
          f"{dm}, codes on {dc}, max cost |d| {dcost:.6g}")
    if dm or dc or dcost > 0.0:
        raise AssertionError("the partition search on K3 differs from its "
                             "plain version")

    small = np.ascontiguousarray(planes[:, :256, :256])
    tc, cc = bs.plane_partition_search(small, *args, device="cuda")
    tp, cp = bs.plane_partition_search(small, *args, device="cpu")
    dm = sum(int((tc[n][0] != tp[n][0]).sum()) for n in tp)
    nm = sum(tp[n][0].size for n in tp)
    dc = sum(int((cc[n] != cp[n]).sum()) for n in cp)
    nc = sum(cp[n].size for n in cp)
    print(f"[search] 256x256 card vs CPU: modes differ on {dm} of {nm}, "
          f"codes on {dc} of {nc}")
    if dm >= 1e-3 * nm or dc >= 1e-3 * nc:
        raise AssertionError("card block search disagrees with the CPU")
    return part


def phase_batch(torch, pk, dp, img0):
    """encode_batch_sharded on four RGB images and one RGBA image at
    1024x1024, then the colour streams against the host cascade."""
    from dataclasses import replace as dc_replace

    from cavif_tpu_torch import Encoder
    from cavif_tpu_torch.av1.config import AV1Config
    from cavif_tpu_torch.av1.encoder import FrameEncoder, frame_geometry
    from cavif_tpu_torch.av1.speed import SpeedTweaks
    from cavif_tpu_torch.container.parse import read_avif
    from cavif_tpu_torch.ops import colorspace
    from cavif_tpu_torch.ops.quality import quality_to_quantizer
    from cavif_tpu_torch.parallel import batch as pbatch

    os.environ["CAVIF_TPU_SHARDED_STEAL"] = "0"
    rgbs = [img0] + [_test_image(SIZE, SIZE, s) for s in (43, 44, 45)]
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    alpha = np.clip((xx + yy) * 255 // (2 * SIZE - 2), 0, 255).astype(
        np.uint8)
    imgs = rgbs + [np.dstack([_test_image(SIZE, SIZE, 46), alpha])]
    enc = Encoder.new().with_quality(QUALITY).with_speed(SPEED)

    calls = []  # batch sizes of run_pass1_batch calls
    real = dp.run_pass1_batch

    def counted(srcs, **kw):
        calls.append(int(srcs.shape[0]))
        return real(srcs, **kw)

    dp.run_pass1_batch = counted
    try:
        t0 = time.perf_counter()
        pbatch.encode_batch_sharded(imgs, enc)
        warm = time.perf_counter() - t0
        calls.clear()
        pk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pbatch.encode_batch_sharded(imgs, enc)
        wall = time.perf_counter() - t0
        launches = dict(pk.LAUNCHES)
    finally:
        dp.run_pass1_batch = real
    mp = len(imgs) * SIZE * SIZE / 1e6
    print(f"[batch] encode_batch_sharded {len(rgbs)} RGB + 1 RGBA "
          f"{SIZE}x{SIZE} Q{QUALITY} s{SPEED}: {wall:.4f} s "
          f"({mp / wall:.4f} MP/s; first run {warm:.4f} s), run_pass1_batch "
          f"calls of B={calls}, launches {launches}")
    per_call = len(dp.SQ_TIERS) + len(dp.RECT_SHAPES)  # fused shapes
    for name, k in launches.items():
        if k <= 0 or k != per_call * len(calls):
            raise AssertionError(
                f"{name}: {k} launches for {len(calls)} batched calls")
    if len(calls) >= len(imgs) + 1:
        raise AssertionError("the batch ran one pass-1 call per stream")
    for data in out:
        info = read_avif(data)
        if (info.width, info.height, info.bit_depth) != (SIZE, SIZE, 10):
            raise AssertionError(f"parsed AVIF header {info}")
    if read_avif(out[-1]).alpha_item is None:
        raise AssertionError("batched RGBA AVIF carries no alpha item")

    # yardsticks on the same images: one encode after another, and
    # encode_batch (the hybrid card + host scheduler, PASS1_HOOKS slots)
    t0 = time.perf_counter()
    for x in imgs:
        (enc.encode_rgba if x.shape[2] == 4 else enc.encode_rgb)(x)
    seq = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = pbatch.encode_batch(imgs, enc)
    hyb = time.perf_counter() - t0
    for r in res:
        if r.error is not None:
            raise r.error
        read_avif(r.encoded.avif_file)
    print(f"[batch] same images one after another: {seq:.4f} s "
          f"({mp / seq:.4f} MP/s); encode_batch (hybrid scheduler): "
          f"{hyb:.4f} s ({mp / hyb:.4f} MP/s)")

    # the four colour streams: the sharded path's first colour chunk
    # again (same call, same grids), its frames must be the ones in the
    # AVIFs, and each stays inside the host cascade's envelope
    q = quality_to_quantizer(float(QUALITY))
    cfg = AV1Config(width=SIZE, height=SIZE, bit_depth=10, quantizer=q,
                    tweaks=SpeedTweaks.from_preset(SPEED, q),
                    chroma_sampling="444", full_range=True,
                    matrix_coefficients=6, threads=1, tune=enc.tune,
                    device="cuda")
    g = frame_geometry(cfg)
    grids = dp.run_pass1_batch(
        np.stack(rgbs), depth=10, tile_px=(g.th, g.tw),
        min_px=g.min_leaf_mi * 4, max_px=g.max_leaf_mi * 4,
        use_deltas=cfg.tweaks.fine_directional_intra, dc_q=g.dc_q,
        ac_q=g.ac_q, lam=g.lam, ovh_block=FrameEncoder.DEV_OVH_BLOCK,
        model="ycbcr", device="cuda")
    for i, rgb in enumerate(rgbs):
        planes = colorspace.rgb_to_ycbcr_host(rgb, depth=10)
        ref_planes = [planes[..., p] for p in range(3)]
        fe = FrameEncoder(planes, cfg, src8=rgb)
        fe._device_search = "inject"
        fe._dev_state = (grids[i], fe._dev_part_dict(grids[i]))
        data = fe.encode()
        if data != read_avif(out[i]).primary_item:
            raise AssertionError(f"image {i}: colour frame differs from the "
                                 "batched AVIF's")
        cp = _psnr(ref_planes, list(fe._recon_full()), SIZE, SIZE, 10)
        host = FrameEncoder(planes, dc_replace(cfg, device="off"), src8=rgb)
        hdata = host.encode()
        hp = _psnr(ref_planes, list(host._recon_full()), SIZE, SIZE, 10)
        print(f"[batch] image {i} colour: card {len(data)} B {cp:.4f} dB, "
              f"host {len(hdata)} B {hp:.4f} dB")
        if len(data) > 1.05 * len(hdata) or cp < hp - 0.1:
            raise AssertionError(f"batched image {i} outside the envelope")
    return dict(wall=wall, mp_s=mp / wall, calls=calls, launches=launches,
                sequential_s=seq, encode_batch_s=hyb)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cavif_tpu_torch.av1.config import AV1Config
    from cavif_tpu_torch.av1.encoder import frame_geometry
    from cavif_tpu_torch.av1.speed import SpeedTweaks
    from cavif_tpu_torch.ops import block_search as bs
    from cavif_tpu_torch.ops import cuda_build as cb
    from cavif_tpu_torch.ops import device_pass1 as dp
    from cavif_tpu_torch.ops import pass1_kernels as pk
    from cavif_tpu_torch.ops import proto_kernels as prk
    from cavif_tpu_torch.ops import search_kernels as sk
    from cavif_tpu_torch.ops.quality import quality_to_quantizer
    from cavif_tpu_torch.tools import dir_ablation, dir_proto

    dp.resolve_device("cuda")  # also pins TF32 off
    smi, sms, clock_hz = phase_card(torch)
    kind = torch.cuda.get_device_name(0)
    peaks = _peaks(kind, sms, clock_hz)
    phase_build(cb)

    img = _test_image(SIZE, SIZE)
    q = quality_to_quantizer(float(QUALITY))
    cfg = AV1Config(width=SIZE, height=SIZE, bit_depth=10, quantizer=q,
                    tweaks=SpeedTweaks.from_preset(SPEED, q),
                    chroma_sampling="444", full_range=True,
                    matrix_coefficients=6)
    geo = frame_geometry(cfg)
    geo.depth = 10
    with torch.inference_mode():
        planes = dp._convert(torch.from_numpy(img).cuda(), "ycbcr", 10)
        rows = phase_kernels(torch, pk, dp, geo, planes,
                             cfg.tweaks.fine_directional_intra, peaks)
        rows += phase_search_kernel(torch, sk, bs, geo, planes, peaks)
        inputs = _shape_inputs(torch, dp, geo, planes,
                               cfg.tweaks.fine_directional_intra)
        proto_rows, proto_launches = phase_proto(
            torch, prk, pk, dp, dir_proto, dir_ablation, inputs, peaks)
        del inputs
    del planes
    phase_small_reference(dp, geo, img)
    launches = phase_encode(torch, pk, img)
    phase_quality(img)
    launches["mode_cost"] = phase_block_search(torch, sk, bs, geo, img)
    phase_batch(torch, pk, dp, img)
    launches.update(proto_launches)
    # K4's and K5's rows sum the four tiers at the harnesses' defaults
    # (reduce "matmul", variant "full", the default tile)
    rows += [r for r in proto_rows if r["tile"] == prk.DEFAULT_TILE
             and r["mode"] in ("matmul", "full")]

    kernels = []
    for name in ("dir_cost", "nd_cost", "mode_cost", "fused_dir_cost",
                 "dir_ablation"):
        # K3's row sums the tiers that its counted path (the partition
        # search, tiers 8-32) runs; the n = 4 tier stands in its [k3] line
        mine = [r for r in rows if r["name"] == name
                and not (name == "mode_cost" and r["shape"] == "4x4")]
        sums = {k: float(sum(r[k] for r in mine))
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by_ops = sum(r["bound_ms"] for r in mine
                     if r["bound_by"] == "operations")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=int(launches[name]),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=sums["ms"], plain_ms=sums["plain_ms"],
            bound_ms=sums["bound_ms"],
            bound_by="operations" if by_ops * 2 >= sums["bound_ms"]
            else "bytes",
            library_ms=sums["library_ms"],
        ))
    print("[kernels] times are per 1024x1024 frame, summed over the ten "
          "block shapes (K1, K2; launches per RGB encode) or the tiers 8, 16 "
          "and 32 (K3; launches per plane_partition_search); K4 and K5 "
          "per harness frame, summed over the tiers 4-32 (launches: one "
          "counted harness call per tier)")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
