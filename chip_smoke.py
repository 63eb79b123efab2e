#!/usr/bin/env python3
"""Card-side check of the PyTorch/CUDA port (cavif_tpu_torch) on one GPU.

    python3 chip_smoke.py     # needs one CUDA card

Phases, each of which fails the run (exit code != 0) when it fails:

1. card: the GPU's name, power limit and maximum SM clock (nvidia-smi),
   torch and CUDA versions;
2. build: nvcc compiles the five kernel sources from cavif_tpu_torch/csrc/
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
   costs, split-f16 products on the tensor cores) on the three 10-bit
   YCbCr planes of the same image at the same quantizers, for each n in
   {4, 8, 16, 32} (Kronecker form at 4, 8, separable at 16, 32), against its f32
   plain version by the tie-aware rule: argmin differences beyond the
   float64 oracle's near-ties (rtol 1e-5) on fewer than 1e-3 of the blocks
   (the raw share and the exact ties printed beside), fewer than 1e-3 of
   the costs beyond rtol 2e-4, N - 37 blocks giving those blocks bit for
   bit and two launches bit-equal; CUDA-event times of kernel (with the
   host's time per call), plain version and an f32 torch.matmul pair
   computing the 13 candidates' D R D^T alone, the bound (the products at
   the tensor cores' rate beside the quantizer) beside the bound that
   counted them at the CUDA cores' f32 rate, and the launch geometry;
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
5. the in-loop filter chain (ops/device_filters.py, plain PyTorch on the
   card): the attachment probe and its engage flags; deblock_device,
   cdef_device, lr_wiener_plane_device (luma and one chroma plane) and
   lr_sgr_plane_device on the card, each bit-equal to the port's native
   C++ on the same encoder state of the 1024x1024 frame, timed by the host
   clock and CUDA events beside the C++, with its CUDA kernels per call
   (torch.profiler); one run_filter_chain call (decisions equal the host
   chain's, kernels per call, device busy share); the RGB and RGBA encodes
   with the chain auto-engaged: the device_filters span ran, the host
   filter spans did not, the AVIF bytes equal the chain-off
   (CAVIF_TPU_DEVICE_FILTERS=0) encodes', the traced split of both, and
   the deblock kernel's launches in each chain-on encode (set to 0 just
   before, read just after: 4 per plane of each chain call); then the
   deblock kernel (csrc/deblock.cu) against its plain pass on the
   card, bit for bit, at the frame's shapes and at 8K (the frame's planes
   and maps tiled to 7680x4320): CUDA-event ms of the search's and the
   apply's passes summed over planes and axes, beside the plain pass's
   and the bound (bytes at the card's rate against its integer
   operations), and the kernels of one level search and pick;
6. the block-search path at full size: plane_partition_search (tiers
   8-32: three K3 launches) and plane_mode_search at n = 16 (one), each
   with K3's count set to 0 just before and read just after; the same
   partition search with backend="plain" (the plain version on the card):
   per tier, modes differ beyond the float64 oracle's near-ties on fewer
   than 1e-3 of the blocks, fewer than 1e-3 of the min costs lie beyond
   rtol 2e-4, and codes differ on fewer than 1e-3 of the entries; at
   256x256 the card's search holds the same rule against device="cpu";
7. the batched path: encode_batch_sharded on four 1024x1024 RGB images and
   one RGBA image (host stealing off), K1/K2 launch counts (one launch
   per block shape and sub-batch, not per image), every AVIF parsed, the
   four colour streams inside the host envelope as in phase 4, wall time
   and MP/s, beside the same images encoded one after another and through
   encode_batch (the hybrid card + host scheduler); the filter chain runs
   once per stream and every AVIF equals the same batch's with the chain
   off;
8. the mesh: four processes on the one card form a (data, tile) = (2, 2)
   mesh over gloo, then one process a (1, 1) mesh over NCCL; each rank
   runs run_pass1_batch on the four RGB images, plane_partition_search on
   the test image's three 10-bit planes and encode_batch_sharded on the
   five images, with K1/K2/K3 launch counts per call (each > 0 on every
   rank) and walls beside the meshless ones; all ranks bit-equal, and
   equal to the meshless run (a pass-1 grid difference from cuBLAS's
   row-count-dependent f32 product is printed and held below 1e-3 with
   the colour streams in the envelope); the rows computed per frame (the
   halo's cost);
9. pass 2's device reconstruction (ops/device_pass2.py on device_itx.py
   and device_predict.py, plain PyTorch): the uniform and scan entry points
   on the card bit-equal to the host walk of a real 128x128 encode; every
   inverse transform size and DCT/ADST variant bit-equal to the CPU and
   the native C++, the predictors on every candidate to the CPU; at the
   reference's measured configuration (1024x1024, n = 16, dc_q 499, ac_q
   616, seeded decisions) the scan and the 3-plane frame executor at tile
   grids (1, 1) and (8, 8) bit-equal to the CPU, the frame to the
   per-plane scans and each (8, 8) tile to its own scan; per entry point
   the host-clock and CUDA-event ms per call, the host preparation's ms,
   the levels and lanes, and the CUDA kernels and device-busy ms of one
   call; for context the traced encode's tiles_pass1+2 span;
10. the dirty-alpha cleaner's torch backend on the card bit-equal to numpy
   on a 1024x1024 RGBA image with a transparent region, with times;
11. BASELINE.json's configurations through the port ([configs]): (1)
   the CLI (python -m cavif_tpu_torch) with its defaults on three 1 MP
   PNGs at once, each file byte-equal to an in-process encode with the
   same settings (K1/K2 launches counted); (2) --depth=8 at --quality
   40, 60, 80, 95; (3) RGBA with and without --dirty-alpha; (4)
   --color=rgb at --speed 1 (the 64 px tier priced) and 10, the filter
   chain auto-engaged where the encode searches filters and byte-neutral;
   every CLI call in its own process, all started together, each output
   parsed and decoded, each colour stream (its frame equal to the file's
   colour item) inside the host envelope, or for the gbr model, where the
   f32 pass 1 on the CPU is itself outside it, inside that stream's; (5a) the 7680x4320 frame (tools/bench8k), cold then
   warm with the chain on: K1/K2 launched, decoded, inside the envelope,
   equal to the chain-off colour frame, with wall, MP/s and the card's
   peak memory; (5b) the first BATCH_N images of tools/batch512_bench
   through encode_batch and encode_batch_sharded: every AVIF parsed,
   alpha on every 8th, warm MP/s, the first image of each shape bucket
   inside the envelope (decoded); then tools/bench's stage split,
   roofline (its peaks naming the card) and attachment flags;
12. the ports of the repository's JAX-driven scripts ([tools]): (a)
   cavif_tpu_torch.entry's entry() program on its example batch, its
   packed shape asserted and bit-equal to run_pass1_batch, and
   dryrun_multichip(1) (one NCCL rank, a (1, 1) mesh) equal to it; (b)
   tools/card_probe and card_probe2 at 1024x1024, every line printed, K3
   launched, no failure caught; (c) tools/bdrate's dense sweep (Q40-92
   step 4) of photo (768x768) and bench1024 on the card, on the host
   cascade and through libaom speed 6: BD-PSNR, BD-SSIM and BD-rate of
   the card against libaom and against the host, the card held to
   BD-PSNR >= -0.1 dB and BD-rate <= +5% of the host on each image, every
   AVIF decoded by Pillow; (d) tools/scale_bench --n 4 --size 512 (world 1
   and 2 over gloo, sharing the card), its JSON line;
13. the card run of the port's tests ([suite]): the files that
   cavif_tpu_torch/tools/run_device_tests.sh lists, collected in a pytest
   subprocess under -m "not jax_reference" (this machine has no JAX), and
   the ports of tests/test_delta_q.py and tests/test_eob_adapt.py run on
   the card (CAVIF_TORCH_TEST_DEVICE=cuda): a collection error, a failure
   or an error fails the run; the counts and every skip's reason printed;
14. one JSON line listing the kernels, the card line, and last the JSON
   result line. Every phase prints its seconds ([time] lines).

Without a CUDA card, or outside a checkout of the repository, it exits
non-zero and prints no result. Long output (nvcc's ptxas report) goes to
chiprun_out/chip_smoke_build.txt.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
sys.path.insert(0, ROOT)
# the agreement rules that the card-side tests apply too (outside a
# checkout of the repository this import fails: no result is printed)
from cavif_tpu_torch import testing  # noqa: E402
from cavif_tpu_torch.testing import (  # noqa: E402
    ARGMIN_TOL, BF16_REL, COST_RTOL, hold, hold_k3)

SHAPES = ((4, 4), (8, 8), (16, 16), (32, 32),
          (8, 4), (4, 8), (16, 8), (8, 16), (32, 16), (16, 32))
SIZE = 1024
QUALITY, SPEED = 80, 4
PROTO_TIERS = (4, 8, 16, 32)
# pass 2's wavefront at the reference's measured configuration
# (cavif_tpu/ops/device_pass2.py:23-33): 1024x1024 planes of 64x64
# blocks of n = 16, 10 bits, dc_q 499, ac_q 616; the frame has 3 planes
PASS2_SIZE, PASS2_N, PASS2_DQ, PASS2_AQ = 1024, 16, 499, 616
ITX_SIZES = ((4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (8, 4), (4, 8),
             (16, 8), (8, 16), (32, 16), (16, 32))
PRED_SIZES = ((8, 8), (16, 16), (32, 32), (16, 8), (8, 16))
# the [mesh] phase: (data, tile) of its four gloo ranks on the one card,
# and the seconds its worker processes may take, per group
MESH_SHAPE = (2, 2)
MESH_TIMEOUT = 420
# the [configs] phase (BASELINE.json's configurations): the CLI's
# qualities at 8 bits, its speeds with --color=rgb, the mixed batch's
# length (the first images of tools/batch512_bench), and the seconds each
# CLI process may take
CONFIG_QUALITIES = (40, 60, 80, 95)
CONFIG_SPEEDS = (1, 10)
BATCH_N = 16
CLI_TIMEOUT = 600
# the [tools] phase: the probes' plane size, the BD images (the two that
# tools/ssim_probe.py singles out) and the card's limits against the host
# cascade at matched rate (the per-encode envelope's, in BD form), and
# the scaling bench's arguments
PROBE_SIZE = 1024
BD_IMAGES = ("photo", "bench1024")
BD_PSNR_MIN, BD_RATE_MAX = -0.1, 5.0
SCALE_ARGS = ("--n", "4", "--size", "512")
# the [suite] phase: the card run's test files that no other phase covers
# (the ports of tests/test_delta_q.py and tests/test_eob_adapt.py), and
# the seconds each pytest process may take
SUITE_RUN = ("tests/test_torch_delta_q.py", "tests/test_torch_eob_adapt.py")
SUITE_TIMEOUT = 300
REPLACES = {
    "dir_cost": "cavif_tpu/ops/device_pass1.py:594",  # _fused_dir_cost
    "nd_cost": "cavif_tpu/ops/device_pass1.py:475",   # _fused_nd_cost
    "mode_cost": "cavif_tpu/ops/pallas_search.py:101",  # _pallas_kernel
    "fused_dir_cost": "tools/pallas_proto.py:74",  # pallas_fused
    "dir_ablation": "tools/pallas_proto2.py:17",   # make
    "deblock": "none (cavif_tpu/ops/device_filters.py _deblock_axis is XLA)",
}
SOURCES = {
    "dir_cost": "cavif_tpu_torch/csrc/pass1_dir_cost.cu",
    "nd_cost": "cavif_tpu_torch/csrc/pass1_nd_cost.cu",
    "mode_cost": "cavif_tpu_torch/csrc/mode_search_cost.cu",
    "fused_dir_cost": "cavif_tpu_torch/csrc/dir_cost_tc.cu",
    "dir_ablation": "cavif_tpu_torch/csrc/dir_cost_tc.cu",
    "deblock": "cavif_tpu_torch/csrc/deblock.cu",
}
# the deblock kernel's 8K shape (the benchmark's frame) and its integer
# instructions per fired (line, edge, level), counted from the source: the
# tests, the widest filter, the window's loads and the writes and deltas
DEBLOCK_8K = (4320, 7680)
DEBLOCK_OPS = 200


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
            mism, max_abs, over = hold(what, got, ref)
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
    trace.set_accumulate(True)
    try:
        t0 = time.perf_counter()
        enc.encode_rgb(img)
        traced = time.perf_counter() - t0
        stages = trace.walls()
    finally:
        trace.set_accumulate(False)
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


def _host_ms(fn, reps: int = 3):
    """(result of the last call, median host-clock ms per call) after one
    warm-up call; fn ends in a host result, so the clock covers its device
    work and transfers."""
    out = fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return out, sorted(ts)[len(ts) // 2]


def _profile(torch, fn, host: bool = False):
    """(CUDA kernels, memory copies/sets, summed device ms) of one call of
    fn under torch.profiler; with host=True also the host side of the
    same call: the ms of its top-level aten ops (dispatch and issue) and
    the ms inside CUDA launch calls, both inflated by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = copies = 0
    dev_us = ops_us = launch_us = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            if e.name.startswith(("cudaLaunch", "cuLaunch")):
                launch_us += e.time_range.elapsed_us()
            elif e.name.startswith("aten::") and e.cpu_parent is None:
                ops_us += e.time_range.elapsed_us()
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels += 1
        dev_us += e.time_range.elapsed_us()
    if host:
        return kernels, copies, dev_us / 1e3, ops_us / 1e3, launch_us / 1e3
    return kernels, copies, dev_us / 1e3


def _trace_split(enc, x, rgba):
    """(AVIF bytes, wall s, span totals) of one traced encode; the spans
    of the colour and alpha stream threads are summed across threads."""
    from cavif_tpu_torch.utils import trace

    trace.set_enabled(True)
    trace.set_accumulate(True)
    try:
        t0 = time.perf_counter()
        res = (enc.encode_rgba if rgba else enc.encode_rgb)(x)
        wall = time.perf_counter() - t0
        stages = trace.walls()
    finally:
        trace.set_accumulate(False)
        trace.set_enabled(False)
    return res.avif_file, wall, stages


def _deblock_case(df, fe, geo, shape):
    """(rec, src, (txw, txh, ev, eh), mi_rows, mi_cols, vis) as numpy of the
    encoded frame, or with shape (H, W) its planes and maps tiled to that
    frame (planes padded to 64 as the encoder pads them)."""
    grids = [df._filter_grids(a, fe.mi_rows, fe.mi_cols, "cpu").numpy()
             for a in fe._filter_maps[1:]]
    rec, src = fe._recon_full(), fe._src_stack()
    if shape is None:
        return rec, src, grids, fe.mi_rows, fe.mi_cols, geo["vis"]
    H, W = shape
    mi_rows, mi_cols = -(-H // 4), -(-W // 4)

    def tile(a, n0, n1):
        reps = (1,) * (a.ndim - 2) + (-(-n0 // a.shape[-2]),
                                      -(-n1 // a.shape[-1]))
        return np.ascontiguousarray(np.tile(a, reps)[..., :n0, :n1])

    pad = lambda n: -(-n // 64) * 64
    return (tile(rec, pad(H), pad(W)), tile(src, pad(H), pad(W)),
            [tile(g, mi_rows, mi_cols) for g in grids], mi_rows, mi_cols,
            (W, H))


def phase_deblock(torch, df, fe, geo, sub, peaks, per_call):
    """The deblock kernel against its plain pass (df._deblock_axis) on the
    card, bit for bit, for every pass of a level search (four candidates
    at the speed's subsample, scored) and of an apply (one level), at the
    frame's shapes and at DEBLOCK_8K; CUDA-event ms summed over the
    planes and both axes, beside the plain pass's and the bound: bytes
    (the input planes, src, the output planes) at the card's rate against
    DEBLOCK_OPS integer instructions per fired (line, edge, level) at 64
    INT32 lanes per SM and clock. Then the CUDA kernels of one level
    search and pick; per_call is the kernel's launches per chain call of
    phase_filters' RGB encode (the main path)."""
    from cavif_tpu_torch.ops import cuda_build

    i32 = torch.int32
    int_rate = peaks["instr"] / 2  # 64 INT32 lanes per SM, 128 FP32
    cands = df._deblock_cands(fe._lf_hint())
    info = (ctypes.c_int * 3)()
    for hor in (0, 1):
        fn = cuda_build.function("deblock", "deblock_pass_info",
                                 [ctypes.c_int, ctypes.c_void_p])
        if fn(hor, info) != 0:
            raise AssertionError("[deblock] deblock_pass_info failed")
        print(f"[deblock] {'horizontal' if hor else 'vertical'} pass: "
              f"{info[0]} threads, {info[1]} registers, {info[2]} B shared "
              "memory per block")
    rows = []
    for name, shape in (("1mp", None), ("8k", DEBLOCK_8K)):
        rec, src, (txw, txh, ev, eh), mi_rows, mi_cols, vis = _deblock_case(
            df, fe, geo, shape)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
        rec_t, src_t = t(rec), t(src)
        maps = [t(g) for g in (txw, txh, ev, eh)]
        for phase, levels, rs in (("search", cands, sub),
                                  ("apply", cands[2:3], 1)):
            lvl = torch.tensor(levels, dtype=i32, device="cuda").reshape(
                -1, 1, 1)
            on = sum(v > 0 for v in levels)
            ms = plain_ms = nbytes = ops = 0.0
            for pl in range(rec.shape[0]):
                g = min(pl, 1)
                s_pl = src_t[pl] if phase == "search" else None
                plane = rec_t[pl]
                for hor in (False, True):
                    tx, edge = (maps[1], maps[3]) if hor else (maps[0],
                                                               maps[2])
                    args = (plane, s_pl, tx[g], edge[g], lvl, fe.bit_depth,
                            mi_rows, mi_cols, pl == 0, vis, rs)
                    got = df.deblock_pass(*args, horizontal=hor)
                    ref = df._deblock_axis(*args, horizontal=hor)
                    if not (torch.equal(got[0], ref[0])
                            and torch.equal(got[1], ref[1])):
                        raise AssertionError(
                            f"[deblock] {name} {phase} plane {pl} "
                            f"{'horizontal' if hor else 'vertical'}: the "
                            "kernel differs from the plain pass")
                    del ref
                    ms += _cuda_ms(torch, lambda: df.deblock_pass(
                        *args, horizontal=hor), 20)
                    plain_ms += _cuda_ms(torch, lambda: df._deblock_axis(
                        *args, horizontal=hor), 3)
                    nbytes += 4 * (plane.numel() + got[0].numel()
                                   + (0 if s_pl is None else s_pl.numel()))
                    e = (eh if hor else ev)[g]
                    fire = (e[1:, :] if hor else e[:, 1:]) != 0
                    if rs > 1:
                        # the subsample's mi rows: the edge's (horizontal),
                        # the filtered line's (vertical)
                        m = np.arange(1 if hor else 0, mi_rows)
                        fire = fire & (((m >> 4) % rs) == 0)[:, None]
                    ops += 4.0 * fire.sum() * on * DEBLOCK_OPS
                    plane = got[0]
            t_bytes = nbytes / peaks["bytes"] * 1e3
            t_ops = ops / int_rate * 1e3
            row = dict(name=f"deblock.{name}.{phase}", shape=name,
                       phase=phase, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes_ms=t_bytes, ops_ms=t_ops)
            rows.append(row)
            print(f"[deblock] {name} {phase} ({len(levels)} levels, "
                  f"row_sub {rs}; {rec.shape[0]} planes x 2 axes): bit-equal "
                  f"to the plain pass; kernel {ms:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}: bytes "
                  f"{t_bytes:.4f}, operations {t_ops:.4f}), plain "
                  f"{plain_ms:.3f} ms", flush=True)
        del rec_t, src_t, maps
        torch.cuda.empty_cache()
    rec_t, src_t = df._upload(fe._recon_full(), "cuda"), df._upload(
        fe._src_stack(), "cuda")
    grids = [df._filter_grids(a, fe.mi_rows, fe.mi_cols, "cuda")
             for a in fe._filter_maps[1:]]
    cand_t = torch.tensor(cands, dtype=i32, device="cuda")
    with torch.inference_mode():
        kernels, copies, dev_ms = _profile(torch, lambda: df._deblock_search_apply(
            rec_t, src_t, *grids, cand_t, cand_t, row_sub=sub,
            **dict(geo, vis=tuple(geo["vis"]))))
    print(f"[deblock] {per_call:g} kernel launches per chain call of the "
          "RGB encode; "
          f"one level search and pick (what the chain issues between its "
          f"deblock and cdef marks): {kernels} CUDA kernels + {copies} "
          f"copies, device busy {dev_ms:.3f} ms")
    if per_call != 12 or kernels > 40:
        raise AssertionError("[deblock] expected 12 kernel launches per "
                             "chain call of the RGB encode and at most 40 "
                             "kernels")
    return dict(name="deblock", route="cuda", source=SOURCES["deblock"],
                replaces=REPLACES["deblock"], launches=per_call,
                kernels_per_search=kernels, rows=rows)


def phase_filters(torch, img, peaks):
    """The in-loop filter chain on the card. The attachment probe and
    its engage flags; each stage's entry point (deblock_device,
    cdef_device, lr_wiener_plane_device, lr_sgr_plane_device) on the card,
    held exactly against the port's native C++ on the same encoder state,
    timed beside it; the CUDA kernels of one run_filter_chain call
    (torch.profiler); the RGB and RGBA encodes with the chain
    auto-engaged, whose AVIF bytes must equal the chain-off
    (CAVIF_TPU_DEVICE_FILTERS=0) encodes'."""
    from cavif_tpu_torch import Encoder, native
    from cavif_tpu_torch.av1.config import AV1Config
    from cavif_tpu_torch.av1.encoder import FrameEncoder
    from cavif_tpu_torch.av1.speed import SpeedTweaks
    from cavif_tpu_torch.ops import attachment, colorspace
    from cavif_tpu_torch.ops import device_filters as df
    from cavif_tpu_torch.ops.quality import quality_to_quantizer

    os.environ.pop("CAVIF_TPU_DEVICE_FILTERS", None)
    p = attachment.probe()
    p2, filt = attachment.engage_device_pass2(), attachment.engage_device_filters()
    print(f"[filters] probe {json.dumps(p)}; engage_device_pass2 {p2}, "
          f"engage_device_filters {filt}")
    if not filt:
        raise AssertionError("the probe does not engage the filter chain")

    # the encoder state: the bench frame encoded with the host chain
    h, w = img.shape[:2]
    q = quality_to_quantizer(float(QUALITY))
    planes = colorspace.rgb_to_ycbcr_host(img, depth=10)
    cfg = AV1Config(width=w, height=h, bit_depth=10, quantizer=q,
                    tweaks=SpeedTweaks.from_preset(SPEED, q),
                    chroma_sampling="444", full_range=True,
                    matrix_coefficients=6, threads=None, tune="psnr")
    os.environ["CAVIF_TPU_DEVICE_FILTERS"] = "0"
    try:
        fe = FrameEncoder(planes, cfg, src8=img)
        fe.encode()
    finally:
        del os.environ["CAVIF_TPU_DEVICE_FILTERS"]
    host_levels = tuple(fe._lf_levels)
    host_units = dict(fe._lr_units or {})
    rec, src, maps = fe._recon_full(), fe._src_stack(), fe._filter_maps
    geo = dict(bit_depth=fe.bit_depth, mi_rows=fe.mi_rows,
               mi_cols=fe.mi_cols, vis=(w, h))
    sub = 1 if SPEED <= 2 else (2 if SPEED <= 3 else 4)
    nthr = os.cpu_count() or 1
    stages = {}

    def stage(name, host_fn, card_fn, same):
        host_out, host_ms = _host_ms(host_fn)
        card_out, card_ms = _host_ms(card_fn)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            card_fn()
        end.record()
        end.synchronize()
        ev_ms = start.elapsed_time(end) / 3
        kernels, copies, dev_ms = _profile(torch, card_fn)
        if not same(host_out, card_out):
            raise AssertionError(f"[filters] {name}: card differs from the "
                                 "host C++")
        stages[name] = dict(card_ms=card_ms, card_event_ms=ev_ms,
                            host_cpp_ms=host_ms, kernels=kernels,
                            copies=copies, device_ms=dev_ms)
        print(f"[filters] {name:<7} bit-equal to the host C++; card "
              f"{card_ms:.3f} ms host clock, {ev_ms:.3f} ms CUDA events "
              f"(upload and fetch included), {kernels} kernels + {copies} "
              f"copies busy {dev_ms:.3f} ms; host C++ {host_ms:.3f} ms")
        return host_out, card_out

    def host_deblock():
        levels = fe._deblock_apply()
        return levels, fe._filtered_stack

    (levels, dstack), _ = stage(
        "deblock", host_deblock,
        lambda: df.deblock_device(rec, src, maps, fe._lf_hint(),
                                  row_sub=sub, **geo),
        lambda a, b: tuple(a[0]) == b[0] and np.array_equal(a[1], b[1]))
    pre = dstack.copy()
    pri = fe.CDEF_PRI if SPEED <= 3 else fe.CDEF_PRI_FAST

    def host_cdef():
        fe._filtered_stack = pre
        y, uv, damping = fe._cdef_apply()
        return y, uv, damping, fe._filtered_stack

    uncode = lambda s: 4 if s == 3 else s

    def same_cdef(a, b):
        y, uv, _d, stack = a
        hy = (y[0][0], uncode(y[0][1])) if y else (0, 0)
        huv = (uv[0][0], uncode(uv[0][1])) if uv else (0, 0)
        return b[0] == hy + huv and np.array_equal(stack, b[1])

    damping = min(6, 3 + (fe.base_q >> 6))
    (_y, _uv, _d, post), _ = stage(
        "cdef", host_cdef,
        lambda: df.cdef_device(pre, src, maps[0], damping, sub=sub,
                               fast_sec=1 if SPEED >= 4 else 0,
                               cands=(0,) + tuple(pri), **geo),
        same_cdef)
    post = post.copy()
    u = fe.LR_UNIT
    rows, cols = fe._lr_grid()
    margin = 2.0 * fe._lambda() * 40.0
    same_all = lambda a, b: all(np.array_equal(np.asarray(x), np.asarray(y))
                                for x, y in zip(a, b))
    for pl, ntaps in ((0, 3), (1, 2)):
        stage(
            f"wiener{pl}",
            lambda: native.lr_wiener_plane(
                src[pl], post[pl], h, w, u, rows, cols, ntaps=ntaps,
                margin=margin, n_threads=nthr, want_var=True, mu=0.0),
            lambda: df.lr_wiener_plane_device(
                src[pl], post[pl], h, w, u, rows, cols, ntaps, margin,
                want_var=True),
            same_all)
    tier = 2 if SPEED >= 4 else 0
    stage("sgr",
          lambda: native.lr_sgr_plane(src[0], post[0], h, w, u, rows, cols,
                                      10, tier, n_threads=nthr,
                                      want_var=True, mu=0.0),
          lambda: df.lr_sgr_plane_device(src[0], post[0], h, w, u, rows,
                                         cols, 10, tier, want_var=True),
          same_all)

    # the whole chain on the same frame: decisions equal the host chain's
    res, chain_ms = _host_ms(lambda: df.run_filter_chain(fe))
    if tuple(fe._lf_levels) != host_levels or fe._lr_units != host_units:
        raise AssertionError("[filters] run_filter_chain decisions differ "
                             "from the host chain's")
    kernels, copies, dev_ms = _profile(torch, lambda: df.run_filter_chain(fe))
    print(f"[filters] run_filter_chain (F1 + F2) {chain_ms:.3f} ms host clock, "
          f"decisions {res[0]} cdef {res[1]}{res[2]} lr {res[4]} equal to the "
          f"host chain's; one call launches {kernels} CUDA kernels + "
          f"{copies} copies, device busy {dev_ms:.3f} ms "
          f"({100.0 * dev_ms / chain_ms:.1f}% of the call's wall)")
    stages["chain"] = dict(card_ms=chain_ms, kernels=kernels, copies=copies,
                           device_ms=dev_ms)

    # the encodes: chain auto-engaged against chain off, byte for byte
    enc = Encoder.new().with_quality(QUALITY).with_speed(SPEED)
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = np.clip((xx + yy) * 255 // (w + h - 2), 0, 255).astype(np.uint8)
    calls = []
    real = df.run_filter_chain

    def counted(f):
        out = real(f)
        calls.append((out is not None, f.num_planes))
        return out

    main_launches = {}
    for what, x, rgba in (("rgb", img, False),
                          ("rgba", np.dstack([img, alpha]), True)):
        calls.clear()
        df.run_filter_chain = counted
        df.reset_launches()
        try:
            on, wall_on, split_on = _trace_split(enc, x, rgba)
        finally:
            df.run_filter_chain = real
        # the deblock kernel on the main path: per chain call, each plane's
        # search and apply, each in both axes
        launched = df.LAUNCHES["deblock"]
        want = sum(4 * p for _ok, p in calls)
        print(f"[filters] {what} encode, chain on: {launched} deblock kernel "
              f"launches in {len(calls)} chain calls (planes "
              f"{[p for _ok, p in calls]}; {want} expected)")
        if launched != want:
            raise AssertionError(f"[filters] {what}: {launched} deblock "
                                 f"kernel launches, {want} expected")
        main_launches[what] = launched / max(len(calls), 1)
        os.environ["CAVIF_TPU_DEVICE_FILTERS"] = "0"
        try:
            off, wall_off, split_off = _trace_split(enc, x, rgba)
        finally:
            del os.environ["CAVIF_TPU_DEVICE_FILTERS"]
        fmt = lambda d: json.dumps({k: round(v, 5) for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])})
        print(f"[filters] {what} traced encode, chain on: {wall_on:.4f} s, "
              f"chain calls {len(calls)}, stages {fmt(split_on)}")
        print(f"[filters] {what} traced encode, chain off: {wall_off:.4f} s, "
              f"stages {fmt(split_off)}")
        if (not calls or not all(ok for ok, _p in calls)
                or "device_filters" not in split_on):
            raise AssertionError(f"[filters] {what}: the chain did not run")
        if any(k in split_on for k in ("deblock", "cdef", "lr_solve")):
            raise AssertionError(f"[filters] {what}: host filter spans ran "
                                 "beside the chain")
        if on != off:
            raise AssertionError(f"[filters] {what}: AVIF bytes differ with "
                                 "the chain on and off")
        print(f"[filters] {what}: {len(on)} bytes, identical with the chain "
              "on and off")
    print("[filters] " + json.dumps({"stages": stages}))
    return phase_deblock(torch, df, fe, geo, sub, peaks,
                         main_launches["rgb"])


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
    1 MP frame's three planes, by the tie-aware rule; determinism, times,
    bounds and launch geometry. search_inputs packs the split constants
    (once per n, outside the timed calls)."""
    rows = []
    for n in sk.SIZES:
        kw = bs.search_inputs(planes, n, geo.depth, geo.dc_q, geo.ac_q,
                              geo.lam)
        NB = kw["blocks"].shape[0]
        ref = sk.mode_cost_ref(**kw)
        plain_ms = _cuda_ms(torch, lambda: sk.mode_cost_ref(**kw), 5)
        # library yardstick: the 13 candidates' D R D^T alone, as one
        # batched f32 torch.matmul pair (TF32 off; the port never calls it)
        preds = torch.cat([
            sk.nondir_preds(kw["above"], kw["left"], kw["scal"], kw["smw"]),
            sk.dir_preds(kw["ext"], kw["taps"]).view(NB, 6, n, n)], 1)
        res = (kw["blocks"][:, None] - preds).float()
        d, dt = kw["dct"], kw["dct"].T.contiguous()
        lib_ms = _cuda_ms(torch, lambda: torch.matmul(torch.matmul(d, res),
                                                      dt), 20)
        del preds, res
        # the separable DCT's 4 n^3 flops per candidate at the tensor
        # cores' f16 rate (whatever form the kernel takes), beside the
        # quantizer's 11 FP32 instructions per coefficient; the bound
        # before counted the flops at the CUDA cores' f32 rate
        nbytes = 4.0 * NB * (n * n + 2 * n + 2 + 4 * n + 1 + 13) \
            + 4.0 * (6 * n * n + n + n * n)
        flops = 13.0 * NB * 4.0 * n ** 3
        instr = 13.0 * NB * 11.0 * n * n
        bound, by, terms = _bound(peaks, nbytes, bf16_flops=flops,
                                  instr=instr)
        old_bound = _bound(peaks, nbytes, f32_flops=flops, instr=instr)[0]
        Rr = NB - 37
        part_kw = {k: (v[:Rr] if k in sk.PER_BLOCK else v)
                   for k, v in kw.items()}
        form = sk.FORMS[n]

        def run():
            return sk.mode_cost(**kw)

        got = run()
        again = run()
        part = sk.mode_cost(**part_kw)
        torch.cuda.synchronize()
        raw, ties, beyond, over = hold_k3(f"mode_cost n={n}", got, ref, kw)
        if not torch.equal(got, again):
            raise AssertionError(f"mode_cost n={n}: two launches differ")
        if not torch.equal(part, got[:Rr]):
            raise AssertionError(f"mode_cost n={n}: {Rr} blocks differ from "
                                 f"the first blocks of {NB}")
        diff = (got - ref).abs()
        max_abs = float(diff.max())
        rel = float((diff / ref.abs().clamp_min(1.0)).max())
        del again, part, diff
        ms, host_ms = _cuda_ms(torch, run, 20, host=True)
        info = sk.kernel_info(NB, n)
        rows.append(dict(
            name="mode_cost", shape=f"{n}x{n}", rows=NB,
            argmin_mismatch=raw, beyond_near_ties=beyond, beyond_tol=over,
            max_abs_err=max_abs, max_rel_err=rel, ms=ms, host_ms=host_ms,
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
            bound_by=by, old_bound_ms=old_bound, form=form, **info,
        ))
        print("[k3] n=%-2d %-4s NB=%-6d argmin raw %.2e (exact ties %.2e, "
              "beyond near-ties %.2e)  beyond rtol %.2e  max|d| %.4g rel "
              "%.3g  kernel %.4f ms (host %.4f ms per call)  plain %.4f ms  "
              "matmul pair %.4f ms  bound %.4f ms (%s; bytes %.4f, tensor "
              "cores %.4f, CUDA cores %.4f; f32-FMA bound %.4f)" % (
                  n, form, NB, raw, ties, beyond, over, max_abs, rel, ms,
                  host_ms, plain_ms, lib_ms, bound, by, *terms, old_bound))
        print("[k3] n=%-2d %-4s blocks %d (%d per SM), %d registers, %d B "
              "shared memory per block; ragged edge and repeat launch "
              "bit-equal" % (n, form, info["blocks"], info["per_sm"],
                             info["registers"], info["smem_bytes"]))
        del kw, ref, part_kw, got
    torch.cuda.synchronize()
    return rows


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
                mism, max_abs, over = hold(what, got, ref, tol)
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
            mism, max_abs, over = hold(what, got, vref, vtol)
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
            mism, max_abs, over = hold(f"k4 real {s}x{s} {reduce}",
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


def _frame_geometry():
    """The AV1Config and frame geometry of the SIZE x SIZE Q80 speed-4
    test frame."""
    from cavif_tpu_torch.av1.config import AV1Config
    from cavif_tpu_torch.av1.encoder import frame_geometry
    from cavif_tpu_torch.av1.speed import SpeedTweaks
    from cavif_tpu_torch.ops.quality import quality_to_quantizer

    q = quality_to_quantizer(float(QUALITY))
    cfg = AV1Config(width=SIZE, height=SIZE, bit_depth=10, quantizer=q,
                    tweaks=SpeedTweaks.from_preset(SPEED, q),
                    chroma_sampling="444", full_range=True,
                    matrix_coefficients=6)
    geo = frame_geometry(cfg)
    geo.depth = 10
    return cfg, geo


def _search_planes(img, geo):
    """The three 10-bit YCbCr planes of img and the partition search's
    (dc_q, ac_q, lam, bit depth)."""
    from cavif_tpu_torch.ops import colorspace

    planes = np.ascontiguousarray(
        colorspace.rgb_to_ycbcr_host(img, depth=10).transpose(2, 0, 1))
    return planes, (geo.dc_q, geo.ac_q, geo.lam, 10)


def phase_block_search(torch, sk, bs, geo, img):
    """The block-search entry points at full size on the card, with K3's
    launch count read around each; then 256x256 card vs CPU. Returns the
    partition search's K3 launches, its (tiers, codes) and wall."""
    planes, args = _search_planes(img, geo)
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
    _hold_search(torch.from_numpy(planes).cuda(), args, (tiers, codes),
                 (tp, cp), 'full size K3 vs backend="plain"')

    small = np.ascontiguousarray(planes[:, :256, :256])
    tc, cc = bs.plane_partition_search(small, *args, device="cuda")
    tp, cp = bs.plane_partition_search(small, *args, device="cpu")
    _hold_search(torch.from_numpy(small), args, (tc, cc), (tp, cp),
                 "256x256 card vs CPU")
    return part, (tiers, codes), wall


def _hold_search(x, args, got, ref, what):
    """testing.hold_search (K3's tie-aware rule per tier) on planes x,
    each tier's counts printed."""
    for n, NB, diff, ties, beyond, over, max_d, dc, nc in \
            testing.hold_search(what, x, args, got, ref):
        print(f"[search] {what}, tier {n}: modes differ on {diff} of {NB} "
              f"({ties} exact ties, {beyond} beyond near-ties), min costs "
              f"beyond rtol {COST_RTOL} {over:.2e}, max |d| {max_d:.6g}"
              + (f", codes differ on {dc} of {nc}" if nc else ""))


def _batch_images(img0):
    """The batch phases' images: img0 and three more RGB test images, and
    one RGBA image with an alpha ramp, all SIZE x SIZE."""
    rgbs = [img0] + [_test_image(SIZE, SIZE, s) for s in (43, 44, 45)]
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    alpha = np.clip((xx + yy) * 255 // (2 * SIZE - 2), 0, 255).astype(
        np.uint8)
    return rgbs + [np.dstack([_test_image(SIZE, SIZE, 46), alpha])]


def _colour_cfg(enc):
    """The AV1Config of a SIZE x SIZE colour stream of enc on the card,
    and run_pass1_batch's keywords for it (as encode_batch_sharded calls
    it)."""
    from cavif_tpu_torch.av1.config import AV1Config
    from cavif_tpu_torch.av1.encoder import FrameEncoder, frame_geometry
    from cavif_tpu_torch.av1.speed import SpeedTweaks
    from cavif_tpu_torch.ops.quality import quality_to_quantizer

    q = quality_to_quantizer(float(QUALITY))
    cfg = AV1Config(width=SIZE, height=SIZE, bit_depth=10, quantizer=q,
                    tweaks=SpeedTweaks.from_preset(SPEED, q),
                    chroma_sampling="444", full_range=True,
                    matrix_coefficients=6, threads=1, tune=enc.tune,
                    device="cuda")
    g = frame_geometry(cfg)
    kw = dict(depth=10, tile_px=(g.th, g.tw), min_px=g.min_leaf_mi * 4,
              max_px=g.max_leaf_mi * 4,
              use_deltas=cfg.tweaks.fine_directional_intra, dc_q=g.dc_q,
              ac_q=g.ac_q, lam=g.lam, ovh_block=FrameEncoder.DEV_OVH_BLOCK,
              model="ycbcr", device="cuda")
    return cfg, kw


def _colour_envelope(items, cfg, avifs=None, what="batch"):
    """Each (index, rgb, pass-1 grids) item's colour stream encoded on its
    grids (the frame of avifs[index] when avifs are given, byte for
    byte), inside the host cascade's envelope: bytes at most 1.05x, PSNR
    at least the host's minus 0.1 dB."""
    from dataclasses import replace as dc_replace

    from cavif_tpu_torch.av1.encoder import FrameEncoder
    from cavif_tpu_torch.container.parse import read_avif
    from cavif_tpu_torch.ops import colorspace

    for i, rgb, grids in items:
        planes = colorspace.rgb_to_ycbcr_host(rgb, depth=10)
        ref_planes = [planes[..., p] for p in range(3)]
        fe = FrameEncoder(planes, cfg, src8=rgb)
        # "inject" names no device, so these frames take the host C++
        # filters: the batched AVIFs (chain on) are held against them too
        fe._device_search = "inject"
        fe._dev_state = (grids, fe._dev_part_dict(grids))
        data = fe.encode()
        if avifs is not None and data != read_avif(avifs[i]).primary_item:
            raise AssertionError(f"image {i}: colour frame differs from the "
                                 "batched AVIF's")
        cp = _psnr(ref_planes, list(fe._recon_full()), SIZE, SIZE, 10)
        host = FrameEncoder(planes, dc_replace(cfg, device="off"), src8=rgb)
        hdata = host.encode()
        hp = _psnr(ref_planes, list(host._recon_full()), SIZE, SIZE, 10)
        print(f"[{what}] image {i} colour: card {len(data)} B {cp:.4f} dB, "
              f"host {len(hdata)} B {hp:.4f} dB")
        if len(data) > 1.05 * len(hdata) or cp < hp - 0.1:
            raise AssertionError(f"{what} image {i} outside the envelope")


@contextlib.contextmanager
def _pass1_calls(dp):
    """dp.run_pass1_batch wrapped for the block: yields the list of its
    calls' (model, grid dicts, srcs, keywords), in call order."""
    calls = []
    real = dp.run_pass1_batch

    def recorded(srcs, **kw):
        grids = real(srcs, **kw)
        calls.append((kw.get("model", "ycbcr"), grids, srcs, kw))
        return grids

    dp.run_pass1_batch = recorded
    try:
        yield calls
    finally:
        dp.run_pass1_batch = real


@contextlib.contextmanager
def _card_frames(dp):
    """dp.run_pass1 and dp.run_pass1_batch wrapped for the block: yields a
    list that gets, per call, the number of frames whose pass 1 ran on
    the card (1, or the batch's length); the streams of a batch path that
    it does not count went to the host cascade."""
    import threading

    frames, inner = [], threading.local()
    one, batch = dp.run_pass1, dp.run_pass1_batch

    def run_one(*a, **kw):
        out = one(*a, **kw)
        frames.append(1)
        return out

    def run_batch(srcs, **kw):
        # a long batch calls run_pass1_batch again per chunk: count the
        # outermost call only
        depth = getattr(inner, "depth", 0)
        inner.depth = depth + 1
        try:
            out = batch(srcs, **kw)
        finally:
            inner.depth = depth
        if depth == 0:
            frames.append(len(srcs))
        return out

    dp.run_pass1, dp.run_pass1_batch = run_one, run_batch
    try:
        yield frames
    finally:
        dp.run_pass1, dp.run_pass1_batch = one, batch


def phase_batch(torch, pk, dp, img0):
    """encode_batch_sharded on four RGB images and one RGBA image at
    1024x1024, then the colour streams against the host cascade. Returns
    the walls, the AVIFs and the meshless grids of the four RGB images."""
    from cavif_tpu_torch import Encoder
    from cavif_tpu_torch.container.parse import read_avif
    from cavif_tpu_torch.ops import device_filters as df
    from cavif_tpu_torch.parallel import batch as pbatch

    os.environ["CAVIF_TPU_SHARDED_STEAL"] = "0"
    imgs = _batch_images(img0)
    rgbs = imgs[:4]
    enc = Encoder.new().with_quality(QUALITY).with_speed(SPEED)

    chains = []  # run_filter_chain calls (True: the chain ran)
    real_chain = df.run_filter_chain

    def counted_chain(fe):
        res = real_chain(fe)
        chains.append(res is not None)
        return res

    df.run_filter_chain = counted_chain
    try:
        t0 = time.perf_counter()
        pbatch.encode_batch_sharded(imgs, enc)
        warm = time.perf_counter() - t0
        chains.clear()
        pk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _pass1_calls(dp) as pass1_calls:
            out = pbatch.encode_batch_sharded(imgs, enc)
        wall = time.perf_counter() - t0
        launches = dict(pk.LAUNCHES)
        n_chains = len(chains)
        if not chains or not all(chains):
            raise AssertionError(f"batch: filter chain calls {chains}")
    finally:
        df.run_filter_chain = real_chain
    calls = [len(c[1]) for c in pass1_calls]  # batch sizes
    # the same batch with the chain off: every AVIF byte for byte
    os.environ["CAVIF_TPU_DEVICE_FILTERS"] = "0"
    try:
        off = pbatch.encode_batch_sharded(imgs, enc)
    finally:
        del os.environ["CAVIF_TPU_DEVICE_FILTERS"]
    for i, (a, b) in enumerate(zip(out, off)):
        if a != b:
            raise AssertionError(f"batch image {i}: AVIF differs with the "
                                 "filter chain on and off")
    print(f"[batch] filter chain ran {n_chains} times in the batch (one per "
          f"stream); all {len(out)} AVIFs identical with the chain off")
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
    cfg, kw = _colour_cfg(enc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grids = dp.run_pass1_batch(np.stack(rgbs), **kw)
    pass1_wall = time.perf_counter() - t0
    _colour_envelope([(i, rgb, grids[i]) for i, rgb in enumerate(rgbs)], cfg,
                     out)
    return dict(wall=wall, mp_s=mp / wall, calls=calls, launches=launches,
                sequential_s=seq, encode_batch_s=hyb, avifs=out,
                encode_grids=pass1_calls, grids=grids,
                pass1_wall=pass1_wall)


def _mesh_arrays(pass1, search, avifs, encode_calls) -> dict:
    """The mesh phase's results as {name: array}: run_pass1_batch's grid
    dicts ("pass1"), plane_partition_search's (tiers, codes) ("search"),
    the AVIF bytes ("encode") and the grid dicts of each pass-1 call inside
    the batched encode ("call<c>-<model>")."""
    out = {}
    parts = [("pass1", pass1)] + [(f"call{c}-{call[0]}", call[1])
                                  for c, call in enumerate(encode_calls)]
    for part, grid_dicts in parts:
        for b, g in enumerate(grid_dicts):
            for ((bw, bh), name), v in g.items():
                out[f"{part}/{b}/{bw}x{bh}/{name}"] = v
    tiers, codes = search
    for n, (m, c) in tiers.items():
        out[f"search/modes{n}"] = m
        out[f"search/costs{n}"] = c
    for n, c in codes.items():
        out[f"search/codes{n}"] = c
    for i, data in enumerate(avifs):
        out[f"encode/avif{i}"] = np.frombuffer(data, np.uint8)
    return out


def _grid_dicts(arrays: dict, part: str) -> list:
    """The grid dicts of one part of _mesh_arrays' output."""
    out = {}
    for k, v in arrays.items():
        if k.startswith(part + "/"):
            _, b, shp, name = k.split("/")
            bw, bh = (int(t) for t in shp.split("x"))
            out.setdefault(int(b), {})[((bw, bh), name)] = v
    return [out[b] for b in sorted(out)]


def _digest(arrays: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(arrays):
        v = np.ascontiguousarray(arrays[k])
        h.update(f"{k}:{v.dtype}:{v.shape}".encode())
        h.update(v.tobytes())
    return h.hexdigest()[:16]


def mesh_worker(rank: int, world: int, port: int, backend: str,
                shape: tuple, out_dir: str) -> int:
    """One rank of the [mesh] phase on card 0: the process group on
    localhost, a (data, tile) DeviceMesh of `shape` (gloo: collectives on
    the CPU; nccl: on the card), then run_pass1_batch on the four RGB
    images, plane_partition_search on the test image's three 10-bit planes
    and encode_batch_sharded on the five images, each once to warm up and
    once timed with the kernels' launch counts set to 0 just before and
    read just after. Prints one "MESH {json}" line; rank 0 writes its
    arrays to out_dir."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, ROOT)
    from cavif_tpu_torch import Encoder
    from cavif_tpu_torch.ops import attachment
    from cavif_tpu_torch.ops import block_search as bs
    from cavif_tpu_torch.ops import device_pass1 as dp
    from cavif_tpu_torch.ops import pass1_kernels as pk
    from cavif_tpu_torch.ops import search_kernels as sk
    from cavif_tpu_torch.parallel import batch as pbatch
    from cavif_tpu_torch.parallel import ranks

    os.environ["CAVIF_TPU_SHARDED_STEAL"] = "0"
    torch.cuda.set_device(0)
    dp.resolve_device("cuda")
    ranks.init_rank(rank, world, port, backend, MESH_TIMEOUT)
    try:
        mesh = init_device_mesh("cpu" if backend == "gloo" else "cuda",
                                shape, mesh_dim_names=("data", "tile"))
        _, geo = _frame_geometry()
        imgs = _batch_images(_test_image(SIZE, SIZE))
        planes, args = _search_planes(imgs[0], geo)
        enc = Encoder.new().with_quality(QUALITY).with_speed(SPEED)
        _, kw = _colour_cfg(enc)
        calls = dict(
            pass1=lambda: dp.run_pass1_batch(np.stack(imgs[:4]), mesh=mesh,
                                             **kw),
            search=lambda: bs.plane_partition_search(
                planes, *args, min_n=8, max_n=32, mesh=mesh),
            encode=lambda: pbatch.encode_batch_sharded(imgs, enc, mesh=mesh),
        )
        report = dict(rank=rank, backend=backend,
                      coord=list(mesh.get_coordinate()))
        res = {}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            dist.barrier()
            pk.reset_launches()
            sk.reset_launches()
            t0 = time.perf_counter()
            with _pass1_calls(dp) as pass1_calls:
                res[name] = fn()
            torch.cuda.synchronize()
            report[name] = dict(wall=time.perf_counter() - t0,
                                launches={**pk.LAUNCHES, **sk.LAUNCHES})
        arrays = _mesh_arrays(res["pass1"], res["search"], res["encode"],
                              pass1_calls)
        report["digest"] = _digest(arrays)
        # the filter chain's gate is this process's probe of the card
        report["probe_ms"] = attachment.probe()["rtt_ms"]
        report["chain"] = attachment.engage_device_filters()
        if rank == 0:
            np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)
        print("MESH " + json.dumps(report), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _mesh_group(world: int, backend: str, shape: tuple, out_dir: str):
    """Start `world` mesh_worker processes through the package's rank
    launcher (cavif_tpu_torch/parallel/ranks.py; MESH_TIMEOUT s in all,
    each rank's output kept in OUT_DIR/mesh_<backend>/); a worker that
    fails or times out fails the phase, and every worker is stopped.
    Returns each rank's report."""
    from cavif_tpu_torch.parallel import ranks

    outs = ranks.run_ranks(
        [sys.executable, os.path.abspath(__file__), "--mesh-worker",
         json.dumps([backend, list(shape), out_dir])], world, MESH_TIMEOUT,
        log_dir=os.path.join(OUT_DIR, f"mesh_{backend}"))
    reports = []
    for r, out in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("MESH ")]
        if len(lines) != 1:
            raise AssertionError(f"[mesh] {backend} rank {r} printed "
                                 f"{len(lines)} MESH lines")
        reports.append(json.loads(lines[0][5:]))
    return reports


def phase_mesh(torch, smi, img0, geo, batch, search, search_wall):
    """The (data, tile) mesh on card 0: four gloo ranks as a (2, 2) mesh,
    then one NCCL rank as a (1, 1) mesh (mesh_worker). Every rank must
    launch K1, K2 and K3 on its shard, the ranks of a group must agree bit
    for bit, and each group must give the meshless results of [search]
    and [batch] (the separate pass-1 call, each pass-1 call inside the
    batched encode, the AVIFs): bit for bit, or else, where cuBLAS's f32
    product of the blocks by the DCT (ShapeCost's `bkt`) changed with the
    row count of a band, on fewer than ARGMIN_TOL of each call's grid
    entries, with the colour stream of every differing AVIF inside the
    host envelope; the block search has no such product and must be
    bit-equal."""
    import tempfile

    from cavif_tpu_torch import Encoder
    from cavif_tpu_torch.parallel import mesh as shard

    meshless = _mesh_arrays(batch["grids"], search, batch["avifs"],
                            batch["encode_grids"])
    walls = dict(pass1=batch["pass1_wall"], search=search_wall,
                 encode=batch["wall"])
    data_n, tile_n = MESH_SHAPE
    for what, unit in (("pass 1", 64), ("block search", 32)):
        rows = sum(h1 - h0 for h0, h1 in (
            shard.halo(b, SIZE, unit) for b in shard.bands(SIZE, unit, tile_n)))
        print(f"[mesh] {what}: {rows} rows computed per {SIZE}-row frame "
              f"over tile = {tile_n} ({rows / SIZE:.4f}x; halo {unit} rows)")
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        groups = []
        for world, backend, shape in ((data_n * tile_n, "gloo", MESH_SHAPE),
                                      (1, "nccl", (1, 1))):
            reports = _mesh_group(world, backend, shape, tmp)
            arrays = dict(np.load(os.path.join(tmp, "arrays.npz")))
            groups.append((backend, shape, reports, arrays))
    for backend, shape, reports, arrays in groups:
        what = f"[mesh] {backend} {tuple(shape)}"
        for r in reports:
            print(f"{what} rank {r['rank']} at (data, tile) "
                  f"{tuple(r['coord'])}: " + "; ".join(
                      f"{k} {r[k]['wall']:.4f} s (meshless {walls[k]:.4f} s)"
                      f" launches {r[k]['launches']}" for k in walls)
                  + f"; filter chain {'on' if r['chain'] else 'off'} (probe "
                  f"{r['probe_ms']} ms); digest {r['digest']}; {smi}")
            for k, want in (("pass1", ("dir_cost", "nd_cost")),
                            ("search", ("mode_cost",)),
                            ("encode", ("dir_cost", "nd_cost"))):
                if any(r[k]["launches"][n] <= 0 for n in want):
                    raise AssertionError(f"{what} rank {r['rank']}: {k} "
                                         f"launched no {want} on its shard")
        digests = {r["digest"] for r in reports}
        if len(digests) != 1 or _digest(arrays) not in digests:
            raise AssertionError(f"{what}: the ranks disagree: "
                                 f"{sorted(digests)}")
        if sorted(arrays) != sorted(meshless):
            raise AssertionError(f"{what}: other results than the meshless "
                                 "run's")
        if _digest(arrays) == _digest(meshless):
            print(f"{what}: every rank bit-equal to the meshless run (pass-1 "
                  "grids, block search, the batch's pass-1 calls and AVIFs)")
            continue
        _mesh_mismatch(backend, shape, arrays, meshless, img0,
                       batch["encode_grids"])


def _bkt_diagnosis(what, call, shape):
    """For a pass-1 call (model, grids, srcs, keywords) of the meshless
    batch, each rank's share of `shape` (data, tile) priced as the mesh
    prices it, against the whole call, per fused block shape: the
    elements of ShapeCost's inputs (blocks, ext, bkt), costs and argmins
    that differ on the share's rows."""
    import torch

    from cavif_tpu_torch.ops import device_pass1 as dp
    from cavif_tpu_torch.parallel import mesh as shard

    model, _, srcs, kw = call
    B, H, W = srcs.shape[:3]
    P = 1 if model == "mono" else 3
    key = (H, W, kw["depth"], model, P, int(kw["min_px"]), int(kw["max_px"]),
           bool(kw["use_deltas"]), float(kw["ovh_block"]),
           float(kw.get("ovh_split", 2.0)), float(kw.get("rect_ovh", 4.0)))
    args = (dp._f32(kw["dc_q"]), dp._f32(kw["ac_q"]), dp._f32(kw["lam"]),
            kw["tile_px"])
    dev = dp.resolve_device(kw["device"])
    prog = dp._program(key, "f32" if dev == "cpu" else "bf16", dev)
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(srcs)).to(dev)
        planes = dp._convert_batch(x, model, kw["depth"])
        for (bw, bh) in prog.shapes:
            sc = prog.costs[f"{bw}x{bh}"]
            if not sc.fused:
                continue
            _, nd0, dr0 = sc.kernel_inputs(planes, *args)
            c0 = sc(planes, *args)
            nbx = W // bw
            diff = dict.fromkeys(("blocks", "ext", "bkt", "costs", "argmin"),
                                 0)
            tot = 0
            for b0, b1 in shard.split(B, shape[0]):
                for y0, y1 in shard.bands(H, dp.SB, shape[1]):
                    if b1 == b0 or y1 == y0:
                        continue
                    h0, h1 = shard.halo((y0, y1), H, dp.SB)
                    pb = planes.view(B, P, H, W)[b0:b1, :, h0:h1].reshape(
                        -1, h1 - h0, W)
                    _, nd1, dr1 = sc.kernel_inputs(pb, *args, row0=h0)
                    c1 = sc(pb, *args, row0=h0)

                    def rows(t, nimg, nby, a, b):  # block rows a:b
                        return t.reshape(nimg * P, nby, nbx, -1)[:, a:b]

                    whole = (B, H // bh, y0 // bh, y1 // bh)
                    band = (b1 - b0, (h1 - h0) // bh, (y0 - h0) // bh,
                            (y1 - h0) // bh)
                    for name, t0, t1 in (
                            ("blocks", nd0["blocks"], nd1["blocks"]),
                            ("ext", dr0["ext"], dr1["ext"]),
                            ("bkt", dr0["bkt"], dr1["bkt"]),
                            ("costs", c0, c1)):
                        u = rows(t0, *whole)[b0 * P : b1 * P]
                        diff[name] += int((u != rows(t1, *band)).sum())
                    u = rows(c0, *whole)[b0 * P : b1 * P]
                    v = rows(c1, *band)
                    diff["argmin"] += int((u.argmin(-1) != v.argmin(-1))
                                          .sum())
                    tot += u[..., 0].numel()
            print(f"{what} diagnosis, {model} B = {B}, {bw}x{bh} over "
                  f"{tot} blocks: " + ", ".join(
                      f"{k} differs on {v}" for k, v in diff.items()))


def _mesh_mismatch(backend, shape, arrays, meshless, img0, calls):
    """A mesh run that is not bit-equal to the meshless one: print what
    differs; hold each part's grids below ARGMIN_TOL of their entries, the
    block search bit-equal, and every colour stream of a differing AVIF
    inside the host envelope on the mesh run's own grids."""
    from cavif_tpu_torch import Encoder

    what = f"[mesh] {backend} {tuple(shape)}"
    for part in sorted({k.split("/")[0] for k in meshless}):
        keys = [k for k in meshless if k.startswith(part + "/")]
        diff = sum(int((arrays[k] != meshless[k]).sum())
                   if arrays[k].shape == meshless[k].shape
                   else meshless[k].size for k in keys)
        tot = sum(meshless[k].size for k in keys)
        print(f"{what} against the meshless run: {part} differs on {diff} "
              f"of {tot} entries" + (" (AVIF bytes)" if part == "encode"
                                     else ""))
        if part == "search" and diff:
            raise AssertionError(f"{what}: the block search differs from "
                                 "the meshless one")
        if part not in ("search", "encode") and diff >= ARGMIN_TOL * tot:
            raise AssertionError(f"{what}: {part}'s grids differ on {diff} "
                                 f"of {tot}")
        if diff and part.startswith("call"):
            _bkt_diagnosis(what, calls[int(part[4:].split("-")[0])], shape)
    # the batch's colour streams: its pass-1 calls of model ycbcr take the
    # images in order (one bucket), the RGBA image's colour as the encode
    # prepares it
    enc = Encoder.new().with_quality(QUALITY).with_speed(SPEED)
    imgs = _batch_images(img0)
    calls = sorted((p for p in {k.split("/")[0] for k in arrays}
                    if p.startswith("call")),
                   key=lambda p: int(p[4:].split("-")[0]))
    colour = [g for part in calls if part.endswith("-ycbcr")
              for g in _grid_dicts(arrays, part)]
    if len(colour) != len(imgs):
        raise AssertionError(f"{what}: {len(colour)} colour grids for "
                             f"{len(imgs)} images")
    items = []
    for i, im in enumerate(imgs):
        a, b = arrays[f"encode/avif{i}"], meshless[f"encode/avif{i}"]
        if np.array_equal(a, b):
            continue
        print(f"{what}: AVIF {i} differs ({a.size} B against {b.size} B)")
        if im.shape[2] == 4:
            conv = enc._convert_alpha_8bit(im)
            im = conv if conv is not None else im
        items.append((i, np.ascontiguousarray(im[..., :3]), colour[i]))
    _colour_envelope(items, _colour_cfg(enc)[0], what=f"mesh {backend}")


def _same(what, got, ref):
    if (got.shape != ref.shape or got.dtype != ref.dtype
            or not np.array_equal(got, ref)):
        bad = int((got != ref).sum()) if got.shape == ref.shape else -1
        raise AssertionError(f"{what}: differs ({got.shape} {got.dtype} "
                             f"against {ref.shape} {ref.dtype}, {bad} "
                             "entries)")


def phase_pass2(torch, img):
    """Pass 2's device reconstruction (ops/device_pass2.py on
    device_itx.py and device_predict.py, plain PyTorch on the card): the
    host walk of a real 128x128 encode reproduced bit for bit by the
    uniform and scan entry points; the parts on their own (every inverse
    transform size and DCT/ADST variant against the CPU and the native
    C++; the predictors on every candidate against the CPU); at 1024x1024
    the scan and frame executors (tile grids (1, 1) and (8, 8)) bit-equal
    to the same functions on the CPU, the frame to the per-plane scans and
    each (8, 8) tile of plane 0 to its own scan; then per entry point the
    host-clock and CUDA-event ms per call, the host preparation's ms, the
    levels S and lanes kmax, and the CUDA kernels, copies and device-busy
    ms of one call (torch.profiler)."""
    from cavif_tpu_torch import Encoder, native
    from cavif_tpu_torch.ops import device_pass2 as p2
    from cavif_tpu_torch.ops.device_itx import inv_txfm_batch
    from cavif_tpu_torch.ops.device_predict import (_cand_index,
                                                    predict_batch_exact)
    from cavif_tpu_torch.tools.pass2_cases import host_walk_case, random_frame

    # the host walk of a real encode (host cascade, python entropy coder)
    levels, modes, deltas, va, ha, dq, aq, ref = host_walk_case()
    for f in (p2.recon_wavefront_uniform, p2.recon_wavefront_scan):
        _same(f"[pass2] {f.__name__} against the host walk",
              f(levels, modes, deltas, va, ha, 128, 128, dq, aq, 10, 16),
              ref)
    print(f"[pass2] 128x128 host walk (dc_q {dq}, ac_q {aq}): "
          "recon_wavefront_uniform and recon_wavefront_scan on the card "
          "bit-equal to fe.planes[0].recon")

    # the parts on their own
    rng = np.random.default_rng(5)
    n_itx = 0
    for (txw, txh) in ITX_SIZES:
        cw, ch = min(txw, 32), min(txh, 32)
        lv = rng.integers(-300, 301, (64, ch, cw)).astype(np.int32)
        lv[rng.random(lv.shape) < 0.7] = 0
        for v, h in ((0, 0), (1, 0), (0, 1), (1, 1)):
            if (v or h) and max(txw, txh) > 16:
                continue  # ADST exists up to 16 points
            args = (txw, txh, PASS2_DQ, PASS2_AQ, 10, v, h)
            card = inv_txfm_batch(lv, *args)
            _same(f"[pass2] inv_txfm_batch {txw}x{txh} ({v}, {h}) card "
                  "against CPU", card, inv_txfm_batch(lv, *args,
                                                      device="cpu"))
            for b in range(len(lv)):
                _same(f"[pass2] inv_txfm_batch {txw}x{txh} ({v}, {h}) "
                      "against native", card[b],
                      native.inv_txfm_exact(lv[b], *args))
            n_itx += 1
    n_pred = 0
    for (bw, bh) in PRED_SIZES:
        for use_deltas in (True, False):
            cands = sorted(_cand_index(use_deltas))
            B = 4 * len(cands)
            L = bw + bh
            nb = (rng.integers(0, 1024, (B, L)).astype(np.int32),
                  rng.integers(0, 1024, (B, L)).astype(np.int32),
                  rng.integers(0, 1024, B).astype(np.int32),
                  rng.random(B) < 0.8, rng.random(B) < 0.8)
            md = np.asarray([cands[i % len(cands)] for i in range(B)])
            args = (md[:, 0], md[:, 1], *nb, bw, bh, 10)
            _same(f"[pass2] predict_batch_exact {bw}x{bh} card against CPU",
                  predict_batch_exact(*args),
                  predict_batch_exact(*args, device="cpu"))
            n_pred += 1
    print(f"[pass2] parts: inv_txfm_batch at {len(ITX_SIZES)} sizes, "
          f"{n_itx} (size, variant) cases of 64 blocks, card bit-equal to "
          f"the CPU and to native.inv_txfm_exact; predict_batch_exact at "
          f"{len(PRED_SIZES)} sizes with every candidate (with and without "
          "angle deltas), card bit-equal to the CPU")

    # full width: a seeded 3-plane 1024x1024 frame
    H = W = PASS2_SIZE
    n = PASS2_N
    nby, nbx = H // n, W // n
    frame = random_frame(11, 3, H, W, n)
    one = tuple(a[0] for a in frame)
    args = (H, W, PASS2_DQ, PASS2_AQ, 10, n)
    scan = p2.recon_wavefront_scan(*one, *args)
    _same("[pass2] recon_wavefront_scan card against CPU", scan,
          p2.recon_wavefront_scan(*one, *args, device="cpu"))
    planes = [scan] + [p2.recon_wavefront_scan(*(a[p] for a in frame), *args)
                       for p in (1, 2)]
    for grid in ((1, 1), (8, 8)):
        got = p2.recon_wavefront_scan_frame(*frame, *args, tile_grid=grid)
        _same(f"[pass2] recon_wavefront_scan_frame {grid} card against CPU",
              got, p2.recon_wavefront_scan_frame(*frame, *args,
                                                 tile_grid=grid,
                                                 device="cpu"))
        if grid == (1, 1):
            _same("[pass2] frame (1, 1) against the per-plane scans", got,
                  np.stack(planes))
            continue
        tr, tc = grid
        for ty in range(tr):
            for tx in range(tc):
                b0, b1 = ty * nby // tr, (ty + 1) * nby // tr
                c0, c1 = tx * nbx // tc, (tx + 1) * nbx // tc
                sub = p2.recon_wavefront_scan(
                    *(a[0, b0:b1, c0:c1] for a in frame), (b1 - b0) * n,
                    (c1 - c0) * n, PASS2_DQ, PASS2_AQ, 10, n)
                _same(f"[pass2] frame {grid} tile ({ty}, {tx})",
                      got[0, b0 * n:b1 * n, c0 * n:c1 * n], sub)
    print(f"[pass2] {H}x{W}, n = {n}: recon_wavefront_scan and "
          "recon_wavefront_scan_frame at tile grids (1, 1) and (8, 8) on "
          "the card bit-equal to the CPU; the frame at (1, 1) equal to the "
          "three per-plane scans, each (8, 8) tile of plane 0 to its own "
          "scan (recon_wavefront_uniform runs the scan's walk)")

    # numbers: per entry point at full width, after a warm-up
    single = tuple(a[:1] for a in frame)
    entries = (
        ("uniform", lambda: p2.recon_wavefront_uniform(*one, *args),
         lambda: p2._frame_inputs(*single, H, W, n, (1, 1))[0], 1),
        ("scan", lambda: p2.recon_wavefront_scan(*one, *args),
         lambda: p2._frame_inputs(*single, H, W, n, (1, 1))[0], 1),
        ("frame (1, 1)", lambda: p2.recon_wavefront_scan_frame(
            *frame, *args, tile_grid=(1, 1)),
         lambda: p2._frame_inputs(*frame, H, W, n, (1, 1))[0], 3),
        ("frame (8, 8)", lambda: p2.recon_wavefront_scan_frame(
            *frame, *args, tile_grid=(8, 8)),
         lambda: p2._frame_inputs(*frame, H, W, n, (8, 8))[0], 3),
    )
    out = {}
    for name, call, prep, planes_n in entries:
        ev_ms, host_ms = _cuda_ms(torch, call, 3, host=True)
        starts, prep_ms = _host_ms(prep)
        S, kmax = len(starts) - 1, int(np.diff(starts).max())
        kernels, copies, dev_ms, ops_ms, launch_ms = _profile(torch, call,
                                                              host=True)
        out[name] = dict(host_ms=host_ms, event_ms=ev_ms, prep_ms=prep_ms,
                         S=S, kmax=kmax, kernels=kernels, copies=copies,
                         device_ms=dev_ms, aten_ms=ops_ms,
                         launch_ms=launch_ms, planes=planes_n)
        print(f"[pass2] {name:<12} {host_ms:.3f} ms host clock, "
              f"{ev_ms:.3f} ms CUDA events per call ({host_ms / planes_n:.3f}"
              f" ms per plane); host preparation {prep_ms:.3f} ms; S {S} "
              f"levels, kmax {kmax}; {kernels} CUDA kernels + {copies} "
              f"copies per call ({kernels / S:.1f} kernels per level), "
              f"device busy {dev_ms:.3f} ms ({100.0 * dev_ms / host_ms:.1f}%"
              f" of the call; {host_ms - prep_ms - dev_ms:.3f} ms of the "
              "call is neither host preparation nor device work); under the "
              f"profiler the host spent {ops_ms:.3f} ms in top-level aten "
              f"ops, {launch_ms:.3f} ms of it inside CUDA launch calls")
    enc = Encoder.new().with_quality(QUALITY).with_speed(SPEED)
    _avif, wall, split = _trace_split(enc, img, False)
    span = split.get("tiles_pass1+2")
    print(f"[pass2] for context, different work: the tiles_pass1+2 span of "
          f"one traced default RGB encode of the {img.shape[0]}x"
          f"{img.shape[1]} photo (host C++ "
          f"pass 1 and pass 2 of three planes with the real partitions and "
          f"entropy coding): {span:.4f} s of {wall:.4f} s")
    out["tiles_pass1+2_s"] = span
    print("[pass2] " + json.dumps(out))
    return out


def phase_dirtyalpha(torch, img):
    """The dirty-alpha cleaner's torch backend on the card against its
    numpy backend on a 1024x1024 RGBA image with a transparent region:
    bit-equal, with times and the kernels of one call."""
    from cavif_tpu_torch.ops.dirtyalpha import blurred_dirty_alpha

    h, w = img.shape[:2]
    xx = np.mgrid[0:h, 0:w][1]
    # transparent left third, a semi-transparent ramp, opaque right third
    alpha = np.clip((xx - w // 3) * 255 // max(w // 3, 1), 0, 255)
    rgba = np.dstack([img, alpha.astype(np.uint8)])
    want, np_ms = _host_ms(lambda: blurred_dirty_alpha(rgba))
    call = lambda: blurred_dirty_alpha(rgba, backend="torch")
    got, card_ms = _host_ms(call)
    if want is None or got is None:
        raise AssertionError("[dirtyalpha] nothing to clean")
    _same("[dirtyalpha] torch on the card against numpy", got, want)
    ev_ms = _cuda_ms(torch, call, 3)
    kernels, copies, dev_ms = _profile(torch, call)
    print(f"[dirtyalpha] {h}x{w} RGBA: torch on the card bit-equal to numpy; "
          f"card {card_ms:.3f} ms host clock, {ev_ms:.3f} ms CUDA events "
          f"(upload and fetch included), {kernels} kernels + {copies} copies "
          f"busy {dev_ms:.3f} ms; numpy {np_ms:.3f} ms")
    return dict(card_ms=card_ms, event_ms=ev_ms, numpy_ms=np_ms,
                kernels=kernels, copies=copies, device_ms=dev_ms)


def _cli_encoder(quality=80.0, speed=4, depth="auto", color="ycbcr",
                 dirty_alpha=False):
    """The library Encoder with the settings the CLI derives from these
    flags (cavif_tpu_torch/cli.py: alpha quality from quality, threads
    unset, tune psnr)."""
    from cavif_tpu_torch import AlphaColorMode, BitDepth, ColorModel, Encoder

    aq = min((quality + 100.0) / 2.0, quality + quality / 4.0 + 2.0)
    return (
        Encoder.new().with_quality(quality)
        .with_bit_depth({"8": BitDepth.Eight, "10": BitDepth.Ten,
                         "auto": BitDepth.Auto}[depth])
        .with_speed(speed).with_alpha_quality(aq)
        .with_internal_color_model(ColorModel.YCbCr if color == "ycbcr"
                                   else ColorModel.RGB)
        .with_alpha_color_mode(AlphaColorMode.UnassociatedDirty
                               if dirty_alpha
                               else AlphaColorMode.UnassociatedClean)
        .with_num_threads(None).with_tune("psnr")
    )


def _check_avif(what, data, w, h, depth, alpha):
    """The AVIF's brand, its parsed header and alpha item, and a Pillow
    decode at (w, h), with alpha where there should be."""
    import io

    from PIL import Image

    from cavif_tpu_torch.container.parse import read_avif

    if data[4:12] != b"ftypavif":
        raise AssertionError(f"{what}: bytes 4-12 are {data[4:12]!r}")
    info = read_avif(data)
    if (info.width, info.height, info.bit_depth) != (w, h, depth):
        raise AssertionError(f"{what}: parsed header {info.width}x"
                             f"{info.height} {info.bit_depth}-bit")
    if (info.alpha_item is not None) != alpha:
        raise AssertionError(f"{what}: alpha item {info.alpha_item is not None}"
                             f", expected {alpha}")
    im = Image.open(io.BytesIO(data))
    im.load()
    if im.size != (w, h) or (("A" in im.mode) != alpha):
        raise AssertionError(f"{what}: Pillow decodes {im.size} {im.mode}")
    return info


def _stream_rgb(enc, x):
    """The RGB that enc's colour stream codes for image x: an RGBA image's
    colour after the alpha mode's preprocessing."""
    if x.shape[2] == 3:
        return x
    conv = enc._convert_alpha_8bit(x)
    return np.ascontiguousarray((x if conv is None else conv)[..., :3])


def _inside(fig, ref) -> bool:
    """(bytes, PSNR) fig inside the envelope of ref: bytes at most 1.05x,
    PSNR at least ref's minus 0.1 dB."""
    return fig[0] <= 1.05 * ref[0] and fig[1] >= ref[1] - 0.1


def _envelope(what, enc, rgb, avif=None, chain_off=False, reference=False):
    """enc's colour stream of rgb, encoded as the pipeline encodes it on
    the card (its frame must be avif's colour item, byte for byte, when
    avif is given; with chain_off the filter chain is off, so the equality
    also shows the chain neutral), against the host cascade (device="off")
    with the same settings: bytes at most 1.05x, PSNR of the decoder-exact
    pre-filter reconstruction at least the host's minus 0.1 dB.

    With reference=True the same stream is also encoded with the pass 1 on
    the CPU in f32 (the reference's decisions: tests/test_torch_configs.py
    holds those bytes equal to the JAX package's), and the card must be
    inside that stream's envelope; where that stream itself lies outside
    the host envelope (the reference's device search on the gbr model,
    ROADMAP.md C), the card is held to it alone. Returns (the card's
    FrameEncoder, the figures)."""
    from cavif_tpu_torch import pipeline
    from cavif_tpu_torch.av1.config import AV1Config
    from cavif_tpu_torch.av1.encoder import FrameEncoder
    from cavif_tpu_torch.av1.speed import SpeedTweaks
    from cavif_tpu_torch.container.parse import read_avif

    h, w = rgb.shape[:2]
    depth = enc.output_depth.bits
    planes = pipeline._convert_planes(enc, rgb, depth)
    cfg = AV1Config(
        width=w, height=h, bit_depth=depth, quantizer=enc.quantizer,
        tweaks=SpeedTweaks.from_preset(enc.speed, enc.quantizer),
        chroma_sampling="444", full_range=True,
        matrix_coefficients=pipeline._matrix_coefficients(enc.color_model),
        threads=enc.threads, tune=enc.tune, device=enc.device)
    ref = [planes[..., p] for p in range(3)]

    def stream(device):
        fe = FrameEncoder(planes, replace(cfg, device=device), src8=rgb)
        # keep the reconstruction where the encode makes no filter search
        # (fast deblock without LR, speeds 7-10): output only
        fe._recon_stack = np.zeros_like(fe._src_stack())
        data = fe.encode()
        return fe, data, _psnr(ref, list(fe._recon_full()), h, w, depth)

    if chain_off:
        os.environ["CAVIF_TPU_DEVICE_FILTERS"] = "0"
    try:
        fe, data, cp = stream(enc.device)
    finally:
        if chain_off:
            del os.environ["CAVIF_TPU_DEVICE_FILTERS"]
    if avif is not None and data != read_avif(avif).primary_item:
        raise AssertionError(f"{what}: the card's colour frame is not the "
                             "AVIF's colour item")
    _, hdata, hp = stream("off")
    card, host = (len(data), cp), (len(hdata), hp)
    fig = dict(card_bytes=card[0], card_psnr=cp, host_bytes=host[0],
               host_psnr=hp)
    print(f"[configs] {what} colour: card {card[0]} B {cp:.4f} dB, host "
          f"{host[0]} B {hp:.4f} dB (limits: bytes <= "
          f"{1.05 * host[0]:.0f}, PSNR >= {hp - 0.1:.4f})")
    ok = _inside(card, host)
    if reference:
        _, rdata, rp = stream("cpu")
        cpu = (len(rdata), rp)
        fig.update(cpu_f32_bytes=cpu[0], cpu_f32_psnr=rp)
        inherited = not _inside(cpu, host)
        print(f"[configs] {what} colour: pass 1 on the CPU in f32 "
              f"{cpu[0]} B {rp:.4f} dB ({'outside' if inherited else 'inside'}"
              f" the host envelope); card inside its envelope: "
              f"{_inside(card, cpu)}")
        ok = _inside(card, cpu) and (ok or inherited)
    if not ok:
        raise AssertionError(f"{what}: outside the envelope")
    return fe, fig


def _decoded_envelope(what, enc, x, avif):
    """A batch AVIF's colour stream against the host cascade's AVIF of the
    same image and settings: colour bytes at most 1.05x and PSNR of the
    Pillow-decoded RGB against the stream's input at least the host's
    minus 0.1 dB."""
    import io

    from PIL import Image

    from cavif_tpu_torch.container.parse import read_avif

    rgb = _stream_rgb(enc, x).astype(np.float64)

    def measure(data):
        d = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        mse = float(((d.astype(np.float64) - rgb) ** 2).mean())
        return (len(read_avif(data).primary_item),
                10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12)))

    host = (replace(enc, device="off").encode_rgba if x.shape[2] == 4
            else replace(enc, device="off").encode_rgb)(x).avif_file
    (cb, cp), (hb, hp) = measure(avif), measure(host)
    print(f"[configs] {what} colour: card {cb} B {cp:.4f} dB decoded, host "
          f"{hb} B {hp:.4f} dB")
    if cb > 1.05 * hb or cp < hp - 0.1:
        raise AssertionError(f"{what}: outside the host envelope")
    return dict(card_bytes=cb, card_psnr=cp, host_bytes=hb, host_psnr=hp)


@contextlib.contextmanager
def _chain_calls(df):
    """df.run_filter_chain counted for the block: yields the list of its
    calls' outcomes (True: the chain ran)."""
    calls = []
    real = df.run_filter_chain

    def counted(fe):
        out = real(fe)
        calls.append(out is not None)
        return out

    df.run_filter_chain = counted
    try:
        yield calls
    finally:
        df.run_filter_chain = real


@contextlib.contextmanager
def _kernel_events(torch, dp):
    """K1's and K2's wrappers, as device_pass1 calls them, bracketed by
    CUDA events for the block: yields {name: [(start, end), ...]}."""
    events = {"dir_cost": [], "nd_cost": []}
    real = {name: getattr(dp, name) for name in events}

    def timed(name):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[name](*args, **kw)
            end.record()
            events[name].append((start, end))
            return out
        return call

    for name in events:
        setattr(dp, name, timed(name))
    try:
        yield events
    finally:
        for name, fn in real.items():
            setattr(dp, name, fn)


def phase_configs(torch, pk, dp, smi, img):
    """BASELINE.json's five configurations through the port on the card:
    (1) the CLI with its defaults on three PNGs at once (its thread pool
    encodes them concurrently), each file byte-equal to an in-process
    encode with the same settings, whose K1/K2 launches are counted;
    (2) --depth=8 at --quality 40, 60, 80, 95; (3) RGBA with and without
    --dirty-alpha; (4) --color=rgb at --speed 1 and 10, with the filter
    chain auto-engaged and byte-neutral and the 64 tier priced at speed 1;
    every CLI call runs in its own process, all started together, and
    each configuration's colour stream is held against the host cascade;
    (5a) the 7680x4320 frame through tools/bench8k.encode, cold then warm
    with the chain on, K1/K2 launched, decoded, inside the envelope and
    equal to a chain-off encode; (5b) the first BATCH_N images of
    tools/batch512_bench through both batch paths; then one pass of
    tools/bench's stage split, roofline and attachment flags."""
    import shutil
    import tempfile

    from PIL import Image

    from cavif_tpu_torch.ops import device_filters as df
    from cavif_tpu_torch.ops.ingest import load_rgba
    from cavif_tpu_torch.tools import batch512_bench, bench, bench8k

    out = {}
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = np.clip((xx + yy) * 255 // (w + h - 2), 0, 255).astype(np.uint8)
    rgba = np.dstack([img, alpha])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_configs_")
    try:
        # every CLI call at once: name -> (flags, images)
        rolled = [np.ascontiguousarray(np.roll(img, 13 * i, axis=1))
                  for i in range(3)]
        jobs = {"defaults": ([], rolled)}
        for q in CONFIG_QUALITIES:
            jobs[f"depth8_q{q}"] = (["--depth=8", "--quality", str(q)], [img])
        jobs["rgba_clean"] = ([], [rgba])
        jobs["rgba_dirty"] = (["--dirty-alpha"], [rgba])
        for s in CONFIG_SPEEDS:
            jobs[f"rgb_s{s}"] = (["--color=rgb", "--speed", str(s)], [img])
        procs = {}
        t0 = time.perf_counter()
        for name, (flags, xs) in jobs.items():
            d = os.path.join(tmp, name)
            os.makedirs(d)
            pngs = []
            for i, x in enumerate(xs):
                p = os.path.join(d, f"image{i}.png")
                Image.fromarray(x).save(p)
                pngs.append(p)
            log = open(os.path.join(d, "cli.log"), "w+")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", "cavif_tpu_torch", *flags, *pngs],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log, pngs)
        files = {}
        try:
            for name, (proc, log, pngs) in procs.items():
                try:
                    rc = proc.wait(timeout=CLI_TIMEOUT)
                except subprocess.TimeoutExpired:
                    raise AssertionError(f"[configs] CLI {name}: timed out")
                log.seek(0)
                text = log.read()
                if rc != 0:
                    raise AssertionError(f"[configs] CLI {name}: exit {rc}\n"
                                         + text[-3000:])
                files[name] = []
                for p in pngs:
                    with open(os.path.splitext(p)[0] + ".avif", "rb") as f:
                        files[name].append(f.read())
                print(f"[configs] CLI {name}: exit 0, "
                      + "; ".join(ln for ln in text.splitlines() if ln))
        finally:
            # a failed or late CLI process stops the others
            for proc, log, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        print(f"[configs] {len(jobs)} CLI processes ({sum(map(len, files.values()))} "
              f"files) in {time.perf_counter() - t0:.2f} s")

        # (1) the defaults: three concurrent card encodes, each equal to
        # an in-process encode of the same PNG, with K1/K2 counted
        enc = _cli_encoder()
        for i, data in enumerate(files["defaults"]):
            _check_avif(f"defaults image {i}", data, w, h, 10, False)
            with open(os.path.join(tmp, "defaults", f"image{i}.png"),
                      "rb") as f:
                x = load_rgba(f.read(), False)
            pk.reset_launches()
            mine = enc.encode_rgba(x).avif_file
            launches = dict(pk.LAUNCHES)
            if mine != data:
                raise AssertionError(f"[configs] defaults image {i}: the CLI "
                                     "file differs from the in-process encode")
            if min(launches.values()) <= 0:
                raise AssertionError(f"[configs] defaults image {i}: launches "
                                     f"{launches}")
            print(f"[configs] (1) defaults image {i}: {len(data)} B, equal to "
                  f"the in-process encode, launches {launches}")
        out["defaults"] = _envelope("(1) defaults", enc, img,
                                    files["defaults"][0])[1]

        # (2) 8 bits over the quality range
        for q in CONFIG_QUALITIES:
            data = files[f"depth8_q{q}"][0]
            _check_avif(f"depth8 Q{q}", data, w, h, 8, False)
            out[f"depth8_q{q}"] = _envelope(
                f"(2) --depth=8 Q{q}", _cli_encoder(quality=float(q),
                                                    depth="8"), img, data)[1]

        # (3) RGBA, alpha cleaned (the default) and kept dirty
        for name, dirty in (("rgba_clean", False), ("rgba_dirty", True)):
            data = files[name][0]
            _check_avif(name, data, w, h, 10, True)
            e = _cli_encoder(dirty_alpha=dirty)
            out[name] = _envelope(f"(3) {name}", e, _stream_rgb(e, rgba),
                                  data)[1]

        # (4) the gbr model at the slowest and fastest speeds: the chain
        # auto-engaged and byte-neutral, the 64 tier priced at speed 1
        for s in CONFIG_SPEEDS:
            data = files[f"rgb_s{s}"][0]
            _check_avif(f"rgb s{s}", data, w, h, 10, False)
            e = _cli_encoder(speed=s, color="rgb")
            fe, out[f"rgb_s{s}"] = _envelope(f"(4) --color=rgb --speed {s}",
                                             e, img, data, reference=True)
            tiers = sorted({shape for shape, _ in fe._dev_state[0]})
            if s == 1 and ((64, 64), "code") not in fe._dev_state[0]:
                raise AssertionError(f"[configs] speed 1: no 64 tier in the "
                                     f"pass-1 grids ({tiers})")
            pk.reset_launches()
            with _chain_calls(df) as calls:
                on, wall_on, split_on = _trace_split(e, img, False)
            launches = dict(pk.LAUNCHES)
            os.environ["CAVIF_TPU_DEVICE_FILTERS"] = "0"
            try:
                off = e.encode_rgb(img).avif_file
            finally:
                del os.environ["CAVIF_TPU_DEVICE_FILTERS"]
            # at speeds 7-10 without LR (fast deblock) the encoder makes
            # no filter search at all, as the reference's does: the chain
            # has nothing to run there
            if fe._want_filters:
                ran = bool(calls) and all(calls) \
                    and "device_filters" in split_on
                chain = "chain ran"
            else:
                ran = not calls and "device_filters" not in split_on
                chain = "no filter search at this speed (fast deblock)"
            if not ran:
                raise AssertionError(f"[configs] speed {s}: filter search "
                                     f"{fe._want_filters}, chain calls "
                                     f"{calls}, spans {sorted(split_on)}")
            if on != off or on != data:
                raise AssertionError(f"[configs] speed {s}: chain on, chain "
                                     "off and the CLI differ")
            print(f"[configs] (4) speed {s}: pass-1 shapes {tiers}; {chain}, "
                  f"{len(on)} B identical with the chain off and to the "
                  f"CLI; {wall_on:.4f} s traced, launches {launches}, stages "
                  + json.dumps({k: round(v, 4) for k, v in sorted(
                      split_on.items(), key=lambda kv: -kv[1])[:6]}))
            if min(launches.values()) <= 0:
                raise AssertionError(f"[configs] speed {s}: launches "
                                     f"{launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (5a) the 8K frame, cold then warm with the chain on
    img8 = bench8k.img8k()
    H8, W8 = img8.shape[:2]
    mp8 = H8 * W8 / 1e6
    enc8 = bench.encoder("cuda")
    cold, cold_s, cold_peak = bench8k.encode(enc8, img8)
    pk.reset_launches()
    with _chain_calls(df) as calls, _kernel_events(torch, dp) as events:
        warm, warm_s, warm_peak = bench8k.encode(enc8, img8)
    launches = dict(pk.LAUNCHES)
    kernel_ms = {name: sum(a.elapsed_time(b) for a, b in ev)
                 for name, ev in events.items()}
    print(f"[configs] (5a) {W8}x{H8}: cold {cold_s:.3f} s, peak "
          f"{cold_peak / 2 ** 30:.2f} GiB; warm {warm_s:.3f} s = "
          f"{mp8 / warm_s:.3f} MP/s, peak {warm_peak / 2 ** 30:.2f} GiB, "
          f"{len(warm)} B, launches {launches}, chain calls {calls}; K1/K2 "
          f"inside the warm encode (CUDA events, summed over the shapes): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in kernel_ms.items()))
    if min(launches.values()) <= 0:
        raise AssertionError(f"[configs] 8K: launches {launches}")
    if not calls or not all(calls):
        raise AssertionError(f"[configs] 8K: the chain did not run ({calls})")
    if cold != warm:
        raise AssertionError("[configs] 8K: cold and warm encodes differ")
    _check_avif("8K", warm, W8, H8, 10, False)
    out["8k"] = dict(cold_s=cold_s, warm_s=warm_s, mp_s=mp8 / warm_s,
                     peak_gib=warm_peak / 2 ** 30, launches=launches,
                     kernel_ms=kernel_ms,
                     **_envelope("(5a) 8K (chain off)", enc8, img8, warm,
                                 chain_off=True)[1])
    print("[configs] (5a) 8K: the chain-off colour frame equals the chain-on "
          "AVIF's")
    del img8, cold, warm

    # (5b) the mixed batch through both paths
    imgs, mp = batch512_bench.make_images(BATCH_N)
    enc = bench.encoder("cuda")
    out["batch"] = {}
    for path in ("hybrid", "sharded"):
        # warm: the first 8 images span the four buckets and an RGBA image
        batch512_bench.run_path(path, imgs[:8], enc)
        pk.reset_launches()
        with _card_frames(dp) as frames:
            avifs, wall = batch512_bench.run_path(path, imgs, enc)
        launches = dict(pk.LAUNCHES)
        for i, (x, data) in enumerate(zip(imgs, avifs)):
            _check_avif(f"batch {path} image {i}", data, x.shape[1],
                        x.shape[0], 10, i % 8 == 3)
        streams = len(imgs) + sum(i % 8 == 3 for i in range(len(imgs)))
        print(f"[configs] (5b) {path}: {len(imgs)} images, {mp:.4f} MP, warm "
              f"{wall:.4f} s = {mp / wall:.4f} MP/s, launches {launches}; "
              f"pass 1 of {sum(frames)} of the {streams} streams (colour "
              f"and alpha) on the card in {len(frames)} calls, the rest on "
              "the host cascade; every AVIF parses and decodes, alpha on "
              "every 8th")
        if min(launches.values()) <= 0:
            raise AssertionError(f"[configs] batch {path}: launches "
                                 f"{launches}")
        out["batch"][path] = dict(wall=wall, mp_s=mp / wall,
                                  launches=launches)
        for i in range(len(batch512_bench.SHAPES)):
            x = imgs[i]
            out["batch"][path][f"image{i}"] = _decoded_envelope(
                f"(5b) {path} image {i} {x.shape[1]}x{x.shape[0]}", enc, x,
                avifs[i])

    # tools/bench: the stage split, the card's roofline, the flags
    img1 = bench.test_image(SIZE, SIZE)
    enc = bench.encoder("cuda")
    enc.encode_rgb(img1)  # dp.LAST_KEY: this frame's program
    stages = bench.stage_breakdown(enc, img1)
    roof = bench.device_roofline(img1, stages.get("device_pass1"), "cuda")
    att = bench.attachment_flags()
    print("[configs] bench " + json.dumps(dict(
        stage_seconds_single=stages, device_pass1_mfu=roof,
        attachment_probe=att)))
    if "error" in roof or smi not in roof["peaks"] \
            or not roof["mfu_exec"] > 0:
        raise AssertionError(f"[configs] bench roofline {roof}")
    if not att["device_filters_engaged"]:
        raise AssertionError("[configs] bench: the chain is not engaged")
    out["bench"] = dict(stages=stages, roofline=roof, attachment=att)
    print("[configs] " + json.dumps(out))
    return out


def phase_tools(torch, pk, sk, smi):
    """The ports of the repository's JAX-driven scripts on the card:
    (a) cavif_tpu_torch.entry: entry()'s program on its example batch
    (K1/K2 launched), the packed shape asserted and bit-equal to
    run_pass1_batch on the same inputs, then dryrun_multichip(1), one
    NCCL rank as a (1, 1) mesh, equal to it; (b) tools/card_probe and
    card_probe2 at PROBE_SIZE, every line printed, K3 launched (nothing is
    caught: a failure fails the run); (c) tools/bdrate's dense sweep of
    the BD_IMAGES on the card and on the host cascade (device "off"), and
    libaom speed 6: BD figures of the card against libaom and against the
    host, the card held to BD-PSNR >= BD_PSNR_MIN dB and BD-rate <=
    BD_RATE_MAX % of the host on each image (every AVIF decoded by
    Pillow); (d) tools/scale_bench at SCALE_ARGS (world 1 and 2 on gloo,
    sharing the card), its JSON line."""
    import contextlib
    import io

    from cavif_tpu_torch import entry as ent
    from cavif_tpu_torch.ops import device_pass1 as dp
    from cavif_tpu_torch.tools import (ab_quality, bdrate, card_probe,
                                       card_probe2, scale_bench)

    out = {}
    t0 = time.perf_counter()
    fn, args = ent.entry("cuda")
    pk.reset_launches()
    with torch.inference_mode():
        packed = fn(*args).cpu().numpy()
    launches = dict(pk.LAUNCHES)
    total = ent.width()
    if packed.shape != (2, total) or min(launches.values()) <= 0:
        raise AssertionError(f"[tools] entry: packed {packed.shape} (want "
                             f"{(2, total)}), launches {launches}")
    batch = ent.pack(dp.run_pass1_batch(ent.batch(2), device="cuda",
                                        **ent.KW))
    if not np.array_equal(packed, batch):
        raise AssertionError("[tools] entry() differs from run_pass1_batch "
                             f"on {int((packed != batch).sum())} entries")
    from cavif_tpu_torch.parallel import ranks

    backend = ranks.backend_for("cuda", 1)
    dry = ent.dryrun_multichip(1)
    if dry.shape != (2, total) or not np.array_equal(dry, packed):
        raise AssertionError(f"[tools] dryrun_multichip(1): {dry.shape}, "
                             "not entry()'s packed output")
    print(f"[tools] entry(): packed {packed.shape} int8, K1/K2 launches "
          f"{launches}, bit-equal to run_pass1_batch; dryrun_multichip(1) "
          f"({backend}, (1, 1) mesh, b = 2): shape asserted, bit-equal to "
          f"entry(); {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sk.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        probes = {"card_probe": card_probe.run("cuda", PROBE_SIZE),
                  "card_probe2": card_probe2.run("cuda", PROBE_SIZE)}
    k3 = sk.LAUNCHES["mode_cost"]
    for line in buf.getvalue().splitlines():
        print(f"[tools] probe {line}")
    print(f"[tools] probes: K3 launched {k3} times; "
          f"{time.perf_counter() - t0:.1f} s; {smi}")
    if k3 <= 0:
        raise AssertionError("[tools] the probes launched no K3")
    out["probes"] = probes

    t0 = time.perf_counter()
    imgs = [(n, x) for n, x in ab_quality.images() if n in BD_IMAGES]
    pk.reset_launches()
    card = bdrate.sweep(imgs, "cuda")
    launches = dict(pk.LAUNCHES)
    host = bdrate.sweep(imgs, "off")
    aom = bdrate.aom_sweep(imgs)
    if min(launches.values()) <= 0:
        raise AssertionError(f"[tools] bdrate: card launches {launches}")
    for name, pts in card.items():
        print(f"[tools] bdrate {name} card (bytes, PSNR, SSIM) at Q"
              f"{bdrate.QUALITIES[0]}-{bdrate.QUALITIES[-1]}: "
              + json.dumps(pts))
        print(f"[tools] bdrate {name} host: " + json.dumps(host[name]))
        print(f"[tools] bdrate {name} libaom s{bdrate.AOM_SPEED} at Q"
              f"{bdrate.AOM_QUALITIES[0]}-{bdrate.AOM_QUALITIES[-1]}: "
              + json.dumps(aom[name]))
    bd = {}
    for what, anchor, ours in (("card vs libaom", aom, card),
                               ("host vs libaom", aom, host),
                               ("card vs host", host, card)):
        print(f"[tools] bdrate {what}:")
        with contextlib.redirect_stdout(buf := io.StringIO()):
            bd[what] = bdrate.report(anchor, ours, what.split(" vs ")[1])
        for line in buf.getvalue().splitlines():
            print(f"[tools] bdrate   {line}")
    print(f"[tools] bdrate sweeps of {[n for n, _ in imgs]}: "
          f"{time.perf_counter() - t0:.1f} s, card K1/K2 launches "
          f"{launches}; every AVIF decoded by Pillow; {smi}")
    for name in card:
        bdp, _, bdr = bd["card vs host"][name]
        if bdp is None or bdr is None or bdp < BD_PSNR_MIN \
                or bdr > BD_RATE_MAX:
            raise AssertionError(
                f"[tools] bdrate {name}: card vs host BD-PSNR {bdp} dB, "
                f"BD-rate {bdr} % (limits >= {BD_PSNR_MIN} dB, <= "
                f"{BD_RATE_MAX} %)")
    print(f"[tools] bdrate: the card within BD-PSNR >= {BD_PSNR_MIN} dB and "
          f"BD-rate <= +{BD_RATE_MAX}% of the host cascade on every image")
    out["bdrate"] = dict(card=card, host=host, aom=aom, bd=bd)

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf := io.StringIO()):
        scale_bench.main(list(SCALE_ARGS))
    res = json.loads(buf.getvalue().splitlines()[-1])
    print(f"[tools] scale_bench {' '.join(SCALE_ARGS)}: " + json.dumps(res)
          + f"; {time.perf_counter() - t0:.1f} s; {smi}")
    out["scale_bench"] = res
    return out


def _pytest(what, args, env=None):
    """pytest over `args` in a subprocess from the repository root, the
    JAX package's checks deselected; its output goes to
    chiprun_out/suite_<what>.txt. Returns (exit code, stdout)."""
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider", "-m",
         testing.CARD_SELECT, *args], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=SUITE_TIMEOUT)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"suite_{what}.txt"), "w") as f:
        f.write(r.stdout + r.stderr)
    return r.returncode, r.stdout


def phase_suite():
    """The card run's test files (cavif_tpu_torch/tools/run_device_tests.sh)
    collected here, where there is no JAX, under -m "not jax_reference";
    then SUITE_RUN's tests on the card (CAVIF_TORCH_TEST_DEVICE=cuda),
    with the reason of every skip. A collection error, a failure or an
    error fails the run."""
    t0 = time.perf_counter()
    files = testing.card_suite_files()
    rc, out = _pytest("collect", ["--collect-only", "-q", *files])
    m = re.search(r"^(\d+)(?:/\d+)? tests? collected", out, re.M)
    if rc != 0 or m is None or re.search(r"\d+ errors?\b", out):
        raise AssertionError(f"[suite] collecting {len(files)} files: exit "
                             f"code {rc}: " + out[-2000:])
    collected = int(m.group(1))
    rc, out = _pytest("run", ["-q", "-rs", *SUITE_RUN],
                      env={**os.environ, testing.ENV: "cuda"})
    for line in out.splitlines():
        if line.startswith("SKIPPED"):
            print(f"[suite] {line}")
    tail = out.strip().splitlines()[-1] if out.strip() else ""
    counts = {k.rstrip("s"): int(v) for v, k in re.findall(
        r"(\d+) (passed|failed|skipped|errors?|xfailed|xpassed)", tail)}
    ran = sum(counts.values())
    if rc != 0 or counts.get("failed") or counts.get("error") \
            or not counts.get("passed"):
        raise AssertionError(f"[suite] {' '.join(SUITE_RUN)}: exit code "
                             f"{rc}: " + out[-3000:])
    print(f"[suite] {collected} collected, {ran} run, "
          f"{counts.get('passed', 0)} passed in "
          f"{time.perf_counter() - t0:.1f} s ({tail})")


def _timed(name, fn, *args):
    """fn(*args), with the phase's seconds printed."""
    t0 = time.perf_counter()
    res = fn(*args)
    print(f"[time] {name} {time.perf_counter() - t0:.1f} s", flush=True)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    from cavif_tpu_torch.ops import block_search as bs
    from cavif_tpu_torch.ops import cuda_build as cb
    from cavif_tpu_torch.ops import device_pass1 as dp
    from cavif_tpu_torch.ops import pass1_kernels as pk
    from cavif_tpu_torch.ops import proto_kernels as prk
    from cavif_tpu_torch.ops import search_kernels as sk
    from cavif_tpu_torch.tools import dir_ablation, dir_proto

    t_start = time.perf_counter()
    dp.resolve_device("cuda")  # also pins TF32 off
    smi, sms, clock_hz = phase_card(torch)
    kind = torch.cuda.get_device_name(0)
    peaks = _peaks(kind, sms, clock_hz)
    _timed("build", phase_build, cb)

    img = _test_image(SIZE, SIZE)
    cfg, geo = _frame_geometry()
    t0 = time.perf_counter()
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
    print(f"[time] kernels, k3, proto {time.perf_counter() - t0:.1f} s")
    _timed("small", phase_small_reference, dp, geo, img)
    launches = _timed("encode", phase_encode, torch, pk, img)
    _timed("quality", phase_quality, img)
    deblock = _timed("filters", phase_filters, torch, img, peaks)
    launches["mode_cost"], search, search_wall = _timed(
        "search", phase_block_search, torch, sk, bs, geo, img)
    batch = _timed("batch", phase_batch, torch, pk, dp, img)
    _timed("mesh", phase_mesh, torch, smi, img, geo, batch, search,
           search_wall)
    _timed("pass2", phase_pass2, torch, img)
    _timed("dirtyalpha", phase_dirtyalpha, torch, img)
    _timed("configs", phase_configs, torch, pk, dp, smi, img)
    _timed("tools", phase_tools, torch, pk, sk, smi)
    _timed("suite", phase_suite)
    print(f"[time] total {time.perf_counter() - t_start:.1f} s")
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
    kernels.append(deblock)
    print("[kernels] times are per 1024x1024 frame, summed over the ten "
          "block shapes (K1, K2; launches per RGB encode) or the tiers 8, 16 "
          "and 32 (K3; launches per plane_partition_search); K4 and K5 "
          "per harness frame, summed over the tiers 4-32 (launches: one "
          "counted harness call per tier); deblock per pass kind and "
          "shape, summed over planes and axes (launches per chain call "
          "of the RGB encode)")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        backend, shape, out_dir = json.loads(sys.argv[2])
        opt = dict(zip(sys.argv[3::2], map(int, sys.argv[4::2])))
        sys.exit(mesh_worker(opt["--rank"], opt["--world"], opt["--port"],
                             backend, tuple(shape), out_dir))
    sys.exit(main())
