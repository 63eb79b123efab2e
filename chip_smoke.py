#!/usr/bin/env python3
"""Card-side check of the PyTorch/CUDA port (cavif_tpu_torch) on one GPU.

    python3 chip_smoke.py     # needs one CUDA card

Phases, each of which fails the run (exit code != 0) when it fails:

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: nvcc compiles both pass-1 kernels from cavif_tpu_torch/csrc/;
3. kernels: for each of the ten block shapes that the 1024x1024 Q80 speed-4
   encode prices, the real ShapeCost inputs of the test image go through
   each kernel and its plain PyTorch version (both with bf16 matmul
   inputs): the argmin over candidates must differ on fewer than 1e-3 of the
   rows. Times (CUDA events) of the kernel, the plain version and one
   torch.matmul of the bf16 product alone, beside the least time the card
   could take for the same work;
4. the main path at full size: Encoder.new().with_quality(80).with_speed(4)
   on the 1024x1024 RGB test image, and on an RGBA variant, with every
   kernel's launch count set to 0 just before and read just after; the AVIF
   is parsed; the colour stream is held against the port's host C++ cascade
   (device="off"): bytes at most 1.05x and PSNR of the decoder-exact
   pre-filter reconstruction (FrameEncoder._recon_full) at least the
   host's minus 0.1 dB; the whole
   device pass 1 on a 256x256 input agrees with the CPU plain path;
5. one JSON line listing the kernels, the card line, and last the JSON
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
REPLACES = {
    "dir_cost": "cavif_tpu/ops/device_pass1.py:594",  # _fused_dir_cost
    "nd_cost": "cavif_tpu/ops/device_pass1.py:475",   # _fused_nd_cost
}
SOURCES = {
    "dir_cost": "cavif_tpu_torch/csrc/pass1_dir_cost.cu",
    "nd_cost": "cavif_tpu_torch/csrc/pass1_nd_cost.cu",
}


def _test_image(h: int, w: int) -> np.ndarray:
    """Photo-like synthetic content: smooth shading + texture + edges
    (the repository benchmark's generator)."""
    rng = np.random.default_rng(42)
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


def _peaks(name: str):
    """(bytes/s, bf16 FLOP/s) of the card from its data sheet, dense."""
    if "PCIe" in name:
        return 2.0e12, 756e12
    if "NVL" in name:
        return 3.9e12, 835e12
    if "H200" in name:
        return 4.8e12, 989e12
    return 3.35e12, 989e12  # H100 SXM


def _cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"devices {torch.cuda.device_count()}")
    return smi


def phase_build(pk):
    t0 = time.perf_counter()
    done = pk.build()
    secs = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.txt"), "w") as f:
        for name, (_, log) in done.items():
            f.write(f"== {name}\n{log}\n")
    for name, (_, log) in done.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: " + " | ".join(regs[-2:]))
    print(f"[build] both kernels built in {secs:.2f} s")
    # load both libraries now, so the first timed launch pays no dlopen
    for name in done:
        pk._lib(name)


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


def phase_kernels(torch, pk, dp, geo, planes, use_deltas, peaks):
    bw_rate, fl_rate = peaks
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
                kern=lambda: pk.dir_cost(**dr),
                plain=lambda: pk.dir_cost_ref(**dr),
                lib=lambda: torch.matmul(ext16, dr["mk"]),
                flops=2.0 * R * E * cdir * n2,
                bytes=4.0 * R * (E + n2 + cdir) + 2.0 * E * cdir * n2
                + 16.0 * n2,
            ),
            "nd_cost": dict(
                kern=lambda: pk.nd_cost(**nd),
                plain=lambda: pk.nd_cost_ref(**nd),
                lib=lambda: torch.matmul(res16, nd["kt"]),
                flops=5 * 2.0 * R * n2 * n2,
                bytes=4.0 * R * (bw + bh + 2 + n2 + 5) + 2.0 * n2 * n2
                + 20.0 * n2,
            ),
        }
        for name, w in work.items():
            got = w["kern"]()
            ref = w["plain"]()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} {bw}x{bh}: non-finite costs")
            mism = float((got.argmin(1) != ref.argmin(1)).float().mean())
            diff = (got - ref).abs()
            max_abs = float(diff.max())
            rel = float((diff / ref.abs().clamp_min(1.0)).max())
            reps_k = 20
            reps_p = 5
            ms = _cuda_ms(torch, w["kern"], reps_k)
            plain_ms = _cuda_ms(torch, w["plain"], reps_p)
            lib_ms = _cuda_ms(torch, w["lib"], reps_k)
            t_bytes = w["bytes"] / bw_rate * 1e3
            t_ops = w["flops"] / fl_rate * 1e3
            row = dict(
                name=name, shape=f"{bw}x{bh}", rows=R, argmin_mismatch=mism,
                max_abs_err=max_abs, max_rel_err=rel, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations",
            )
            rows.append(row)
            print("[kernels] %-8s %-5s R=%-7d argmin %.2e  max|d| %.4g "
                  "rel %.3g  kernel %.4f ms  plain %.4f ms  matmul %.4f ms"
                  "  bound %.4f ms (%s)" % (
                      name, row["shape"], R, mism, max_abs, rel, ms,
                      plain_ms, lib_ms, row["bound_ms"], row["bound_by"]))
            if mism >= ARGMIN_TOL:
                raise AssertionError(
                    f"{name} {bw}x{bh}: argmin differs on {mism:.2e} of "
                    f"rows (limit {ARGMIN_TOL})")
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
    from cavif_tpu_torch.ops import device_pass1 as dp
    from cavif_tpu_torch.ops import pass1_kernels as pk
    from cavif_tpu_torch.ops.quality import quality_to_quantizer

    dp.resolve_device("cuda")  # also pins TF32 off
    smi = phase_card(torch)
    kind = torch.cuda.get_device_name(0)
    peaks = _peaks(kind)
    phase_build(pk)

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
    del planes
    phase_small_reference(dp, geo, img)
    launches = phase_encode(torch, pk, img)
    phase_quality(img)

    kernels = []
    for name in ("dir_cost", "nd_cost"):
        mine = [r for r in rows if r["name"] == name]
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
    print("[kernels] times are per frame, summed over the ten block shapes")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
