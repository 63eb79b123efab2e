"""Batch (data-parallel) encoding: many images at once (PyTorch/CUDA port of
cavif_tpu/parallel/batch.py).

The reference gets file-level parallelism from rayon's global pool
(cavif src/main.rs:223: files.into_par_iter()) with per-file
failure isolation. Here:

- encode_batch(): thread-pool fan-out over images. The encode pipeline
  releases the GIL in its native stages (tile serialization, block
  pipeline), so threads scale like the reference's rayon pool; failures are
  isolated per image and returned, not raised — the caller decides (the CLI
  prints them all and exits 1, like the reference).
- encode_batch_sharded(): the whole batch's device pass 1 as batched
  programs (ops/device_pass1.run_pass1_batch: one launch of each pass-1
  kernel per block shape and sub-batch) feeding per-image host encodes.
- plane_mode_search_batch(): the device-side mode search for same-shaped
  batches (ops/block_search.py, kernel K3 on the card).

The device is the card ("cuda") unless the encoder or the caller names
"cpu"; nothing swaps the card for the CPU. The last two take a mesh (a
torch.distributed DeviceMesh over "data" = images and "tile" = block rows,
parallel/mesh.py): every rank passes the whole batch, computes its share
and gets every result back.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclass
class BatchResult:
    """Per-image outcome: exactly one of `encoded` / `error` is set."""

    index: int
    encoded: Optional[object] = None  # EncodedImage
    error: Optional[BaseException] = None


def _encode_one(enc, img: np.ndarray):
    """Top-level (picklable) per-image encode used by the process pool."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 4:
        return enc.encode_rgba(img)
    return enc.encode_rgb(img)


def encode_batch(
    images: Sequence[np.ndarray],
    encoder=None,
    max_workers: Optional[int] = None,
    processes: Optional[bool] = None,
) -> List[BatchResult]:
    """Encode a batch of (H, W, 3|4) uint8 images in parallel.

    Mirrors the reference's rayon fan-out semantics: every image is
    attempted, failures are collected per image (BatchResult.error), and
    results come back in input order.

    `processes` picks the fan-out: True forks a process pool (GIL-free —
    the encode pipeline's pass-2 serialization walk is Python, so thread
    fan-out alone caps at ~1 core of Python work), False uses threads, and
    None (default) auto-selects processes when the batch is big enough to
    amortize the fork and the platform supports it."""
    from .. import Encoder

    enc = encoder if encoder is not None else Encoder.new()
    workers = max_workers or (os.cpu_count() or 1)
    if enc.threads is None and len(images) > 1:
        # file-level parallelism replaces tile-level: one tile pipeline per
        # image avoids oversubscription (mirrors rayon's shared global pool)
        enc = enc.with_num_threads(1)

    def job(i: int) -> BatchResult:
        try:
            return BatchResult(index=i, encoded=_encode_one(enc, images[i]))
        except BaseException as e:  # per-image isolation
            return BatchResult(index=i, error=e)

    card = enc.device == "cuda" or (enc.device is None and _device_engaged())
    if card:
        # The filter chain's gate reads the attachment probe, measured once
        # per process. Taken here, before any worker starts, it times the
        # card alone: first timed inside a list, behind the workers'
        # uploads and the interpreter lock, it could read above the gate's
        # threshold and turn the chain off for the rest of the process.
        from ..ops import attachment

        attachment.probe()
    if len(images) <= 1:
        return [job(i) for i in range(len(images))]
    if processes is None:
        # device pass-1 pipelines best from threads (one CUDA context, the
        # card overlaps the per-image uploads); a forked child cannot use
        # the parent's CUDA context
        processes = len(images) >= 3 and _fork_ok() and not card
    elif processes and card:
        raise ValueError(
            "encode_batch(processes=True): forked workers cannot use CUDA; "
            "pass an encoder with device=\"off\" (the host cascade) or "
            "\"cpu\"")
    if processes and _fork_ok():
        return _encode_batch_procs(enc, images, min(workers, len(images)))
    if (
        len(images) >= 3
        and enc.device is None
        and _device_engaged()
    ):
        return _encode_batch_hybrid(enc, images, min(workers, len(images)))
    with ThreadPoolExecutor(max_workers=min(workers, len(images))) as ex:
        return list(ex.map(job, range(len(images))))


def _encode_batch_hybrid(enc, images, workers: int) -> List[BatchResult]:
    """Heterogeneous fan-out: the card and the host cores encode DIFFERENT
    images concurrently. The device pass-1 round trips serialize on the
    card, so a handful of in-flight device calls saturate it; every
    additional worker would just queue on it while host cores idle.
    Workers race to acquire one of
    CAVIF_TPU_DEVICE_SLOTS device slots and fall back to the host cascade
    (`device="off"`) when none is free — total throughput approaches
    device MP/s + host MP/s instead of max(one of them).

    A slot bounds IN-FLIGHT DEVICE CALLS, not whole encodes: every
    run_pass1 round trip brackets itself with slot acquire/release via
    the per-call PASS1_HOOKS contextvar, so the encode's host phase
    (pass-2 + EC + filters) never blocks the next image's upload (pass 2
    of image N overlaps pass 1 of image N+1), and an RGBA encode's color
    AND alpha
    device calls both count against the bound (the stream threads
    inherit the hooks through pipeline._encode_streams' context copy).
    The hooks and semaphore are local to this call: two concurrent
    encode_batch calls in one process cannot cross-release each other's
    slots. Both paths produce valid AVIFs inside the same envelope."""
    import threading
    from dataclasses import replace

    from ..ops import device_pass1

    # default 8 (the reference's): a slot bounds only the in-flight
    # device call, not the whole encode; not yet tuned for the card
    slots = int(os.environ.get("CAVIF_TPU_DEVICE_SLOTS", "8"))
    sem = threading.Semaphore(slots)
    host_enc = replace(enc, device="off")

    class _SlotHooks:
        # run_pass1 calls start() before the upload and done() in its
        # finally, so acquire/release always pair
        def start(self):
            sem.acquire()

        def done(self):
            sem.release()

    hooks = _SlotHooks()

    def job(i: int) -> BatchResult:
        # path choice: peek at slot availability (acquire+release, no
        # hold) — the actual in-flight bound is enforced per round trip
        # by the hooks, so a slot is never held across host-phase work
        dev = sem.acquire(blocking=False)
        if dev:
            sem.release()
        tok = device_pass1.PASS1_HOOKS.set(hooks if dev else None)
        try:
            e = enc if dev else host_enc
            return BatchResult(index=i, encoded=_encode_one(e, images[i]))
        except BaseException as exc:  # per-image isolation
            return BatchResult(index=i, error=exc)
        finally:
            device_pass1.PASS1_HOOKS.reset(tok)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(job, range(len(images))))


def _device_engaged() -> bool:
    """Whether the default encode runs its pass 1 on a device:
    CAVIF_TPU_DEVICE_SEARCH when set, else True (the card is the
    default). It never probes for a card to choose the host quietly."""
    dev = os.environ.get("CAVIF_TPU_DEVICE_SEARCH")
    if dev is not None:
        return dev not in ("", "0", "off", "none", "host")
    return True


def _child_disable_device() -> None:
    """Forked pool workers must not touch CUDA: the parent's CUDA context
    does not survive fork, and N workers would contend for the one card.
    An encoder that leaves the device unset encodes on the host path.
    Each child also runs torch on one thread: the OpenMP thread team of a
    parent that has run a parallel torch op does not survive fork, and a
    child entering a parallel region would wait on it forever."""
    os.environ["CAVIF_TPU_DEVICE_SEARCH"] = "0"
    torch.set_num_threads(1)


def _fork_ok() -> bool:
    import multiprocessing

    return "fork" in multiprocessing.get_all_start_methods()


def _encode_batch_procs(enc, images, workers: int) -> List[BatchResult]:
    """Fork-based fan-out: one image per task, results reassembled by
    index. Forked children inherit the loaded native library and cached
    tables for free; per-task pickling moves only the input image (~MBs)
    and the output bytes. The encoder names no card (encode_batch
    refuses that): a child never touches CUDA."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("fork")
    out: List[Optional[BatchResult]] = [None] * len(images)
    with ProcessPoolExecutor(
        max_workers=workers, mp_context=ctx, initializer=_child_disable_device
    ) as ex:
        futs = {
            ex.submit(_encode_one, enc, np.asarray(images[i])): i
            for i in range(len(images))
        }
        for f in futs:
            i = futs[f]
            try:
                out[i] = BatchResult(index=i, encoded=f.result())
            except BaseException as e:  # per-image isolation
                out[i] = BatchResult(index=i, error=e)
    return out


def encode_batch_sharded(
    images: Sequence[np.ndarray],
    encoder=None,
    mesh=None,
    max_workers: Optional[int] = None,
) -> List[bytes]:
    """Whole-batch encode with batched device pass-1 programs feeding
    per-image host serialization.

    Accepts MIXED-shape (H, W, 3|4) uint8 images (the reference's
    par_iter semantics over arbitrary files, src/main.rs:223): streams are
    bucketed by padded 256px shape + tile split, each bucket's pass-1 runs
    as batched device programs (run_pass1_batch), and RGBA inputs get the
    full reference alpha treatment (alpha-mode preprocessing, opaque
    auto-drop, separate Cs400 full-range alpha stream at the alpha
    quantizer/tweaks) with the alpha planes batched through the mono
    device program. Host threads then run pass 2 + EC + mux per image.
    Returns AVIF bytes per image, input order.

    The device is the encoder's (`Encoder.device`; None is the card,
    "cuda"; "cpu" runs the same programs on the CPU).

    With a mesh (a DeviceMesh over "data" and/or "tile", parallel/mesh.py)
    every rank of it calls this with the same images: each chunk's pass 1
    is sharded over the mesh (run_pass1_batch(mesh=)), chunk sizes are
    multiples of the data axis, chunks run in one fixed serial order so
    that every rank issues the same collectives, host stealing is off,
    and every rank holds every grid, serializes every image and returns
    the same list of bytes.

    Determinism: meshless runs default to HOST-CORE STEALING: idle workers
    take whole images onto the host cascade while device chunks stream,
    which is timing-dependent — stolen images carry host-path decisions,
    so bytes may differ run-to-run. Set CAVIF_TPU_SHARDED_STEAL=0 for
    reproducible output.
    """
    from .. import Encoder
    from ..av1.config import AV1Config
    from ..av1.encoder import FrameEncoder, frame_geometry
    from ..av1.speed import SpeedTweaks
    from ..ops import attachment, colorspace
    from ..ops.device_pass1 import run_pass1_batch
    from ..pipeline import _finish, _matrix_coefficients, prepare_alpha
    from ..utils import trace
    from .mesh import axes

    data_n = 1 if mesh is None else axes(mesh).data
    enc = encoder if encoder is not None else Encoder.new()
    if not len(images):
        return []
    depth = enc.output_depth.bits
    device = "cuda" if enc.device is None else enc.device
    if device.startswith("cuda"):
        attachment.probe()  # before any worker, as encode_batch takes it

    # per-image prep: reference alpha semantics (preprocess + opaque drop)
    prepped = []  # (rgb uint8, alpha uint8 | None)
    for im in images:
        im = np.asarray(im)
        alpha = None
        if im.ndim == 3 and im.shape[2] == 4:
            with trace.span("alpha.prep"):
                im, alpha = prepare_alpha(enc, im)
        prepped.append((np.ascontiguousarray(im[..., :3]), alpha))

    def mk_cfg(h, w, kind):
        q = enc.quantizer if kind == "color" else enc.alpha_quantizer
        return AV1Config(
            width=w, height=h, bit_depth=depth, quantizer=q,
            tweaks=SpeedTweaks.from_preset(enc.speed, q),
            chroma_sampling="444" if kind == "color" else "400",
            full_range=True,
            matrix_coefficients=(
                _matrix_coefficients(enc.color_model)
                if kind == "color" else None
            ),
            threads=1, tune=enc.tune, device=device,
        )

    # bucket streams: (kind, bucketed padded dims, tile split, leaf bounds)
    cfgs = {}   # (h, w, kind) -> (cfg, geometry)
    buckets = {}  # key -> [(img_idx, kind)]
    for i, (rgb, alpha) in enumerate(prepped):
        h, w = rgb.shape[:2]
        for kind in ("color",) + (("alpha",) if alpha is not None else ()):
            if (h, w, kind) not in cfgs:
                cfg = mk_cfg(h, w, kind)
                cfgs[(h, w, kind)] = (cfg, frame_geometry(cfg))
            _, g = cfgs[(h, w, kind)]
            # 256px shape bucketing (same as the per-image device path);
            # grids beyond the frame's mi bounds are never read
            bh_ = -(-g.ph // 256) * 256
            bw_ = -(-g.pw // 256) * 256
            key = (kind, bh_, bw_, g.th, g.tw,
                   g.min_leaf_mi, g.max_leaf_mi)
            buckets.setdefault(key, []).append(i)

    # batched device pass-1 per bucket, streamed in sub-batches: host
    # pass-2 of a stream starts as soon as ITS chunk's grids land (not
    # when the whole bucket finishes), and the device fan-out runs on a
    # dedicated feeder thread so the first chunk's host work overlaps the
    # second chunk's device call from the start
    grids_by = {}  # (img_idx, kind) -> per-image grid dict

    def pass1_bucket(key, members, emit):
        kind, bh_, bw_, th, tw, min_leaf, max_leaf = key
        h0, w0 = prepped[members[0]][0].shape[:2]
        cfg, g = cfgs[(h0, w0, kind)]
        # chunk to the sub-batch size run_pass1_batch would use (its
        # pixel budget, a multiple of the data axis); chunks run 2-deep
        # through a tiny pool so the next chunk's upload hides behind the
        # current chunk's compute
        budget = int(os.environ.get("CAVIF_TPU_BATCH_PX", 4_200_000))
        max_b = max(1, budget // (bh_ * bw_))
        max_b = max(data_n, max_b // data_n * data_n)
        pos = [0]  # next unconsidered member index (lock-guarded)

        def next_chunk():
            # form chunks DYNAMICALLY so images the host stealers took
            # while earlier chunks ran drop out of the device stream
            with lock:
                chunk = []
                while pos[0] < len(members) and len(chunk) < max_b:
                    i = members[pos[0]]
                    pos[0] += 1
                    if i not in stolen:
                        claimed.add(i)
                        chunk.append(i)
                return chunk

        def one_chunk(chunk):
            srcs = []
            for i in chunk:
                rgb, alpha = prepped[i]
                h, w = rgb.shape[:2]
                src = rgb if kind == "color" else alpha
                pad = ((0, bh_ - h), (0, bw_ - w))
                if src.ndim == 3:
                    pad = pad + ((0, 0),)
                srcs.append(np.pad(src, pad, mode="edge"))
            batch = np.stack(srcs)
            grids = run_pass1_batch(
                batch, depth=depth, tile_px=(th, tw),
                min_px=min_leaf * 4, max_px=max_leaf * 4,
                use_deltas=cfg.tweaks.fine_directional_intra,
                dc_q=g.dc_q, ac_q=g.ac_q, lam=g.lam,
                ovh_block=FrameEncoder.DEV_OVH_BLOCK,
                model="ycbcr" if kind == "color" else "mono",
                mesh=mesh, device=device,
            )
            # chunk keys are disjoint, but two dev_ex threads write
            # grids_by concurrently — take the same lock emit's
            # bookkeeping uses rather than lean on the GIL
            with lock:
                for i, gr in zip(chunk, grids):
                    grids_by[(i, kind)] = gr
            emit(chunk)

        if mesh is not None:
            # every rank issues the same collectives in the same order
            while chunk := next_chunk():
                one_chunk(chunk)
            return
        # the first chunk runs alone, so the bucket's constant tables and
        # kernel libraries are built once before two threads ask for them
        chunk = next_chunk()
        if not chunk:
            return
        one_chunk(chunk)

        def drain(_):
            while True:
                c = next_chunk()
                if not c:
                    return
                one_chunk(c)

        with ThreadPoolExecutor(max_workers=2) as dev_ex:
            list(dev_ex.map(drain, range(2)))

    def encode_stream(i: int, kind: str) -> bytes:
        rgb, alpha = prepped[i]
        h, w = rgb.shape[:2]
        cfg, _g = cfgs[(h, w, kind)]
        if kind == "color":
            planes = colorspace.rgb_to_ycbcr_host(rgb, depth=depth)
            src8 = rgb
        else:
            planes = colorspace.alpha_plane_host(alpha, depth=depth)
            src8 = alpha
        # the frame keeps its device (cfg.device: the card or "cpu"), so
        # the filter chain's gate sees where pass 1 ran; the injected
        # grids stand in for the frame's own pass-1 call
        fe = FrameEncoder(planes, cfg, src8=src8)
        gr = grids_by[(i, kind)]
        fe._dev_state = (gr, fe._dev_part_dict(gr))
        return fe.encode()

    def one(i: int) -> bytes:
        rgb, alpha = prepped[i]
        h, w = rgb.shape[:2]
        color = encode_stream(i, "color")
        alpha_payload = None
        if alpha is not None:
            with trace.span("alpha.stream"):
                alpha_payload = encode_stream(i, "alpha")
        return _finish(enc, color, alpha_payload, w, h, depth).avif_file

    # an image is host-ready once EVERY stream it needs has grids; order
    # buckets so color buckets go first (alpha streams are the smaller
    # tail) and submit each image the moment its CHUNK's grids land —
    # host pass-2 (pool threads) overlaps every later device chunk, and
    # within a bucket the chunks themselves run 2-deep (pass1_bucket).
    #
    # Host-core stealing: while device chunks stream, idle host workers
    # take WHOLE images from the far end of the batch and encode them on
    # the host cascade — instead of waiting for their grids. Stolen
    # images drop out of later chunks (next_chunk checks), and a
    # device-sized tail is never stolen (the card finishes it faster).
    # Stealing is off under a mesh, so that its chunks are reproducible.
    import threading
    from dataclasses import replace

    workers = min(len(prepped), max_workers or (os.cpu_count() or 1))
    need = {
        i: 1 + (1 if prepped[i][1] is not None else 0)
        for i in range(len(prepped))
    }
    futs = {}
    results = {}
    lock = threading.Lock()
    claimed = set()
    stolen = set()
    steal_on = (
        mesh is None
        and os.environ.get("CAVIF_TPU_SHARDED_STEAL", "1") != "0"
        and len(prepped) > 4 * workers
    )
    host_enc = replace(enc, device="off").with_num_threads(1)
    steal_tail = 2 * workers

    with ThreadPoolExecutor(max_workers=workers) as ex:
        def emit(chunk):
            with lock:
                for i in chunk:
                    need[i] -= 1
                    if need[i] == 0:
                        futs[i] = ex.submit(one, i)

        def steal_pick():
            with lock:
                free = [i for i in range(len(prepped))
                        if i not in claimed and i not in stolen]
                if len(free) <= steal_tail:
                    return None
                i = free[-1]
                stolen.add(i)
                return i

        def stealer():
            i = steal_pick()
            if i is None:
                return
            try:
                results[i] = _encode_one(host_enc, images[i]).avif_file
            except BaseException as e:
                results[i] = e
            try:
                ex.submit(stealer)  # re-enqueue: grid jobs interleave
            except RuntimeError:
                pass  # pool shutting down: all chunks already claimed

        if steal_on:
            for _ in range(max(1, workers - 1)):
                ex.submit(stealer)

        order = sorted(buckets.items(),
                       key=lambda kv: kv[0][0] != "color")
        for key, members in order:
            pass1_bucket(key, members, emit)
    out = []
    for i in range(len(prepped)):
        if i in results:
            r = results[i]
            if isinstance(r, BaseException):
                raise r
            out.append(r)
        else:
            out.append(futs[i].result())
    return out


def plane_mode_search_batch(
    planes: np.ndarray,
    dc_q: int,
    ac_q: int,
    lam: float,
    bit_depth: int,
    mesh=None,
    device: str = "cuda",
):
    """Device-side batched mode search (13 candidates, 32x32 blocks) over a
    batch of same-shaped planes: ops/block_search.plane_mode_search, which
    runs kernel K3 on the card. planes: (N, H, W) int32 with H, W
    multiples of 32. With a mesh, each rank searches its planes over its
    band of 32 px rows and every rank returns the whole result (H
    divisible by the tile axis)."""
    from ..ops.block_search import plane_mode_search

    return plane_mode_search(planes, dc_q, ac_q, lam, bit_depth, n=32,
                             device=device, mesh=mesh)
