"""One cell's set-up, measured window and check.

A session holds the encoder built from the configuration, the image pool
generated from the seed and the entry that the cell drives. The window
drives the entry in a closed loop: each stream issues its next request
when the last has returned, new requests start only while the window is
open, and the window ends when the work in flight has completed.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace

from reference import avif as reference
from traffic import generate

from . import devtrace, host


@dataclass
class Answer:
    image: int  # index into the pool
    avif: bytes | None
    error: str | None = None


@dataclass
class Window:
    seconds: float
    latencies: list  # seconds per request, every request of the window
    answers: list  # [Answer], one per image encoded
    pixels: int  # input pixels of the answered images
    avif_bytes: int
    spans: dict = field(default_factory=dict)  # the port's span totals
    device: devtrace.DeviceTrace | None = None
    setup_s: float | None = None
    host: dict = field(default_factory=dict)  # the host over the window
    sq_err: float = 0.0  # squared error of every decoded file, 8-bit levels
    samples: int = 0  # the samples it is summed over


def make_encoder(settings: dict, device: str):
    """The port's Encoder under a configuration's `encoder` settings; on
    the card the device is left unset, as a user leaves it."""
    from cavif_tpu_torch import (AlphaColorMode, BitDepth, ColorModel,
                                 Encoder)

    enc = (Encoder.new().with_quality(float(settings["quality"]))
           .with_speed(int(settings["speed"]))
           .with_bit_depth(BitDepth[settings["depth"]])
           .with_internal_color_model(ColorModel[settings["color_model"]])
           .with_alpha_color_mode(
               AlphaColorMode[settings["alpha_color_mode"]]))
    if "alpha_quality" in settings:  # else the library's default
        enc = enc.with_alpha_quality(float(settings["alpha_quality"]))
    return enc if device == "cuda" else replace(enc, device=device)


def make_entry(name: str, enc):
    """A callable from a list of images to [(avif bytes or None, error)],
    one per image, through the port's entry `name`."""
    if name == "encode_batch":
        from cavif_tpu_torch.parallel import encode_batch

        def call(images):
            return [(r.encoded.avif_file, None) if r.encoded is not None
                    else (None, f"{type(r.error).__name__}: {r.error}")
                    for r in encode_batch(images, enc)]
        return call
    if name == "encode_rgb":
        return _each(enc.encode_rgb)
    if name == "encode_rgba":  # cavif's CLI hands every input to it
        return _each(enc.encode_rgba)
    raise KeyError(f"no entry {name!r}")


def _each(encode):
    """The entry that encodes a list one image at a time."""
    def call(images):
        out = []
        for img in images:
            try:
                out.append((encode(img).avif_file, None))
            except Exception as e:  # an answer that never comes
                out.append((None, f"{type(e).__name__}: {e}"))
        return out
    return call


class Session:
    def __init__(self, cell, seed: int, device: str = "cuda",
                 settings: dict | None = None, wrap=None):
        """Generate the pool from `seed`, build the encoder (under
        `settings` in place of the configuration's, for a control) and its
        entry (wrapped by `wrap`, for a planted fault), and warm up every
        shape the window will use: one call of the entry over the first n
        images of the pool for each n of the cell's `warmup`."""
        self.cell, self.device = cell, device
        spec = cell.spec
        reference.judged_settings(settings or cell.config["encoder"])
        if spec.get("loop", "closed") != "closed":
            raise ValueError(f"{cell.name}: only a closed loop is driven")
        self.per_request = int(spec.get("list_length", 1))
        self.streams = int(spec.get("streams", 1))
        self.pool = generate(cell.config["image"], seed, int(spec["pool"]),
                             device)
        # RGBA inputs: their alpha is held to a limit of its own
        self.rgba = any(im.shape[2] == 4 for im in self.pool)
        if self.rgba and "alpha_rmse_worst" not in spec["limits"]:
            raise ValueError(f"{cell.name}: RGBA inputs, and no limit for "
                             "alpha_rmse_worst")
        if device == "cuda":
            # The port measures its link to the card once per process, at
            # first use, and engages the filter chain on it. Taken here,
            # before any other work, it reads the card alone and not
            # behind a list's other threads.
            from cavif_tpu_torch.ops import attachment

            attachment.probe()
        self.enc = make_encoder(settings or cell.config["encoder"], device)
        self.entry = make_entry(spec["entry"], self.enc)
        if wrap is not None:
            self.entry = wrap(self.entry)
        for n in spec.get("warmup", [self.per_request]):
            self.entry(self.pool[:int(n)])
        self._sync()
        host.settle()

    def reseed(self, seed: int) -> None:
        """A new pool of the same sizes (readings over many seeds in one
        process)."""
        self.pool = generate(self.cell.config["image"], seed,
                             len(self.pool), self.device)

    def mode(self) -> dict | None:
        """The program's mode as it ran: the attachment probe's round trip
        and whether it engaged the filter chain (None off the card)."""
        if self.device != "cuda":
            return None
        from cavif_tpu_torch.ops import attachment

        return {"rtt_ms": attachment.probe()["rtt_ms"],
                "device_filters": attachment.engage_device_filters()}

    def mode_faults(self) -> list:
        """[each key of the cell's `mode` that the program ran otherwise]."""
        got = self.mode()
        if got is None:
            return []
        return [f"{k}: the cell states {v}, the program ran {got.get(k)}"
                for k, v in self.cell.spec.get("mode", {}).items()
                if got.get(k) != v]

    def _sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def window(self, seconds: float, trace: bool = False) -> Window:
        n = len(self.pool)
        lock = threading.Lock()
        issued = [0]
        lat, answers, errors = [], [], []
        sub = None
        if trace:
            from cavif_tpu_torch.utils import trace as spans

            prof = self.cell.spec["profile"]
            sub = devtrace.SubWindow(float(prof["start_s"]),
                                     float(prof["seconds"]),
                                     self.device == "cuda")
            spans.set_enabled(True)
            spans.set_accumulate(True)
            clock = devtrace.SpanClock(spans)
            clock.start()
        gcs = host.GcClock()
        gcs.start()
        before = host.now()
        t0 = time.perf_counter()
        end = t0 + seconds

        def stream():
            try:
                loop()
            except BaseException as e:  # raised again below
                errors.append(e)

        def loop():
            while time.perf_counter() < end:
                with lock:
                    k = issued[0]
                    issued[0] += 1
                idx = [(k * self.per_request + j) % n
                       for j in range(self.per_request)]
                s = time.perf_counter()
                got = self.entry([self.pool[i] for i in idx])
                dt = time.perf_counter() - s
                with lock:
                    lat.append(dt)
                    answers.extend(Answer(i, b, err)
                                   for i, (b, err) in zip(idx, got))

        # the streams run in threads of their own, so that this thread
        # starts and stops the profiler, as the profiler requires
        threads = [threading.Thread(target=stream)
                   for _ in range(self.streams)]
        for t in threads:
            t.start()
        raw = None
        try:
            if sub is not None:
                raw = sub.run(lambda: not any(t.is_alive() for t in threads))
        finally:
            for t in threads:
                t.join()
            self._sync()
            wall = time.perf_counter() - t0
            after = host.now()
            gcs.stop()
            if trace:
                clock.stop()
                table = dict(spans.ACCUM)
                spans.set_enabled(False)
                spans.set_accumulate(False)
        if errors:
            raise errors[0]
        if trace and not clock.rows and any("n_" + k in table
                                            for k in table):
            raise RuntimeError(
                "the port's spans ran, but none through the span clock: "
                "a caller holds `span` from before the window, so the idle "
                "gaps would go unlabelled")
        tr = devtrace.reduce(*raw, clock.rows) if raw is not None else None
        ok = [a for a in answers if a.avif is not None]
        return Window(
            seconds=wall, latencies=lat, answers=answers,
            pixels=sum(self.pool[a.image].shape[0] * self.pool[a.image].shape[1]
                       for a in ok),
            avif_bytes=sum(len(a.avif) for a in ok),
            spans=table if trace else {}, device=tr,
            host={**host.state(before, after), **gcs.reading()})

    def check(self, win: Window):
        """({number compared: {"value", "limit"}}, [what was found wrong]):
        every answer of the window judged by the plain reference against
        its input. Leaves the squared error of the decoded files on `win`
        for the quality metric."""
        want = self.cell.config["states"]
        limits = self.cell.spec["limits"]
        unanswered = decode_failed = faults = 0
        worst = 0.0
        alpha, alpha_answered = [], 0  # of the RGBA inputs' files
        win.sq_err, win.samples = 0.0, 0
        notes = []
        for a in win.answers:
            if a.avif is None:
                unanswered += 1
                notes.append(a.error)
                continue
            got = reference.judge(a.avif, self.pool[a.image], want)
            if self.pool[a.image].shape[2] == 4:
                alpha_answered += 1
                if got["decoded"]:
                    alpha.append(got["rmse_alpha"])
            faults += len(got["faults"])
            notes += got["faults"]
            if not got["decoded"]:
                decode_failed += 1
                notes.append(got.get("error"))
            elif got["rmse"] is None or worst is None:
                worst = None
            else:
                worst = max(worst, got["rmse"])
                size = self.pool[a.image].size
                win.sq_err += got["rmse"] ** 2 * size
                win.samples += size
        if decode_failed == len(win.answers) - unanswered:
            worst = None  # no file decoded, no number: fails its limit
        nums = {"unanswered": unanswered, "decode_failed": decode_failed,
                "property_faults": faults, "rmse_worst": worst}
        if self.rgba:
            # no decoded file of an RGBA input, or one without a
            # reading: no number, which fails its limit
            nums["alpha_rmse_worst"] = (
                None if None in alpha or (alpha_answered and not alpha)
                else max(alpha, default=0.0))
        out = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
        return out, sorted({str(n) for n in notes if n})[:8]
