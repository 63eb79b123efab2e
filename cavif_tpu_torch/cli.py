"""cavif CLI: convert JPEG/PNG images to AVIF.

Flag-for-flag mirror of the reference binary (/root/reference/src/main.rs:
45-250): same defaults (quality 80, speed 4, threads 0, ycbcr, depth auto),
same alpha-quality derivation, same input filtering/warnings, same
output-path resolution and overwrite guard, same per-file summary line and
error reporting (collected failures, exit 1). File-level parallelism uses a
thread pool (the encode pipeline releases the GIL in its native stages) —
the analog of the reference's rayon par_iter.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Union

STDIO = object()  # MaybePath::Stdio marker
PathOrStdio = Union[Path, object]


def parse_quality(arg: str) -> float:
    try:
        q = float(arg)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))
    if q < 1.0 or q > 100.0:
        raise argparse.ArgumentTypeError("quality must be in 1-100 range")
    return q


def parse_speed(arg: str) -> int:
    try:
        s = int(arg)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))
    # The reference CLI accepts 1..=100 here (the message says 1-10; values
    # over 10 panic later in the encoder's assert) — replicated literally
    # (src/main.rs:36-42, SURVEY.md C2).
    if s < 1 or s > 100:
        raise argparse.ArgumentTypeError("speed must be in 1-10 range")
    return s


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cavif",
        description="Convert JPEG/PNG images to AVIF image format",
    )
    p.add_argument("-Q", "--quality", type=parse_quality, default=80.0,
                   metavar="n", help="Quality from 1 (worst) to 100 (best)")
    p.add_argument("-s", "--speed", type=parse_speed, default=4, metavar="n",
                   help="Encoding speed from 1 (best) to 10 (fast but ugly)")
    p.add_argument("-j", "--threads", type=int, default=0, metavar="n",
                   help="Maximum threads to use (0 = one thread per host core)")
    p.add_argument("-f", "--overwrite", "--force", action="store_true",
                   help="Replace files if there's .avif already")
    p.add_argument("-o", "--output", metavar="path",
                   help="Write output to this path instead of same_file.avif."
                        " It may be a file or a directory.")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="Don't print anything")
    p.add_argument("--dirty-alpha", action="store_true",
                   help="Keep RGB data of fully-transparent pixels"
                        " (makes larger, lower quality files)")
    p.add_argument("--color", choices=["ycbcr", "rgb"], default="ycbcr",
                   help="Internal AVIF color model."
                        " YCbCr works better for human eyes.")
    p.add_argument("--tune", choices=["psnr", "ssim"], default="psnr",
                   help="RD objective (extension beyond the reference CLI): "
                        "ssim enables per-superblock adaptive quantization")
    p.add_argument("--depth", choices=["8", "10", "auto"], default="auto",
                   help="Write 8-bit (more compatible) or 10-bit"
                        " (better quality) images")
    p.add_argument("IMAGES", nargs="*",
                   help='One or more JPEG or PNG files to convert.'
                        ' "-" is interpreted as stdin/stdout.')
    return p


def filter_files(raw: List[str], quiet: bool) -> List[PathOrStdio]:
    """Input filtering: skip existing .avif (warn), keep nonexistent .avif
    with a -o hint, warn when -q swallowed a numeric quality value
    (src/main.rs:136-163)."""
    out: List[PathOrStdio] = []
    for s in raw:
        path = Path(s)
        if quiet and s.isdigit() and 0 <= int(s) <= 255 and not path.exists():
            print(
                f"warning: -q is not for quality, so '{s}' is misinterpreted"
                f" as a file. Use -Q {s}",
                file=sys.stderr,
            )
        keep = True
        if path.suffix == ".avif":
            keep = False
            if not quiet:
                if path.exists():
                    print(
                        f"warning: ignoring {s}, because it's already an AVIF",
                        file=sys.stderr,
                    )
                else:
                    print(f"warning: Did you mean to use -o {s}?",
                          file=sys.stderr)
                    keep = True
        if keep:
            out.append(STDIO if s == "-" else path)
    return out


def _error_chain(e: BaseException) -> str:
    lines = [f"error: {e}"]
    cause = e.__cause__ or e.__context__
    seen = {id(e)}
    while cause is not None and id(cause) not in seen:
        lines.append(f"because: {cause}")
        seen.add(id(cause))
        cause = cause.__cause__ or cause.__context__
    return "\n".join(lines)


def run(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)

    from . import AlphaColorMode, BitDepth, ColorModel, Encoder
    from .ops.ingest import load_rgba

    output: Optional[PathOrStdio]
    if args.output is None:
        output = None
    elif args.output == "-":
        output = STDIO
    else:
        output = Path(args.output)

    quality = args.quality
    alpha_quality = min((quality + 100.0) / 2.0,
                        quality + quality / 4.0 + 2.0)
    depth = {"8": BitDepth.Eight, "10": BitDepth.Ten,
             "auto": BitDepth.Auto}[args.depth]
    color_model = (ColorModel.YCbCr if args.color == "ycbcr"
                   else ColorModel.RGB)

    files = filter_files(args.IMAGES, args.quiet)
    if not files:
        raise RuntimeError("No PNG/JPEG files specified")

    use_dir = False
    if isinstance(output, Path):
        if len(files) > 1:
            try:
                output.mkdir(parents=True, exist_ok=True)
            except OSError:
                pass
        use_dir = len(files) > 1 or output.is_dir()

    def process(data: bytes, input_path: PathOrStdio) -> None:
        img = load_rgba(data, False)
        del data
        out_path: PathOrStdio
        if output is None and isinstance(input_path, Path):
            out_path = input_path.with_suffix(".avif")
        elif isinstance(output, Path) and isinstance(input_path, Path):
            if use_dir:
                out_path = output / Path(input_path.name).with_suffix(".avif")
            else:
                out_path = output
        elif isinstance(output, Path):
            out_path = output  # stdin input, file output
        else:
            out_path = STDIO
        if (
            isinstance(out_path, Path)
            and not args.overwrite
            and out_path.exists()
        ):
            raise RuntimeError(f"{out_path} already exists; skipping")
        enc = (
            Encoder.new()
            .with_quality(quality)
            .with_bit_depth(depth)
            .with_speed(min(args.speed, 10))
            .with_alpha_quality(alpha_quality)
            .with_internal_color_model(color_model)
            .with_alpha_color_mode(
                AlphaColorMode.UnassociatedDirty if args.dirty_alpha
                else AlphaColorMode.UnassociatedClean
            )
            .with_num_threads(args.threads if args.threads > 0 else None)
            .with_tune(args.tune)
        )
        if args.speed > 10:
            # mirror the reference's late panic for speeds 11-100
            enc = enc.with_speed(args.speed)
        res = enc.encode_rgba(img)
        if isinstance(out_path, Path):
            if not args.quiet:
                total = len(res.avif_file)
                heif = total - res.color_byte_size - res.alpha_byte_size
                kb = -(-total // 1000)
                print(f"{out_path}: {kb}KB ({res.color_byte_size}B color,"
                      f" {res.alpha_byte_size}B alpha, {heif}B HEIF)")
            out_path.write_bytes(res.avif_file)
        else:
            sys.stdout.buffer.write(res.avif_file)
            sys.stdout.buffer.flush()

    def job(path: PathOrStdio) -> Optional[str]:
        if path is STDIO:
            name = "stdin"
            try:
                data = sys.stdin.buffer.read()
            except OSError as e:
                return f"{name}: error: {e}"
        else:
            name = str(path)
            try:
                data = path.read_bytes()
            except OSError as e:
                return f"{name}: error: Unable to read input image {path}: {e}"
        try:
            process(data, path)
        except BaseException as e:  # mirror per-file failure isolation
            return f"{name}: error: {e}"
        return None

    workers = args.threads if args.threads > 0 else (os.cpu_count() or 1)
    if len(files) == 1:
        failures = [f for f in (job(files[0]),) if f]
    else:
        with ThreadPoolExecutor(max_workers=min(workers, len(files))) as ex:
            failures = [f for f in ex.map(job, files) if f]

    if failures:
        if not args.quiet:
            for f in failures:
                print(f"error: {f}", file=sys.stderr)
        sys.exit(1)


def main(argv: Optional[List[str]] = None) -> None:
    try:
        run(argv)
    except SystemExit:
        raise
    except BaseException as e:
        print(_error_chain(e), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
