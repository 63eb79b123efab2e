"""Sweep the context-aware trellis strength (CAVIF_TPU_TRELLIS_CTX) on
the BD corpus and report BD-PSNR / BD-SSIM vs the libaom-s6 anchor for
each setting.

    python -m cavif_tpu_torch.tools.trellis_sweep [u values...]

Port of the repository's tools/trellis_sweep.py. Each strength runs in a
fresh child process (`--child`; the native tile coder caches env knobs
statically) with the default encoder, whose pass 1 runs on the card
(CAVIF_TPU_DEVICE_SEARCH=cpu or off in the caller's environment moves it
to the CPU or the host cascade); the libaom anchor sweep is computed once
in the parent.

Each argument is either a bare trellis strength ("1.2") or a comma-
separated env combo ("CAVIF_TPU_EOB_BITS=0.8,CAVIF_TPU_AC_BIAS=0.46").
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

OUR_QUALITIES = (40, 55, 65, 75, 85, 95)
AOM_QUALITIES = (35, 45, 55, 65, 75, 90)


def _child() -> None:
    """Encode the corpus at the current env's trellis setting; print
    one JSON line of per-image RD points."""
    from .ab_quality import images
    from .bdrate import sweep

    print(json.dumps(sweep(images(), device=None, qualities=OUR_QUALITIES)))


def run_child(env: dict) -> dict:
    """The child's {img: [(bytes, psnr, ssim), ...]} under `env`."""
    from .._child import run_json

    return run_json("cavif_tpu_torch.tools.trellis_sweep", ["--child"], env)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        _child()
        return 0
    from .ab_quality import images
    from .bdrate import _bd_quality, _bd_rate, aom_sweep

    us = argv or ["0", "0.3", "0.6", "0.9", "1.2"]
    anchors = aom_sweep(images(), qualities=AOM_QUALITIES)
    for u in us:
        env = {**os.environ, "CAVIF_TPU_TUNE": "psnr"}
        if "=" in u:
            for kv in u.split(","):
                k, _, v = kv.partition("=")
                env[k] = v
        else:
            env["CAVIF_TPU_TRELLIS_CTX"] = u
        ours = run_child(env)
        bdp_all, bds_all, bdr_all = [], [], []
        for name, aom in anchors.items():
            pts = ours[name]
            r1, p1, s1 = (np.asarray([a[i] for a in aom]) for i in range(3))
            r2, p2, s2 = (np.asarray([o[i] for o in pts]) for i in range(3))
            bdp = _bd_quality(r1, p1, r2, p2)
            bds = _bd_quality(r1, s1, r2, s2)
            bdr = _bd_rate(r1, p1, r2, p2)
            fmt = lambda v, f: ("n/a" if v is None else f % v)  # noqa: E731
            print(f"  u={u} {name:10s} BD-PSNR {fmt(bdp, '%+.3f')} dB  "
                  f"BD-SSIM {fmt(bds, '%+.5f')}  BD-rate {fmt(bdr, '%+.1f')}%",
                  flush=True)
            if bdp is not None:
                bdp_all.append(bdp)
            if bds is not None:
                bds_all.append(bds)
            if bdr is not None:
                bdr_all.append(bdr)
        print(f"u={u} MEAN: BD-PSNR {np.mean(bdp_all):+.3f} dB  "
              f"BD-SSIM {np.mean(bds_all):+.5f}  "
              f"BD-rate {np.mean(bdr_all):+.1f}%", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
