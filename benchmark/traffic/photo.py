"""Photo-like synthetic RGB images: smooth shading, texture and edges.

A frozen copy of the port's `tools/bench.py` `test_image` (its shading,
texture of sigma 6, 128 px checkerboard edges and colour offsets), with
two changes: each image of a pool has a phase of its own (an offset of
the pixel grid, 0-4095 px on each axis), and the arithmetic runs in
float32 on the device in a few large calls, so that set-up stays short at
8K. The phases of a pool of n images are a fixed set (drawn once from
PHASE_SEED): the run's seed orders them and draws the texture. So every
seed gives the pool the same sizes and the same kind of content, and the
work a run does, which the phase moves (the 8K frames' size by 2%), does
not change with the seed.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_PHASE = 4096
PHASE_SEED = 20261017


def images(spec: dict, seed: int, count: int, device: str) -> list:
    h, w = int(spec["height"]), int(spec["width"])
    fixed = torch.Generator(device=device)
    fixed.manual_seed(PHASE_SEED)
    phase = torch.randint(0, MAX_PHASE, (count, 2), generator=fixed,
                          device=device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    order = torch.randperm(count, generator=g, device=device)
    out = []
    for oy, ox in phase[order].tolist():
        texture = torch.randn((h, w), generator=g, device=device) * 6.0
        x = torch.arange(w, device=device, dtype=torch.float32) + ox
        y = torch.arange(h, device=device, dtype=torch.float32) + oy
        base = (110.0 + 80.0 * torch.sin(x / 97.0)[None, :]
                * torch.cos(y / 61.0)[:, None]
                + 40.0 * torch.sin((x[None, :] + 2.0 * y[:, None]) / 31.0))
        edges = 60.0 * ((torch.floor(x / 128.0)[None, :]
                         + torch.floor(y / 128.0)[:, None]) % 2.0)
        lum = torch.clamp(base + texture + 0.3 * edges, 0.0, 255.0)
        r = torch.clamp(lum + 18.0 * torch.sin(y / 83.0)[:, None], 0.0, 255.0)
        b = torch.clamp(lum - 22.0 * torch.cos(x / 71.0)[None, :], 0.0, 255.0)
        rgb = torch.stack([r, lum, b], dim=-1).to(torch.uint8)
        out.append(np.ascontiguousarray(rgb.cpu().numpy()))
    return out
