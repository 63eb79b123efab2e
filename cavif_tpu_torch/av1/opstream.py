"""Tile op stream: decouples encode decisions from entropy serialization.

The encoder walks the partition tree and emits a compact int32 op stream
(partition choices, block modes, coefficient levels). Serialization — context
derivation, CDF adaptation, range coding, per-coefficient symbol work — is a
pure function of (tile params, op stream) and runs in one of two backends:

- native: the C++ tile coder (cavif_tpu/native), the production path;
- python: replay through symbols.TileWriter, the reference oracle.

Both produce byte-identical tiles (differentially tested). Tiles are
entropy-independent, so op streams for different tiles serialize in parallel
(C++ releases the GIL).

This is the host tail of the TPU design: the device computes modes/levels for
batches of blocks; this layer is the only sequential-per-symbol stage, kept
native. Reference parity: rav1e's tile encode under Context::receive_packet
(/root/reference/ravif/src/av1encoder.rs:748-771).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .symbols import TileParams, TileWriter

# opcode numbering + per-op strides: single definition site is
# native/op_contract.h (shared with the C++ tile coder); see the header
# for per-op operand docs
from ..native.contract import OP_ARITY, OPS as _OPS

OP_CLEAR_LEFT = _OPS["OP_CLEAR_LEFT"][0]
OP_PARTITION = _OPS["OP_PARTITION"][0]
OP_SPLIT_BIN = _OPS["OP_SPLIT_BIN"][0]
OP_BLOCK = _OPS["OP_BLOCK"][0]
OP_COEFFS = _OPS["OP_COEFFS"][0]
OP_BLOCK_COMPUTE = _OPS["OP_BLOCK_COMPUTE"][0]
OP_SB_START = _OPS["OP_SB_START"][0]
OP_LR = _OPS["OP_LR"][0]
OP_DELTA_Q = _OPS["OP_DELTA_Q"][0]
OP_LR_UNIT = _OPS["OP_LR_UNIT"][0]


class OpTileWriter:
    """Collects ops; same call surface as TileWriter (minus context state,
    which lives in the serializer backend)."""

    def __init__(self, p: TileParams):
        self.p = p
        self.ops: List[int] = []
        self.levels: List[np.ndarray] = []
        self._lvl_len = 0

    def clear_left(self) -> None:
        self.ops.append(OP_CLEAR_LEFT)

    def write_partition(self, r: int, c: int, bsl: int, partition: int) -> None:
        self.ops.extend((OP_PARTITION, r, c, bsl, partition))

    def write_split_binary(self, r: int, c: int, bsl: int, horz: bool, split: bool) -> None:
        self.ops.extend((OP_SPLIT_BIN, r, c, bsl, int(horz), int(split)))

    def write_block(
        self, r: int, c: int, w4: int, h4: int, y_mode: int, uv_mode: int,
        skip: int, cfl_allowed: bool, y_delta: int = 0, uv_delta: int = 0,
        cfl_signs: int = 0, cfl_au: int = 0, cfl_av: int = 0,
    ) -> None:
        """skip + intra modes + context bookkeeping for one leaf block
        (uv_mode 13 = CfL, with its joint sign + coded alphas)."""
        self.ops.extend(
            (OP_BLOCK, r, c, w4, h4, y_mode, uv_mode, skip, int(cfl_allowed),
             y_delta, uv_delta, int(cfl_signs), int(cfl_au), int(cfl_av))
        )

    def write_block_compute(
        self, r: int, c: int, w4: int, h4: int, y_mode: int, uv_mode: int,
        y_delta: int = 0, uv_delta: int = 0,
    ) -> None:
        """Skeleton op for the native pass-2 pipeline: the C++ side computes
        levels/skip/recon itself. r, c are absolute mi coords."""
        self.ops.extend(
            (OP_BLOCK_COMPUTE, r, c, w4, h4, y_mode, y_delta, uv_mode, uv_delta)
        )

    def write_sb_start(self, r: int, c: int) -> None:
        self.ops.extend((OP_SB_START, r, c))

    def write_delta_q(self, qindex: int, dc_q: int, ac_q: int) -> None:
        """This superblock's target quantizer (adaptive q); the tile coder
        emits the spec delta symbol inside the first block's mode_info."""
        self.ops.extend((OP_DELTA_Q, qindex, dc_q, ac_q))

    def write_lr_unit(
        self, plane: int, use: int, taps,
        frame_type: int = 2, sgr_set: int = 0, xqd=(0, 0),
    ) -> None:
        t = taps if use == 1 else (0, 0, 0, 0, 0, 0)
        if frame_type == 2 and use != 2:
            self.ops.extend((OP_LR, plane, int(use), *(int(v) for v in t)))
            return
        self.ops.extend(
            (OP_LR_UNIT, plane, int(frame_type), int(use), int(sgr_set),
             int(xqd[0]), int(xqd[1]), *(int(v) for v in t))
        )

    def write_coeffs(
        self, plane: int, r4: int, c4: int, txw: int, txh: int,
        levels: np.ndarray, tx_block_eq_block: bool = True,
        y_mode: int = 0, v_adst: int = 0, h_adst: int = 0,
    ) -> None:
        ch, cw = levels.shape
        self.ops.extend(
            (OP_COEFFS, plane, r4, c4, txw, txh, int(tx_block_eq_block),
             ch, cw, self._lvl_len, y_mode, v_adst, h_adst)
        )
        flat = np.ascontiguousarray(levels, dtype=np.int32).reshape(-1)
        self.levels.append(flat)
        self._lvl_len += flat.size

    def pack(self):
        ops = np.asarray(self.ops, dtype=np.int32)
        levels = (
            np.concatenate(self.levels)
            if self.levels
            else np.zeros(0, dtype=np.int32)
        )
        return ops, levels

    def finish(self, backend: Optional[str] = None) -> bytes:
        ops, levels = self.pack()
        if backend is None:
            backend = "native" if _native_available() else "python"
        if backend == "native":
            from ..native import encode_tile_native

            return encode_tile_native(self.p, ops, levels)
        return replay_python(self.p, ops, levels)


def _native_available() -> bool:
    try:
        from ..native import encode_tile_native  # noqa: F401

        return True
    except Exception:
        return False


def replay_python(p: TileParams, ops: np.ndarray, levels: np.ndarray) -> bytes:
    """Reference serializer: drive TileWriter from an op stream. Strides
    come from the shared contract table (native/op_contract.h)."""
    tw = TileWriter(p)
    i = 0
    n = len(ops)
    while i < n:
        op = int(ops[i])
        stride = OP_ARITY.get(op)
        if stride is None:
            raise ValueError(f"bad op {op} at {i}")
        row = [int(x) for x in ops[i : i + stride]]
        if op == OP_CLEAR_LEFT:
            tw.clear_left()
        elif op == OP_PARTITION:
            _, r, c, bsl, part = row
            tw.write_partition(r, c, bsl, part)
        elif op == OP_SPLIT_BIN:
            _, r, c, bsl, horz, split = row
            tw.write_split_binary(r, c, bsl, bool(horz), bool(split))
        elif op == OP_BLOCK:
            (_, r, c, w4, h4, ym, uvm, skip, cfl, yd, uvd,
             csg, cau, cav) = row
            tw.write_skip(r, c, skip)
            tw.maybe_write_delta_q(w4, h4, skip)
            tw.write_intra_modes(
                r, c, w4, h4, ym, uvm, bool(cfl), y_delta=yd, uv_delta=uvd,
                cfl_signs=csg, cfl_au=cau, cfl_av=cav,
            )
            tw.record_block(r, c, w4, h4, ym, skip)
            tw.update_partition_ctx(r, c, w4, h4)
            if skip:
                tw.reset_block_ctx(r, c, w4, h4)
        elif op == OP_COEFFS:
            _, pl, r4, c4, txw, txh, eq, ch, cw, off, ym, va, ha = row
            lv = levels[off : off + ch * cw].reshape(ch, cw)
            tw.write_coeffs(
                pl, r4, c4, txw, txh, lv, tx_block_eq_block=bool(eq),
                y_mode=ym, v_adst=va, h_adst=ha,
            )
        elif op == OP_SB_START:
            pass
        elif op == OP_DELTA_Q:
            tw.pending_qindex = row[1]
        elif op == OP_LR:
            _, pl, use, *t = row
            tw.write_lr_unit(pl, use, t)
        elif op == OP_LR_UNIT:
            _, pl, ft, use, st, x0, x1, *t = row
            tw.write_lr_unit(pl, use, t, frame_type=ft, sgr_set=st,
                             xqd=(x0, x1))
        i += stride
    return tw.finish()
