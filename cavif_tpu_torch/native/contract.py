"""Python view of the op-stream contract (parsed from op_contract.h).

op_contract.h is the single definition site for the opcode numbering, the
per-op int32 stride, and the pass-1 candidate-mode order shared with the C++
tile coder. This module parses it at import (plain regex — no toolchain) so
opstream.py / the encoder splicer / the searches all read one table.
"""

from __future__ import annotations

import re
from pathlib import Path

_HEADER = Path(__file__).with_name("op_contract.h").read_text()

# X(OP_NAME, code, arity)
OPS: dict[str, tuple[int, int]] = {
    name: (int(code), int(arity))
    for name, code, arity in re.findall(
        r"X\((OP_\w+),\s*(\d+),\s*(\d+)\)", _HEADER
    )
}
if len(OPS) != len(set(code for code, _ in OPS.values())):
    raise ValueError("op_contract.h: duplicate opcode")

# total int32 stride (including the opcode), keyed by opcode value
OP_ARITY: dict[int, int] = {code: ar for code, ar in OPS.values()}

_m = re.search(
    r"#define CAVIF_CAND_MODES\s*\\?\s*\{([^}]*)\}", _HEADER
)
CAND_MODES: tuple[int, ...] = tuple(
    int(v) for v in _m.group(1).replace(",", " ").split()
)
_n = re.search(r"#define CAVIF_CAND_MODES_N\s+(\d+)", _HEADER)
if len(CAND_MODES) != int(_n.group(1)):
    raise ValueError("op_contract.h: CAND_MODES length mismatch")


def __getattr__(name: str) -> int:
    if name in OPS:
        return OPS[name][0]
    raise AttributeError(name)
