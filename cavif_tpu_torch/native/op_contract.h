// Single definition site for the Python<->C++ op-stream contract.
//
// Consumed twice:
//   - tilecoder.cpp #includes it and expands CAVIF_OP_TABLE into the opcode
//     constants and per-op strides used by both replay switches;
//   - cavif_tpu/native/contract.py parses it (regex, no compiler) into the
//     OP_* constants / arity map used by opstream.py, replay_python, and the
//     encoder's op-stream splicer.
// A new opcode added here (and handled in the consumers) can no longer skew
// the three arity tables silently (tests/test_contract.py pins agreement
// with the compiled library).
//
// X(NAME, CODE, ARITY): ARITY = total int32 stride INCLUDING the opcode.
#define CAVIF_OP_TABLE(X)                                                   \
  X(OP_CLEAR_LEFT, 0, 1)    /* reset left context at a tile row start */    \
  X(OP_PARTITION, 1, 5)     /* (r, c, bsl, partition) */                    \
  X(OP_SPLIT_BIN, 2, 6)     /* (r, c, bsl, horz, split) */                  \
  X(OP_BLOCK, 3, 14)        /* (r, c, w4, h4, ym, uvm, skip, cfl_allowed,   \
                               y_delta, uv_delta, cfl_signs, au, av) */     \
  X(OP_COEFFS, 4, 13)       /* (pl, r4, c4, txw, txh, eq, ch, cw, lvl_off,  \
                               y_mode, v_adst, h_adst) */                   \
  X(OP_BLOCK_COMPUTE, 5, 9) /* (r, c, w4, h4, ym, yd, uvm, uvd), abs mi */  \
  X(OP_SB_START, 6, 3)      /* (r, c abs mi): superblock boundary */        \
  X(OP_LR, 7, 9)            /* (plane, use, t0v..t2v, t0h..t2h) */          \
  X(OP_LR_UNIT, 8, 13)      /* (plane, frame_type, use, set, xqd0, xqd1,    \
                               t0v..t2v, t0h..t2h) */                       \
  X(OP_DELTA_Q, 9, 4)       /* (qindex, dc_q, ac_q): this SB's quantizer */

// Pass-1 candidate order shared by the numpy search, the device programs,
// and the C++ bs_search: 7 non-directional then the 6 diagonals at delta 0.
#define CAVIF_CAND_MODES_N 13
#define CAVIF_CAND_MODES \
  { 0, 1, 2, 9, 10, 11, 12, 3, 4, 5, 6, 7, 8 }
