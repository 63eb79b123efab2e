// Native AV1 tile serializer: range coder + context/CDF state machine.
//
// Consumes the op stream produced by cavif_tpu/av1/opstream.py and emits one
// entropy-coded AV1 tile, byte-identical to the Python reference serializer
// (symbols.TileWriter driven by opstream.replay_python) — differentially
// tested in tests/test_native_tilecoder.py.
//
// This is the host-side serial tail of the TPU encode design: the device
// computes modes/levels for batches of blocks; the per-symbol work (context
// derivation, CDF adaptation, arithmetic coding) is inherently sequential
// per tile and runs here. Tiles are entropy-independent, so callers encode
// many tiles in parallel (this code is thread-safe per call and holds no
// global mutable state besides the read-only spec tables installed at init).
//
// Reference parity: rav1e's od_ec + tile encode loop, exercised via
// /root/reference/ravif/src/av1encoder.rs:748-771.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <algorithm>
#include <thread>
#include <mutex>
#include <functional>

namespace {

// ---------------------------------------------------------------------------
// Spec tables (installed once from Python; same npz as av1/tables.py).
// ---------------------------------------------------------------------------

struct SpecTables {
  // CDF tables, inverted layout (icdf), raw copies of the npz arrays.
  std::vector<uint16_t> partition;  // (20, 11)         nsym 4/10/8 by bsl
  std::vector<uint16_t> kf_y;       // (5, 5, 14)       nsym 13
  std::vector<uint16_t> uv;         // (2, 13, 15)      nsym 13 / 14 (cfl)
  std::vector<uint16_t> skip;       // (3, 3)           nsym 2
  std::vector<uint16_t> angle;      // (8, 8)           nsym 7
  std::vector<uint16_t> txb_skip;   // (4, 5, 13, 3)    nsym 2
  std::vector<uint16_t> eob_pt16;   // (4, 2, 2, 6)     nsym 5
  std::vector<uint16_t> eob_pt32;   // (4, 2, 2, 7)     nsym 6
  std::vector<uint16_t> eob_pt64;   // (4, 2, 2, 8)     nsym 7
  std::vector<uint16_t> eob_pt128;  // (4, 2, 2, 9)     nsym 8
  std::vector<uint16_t> eob_pt256;  // (4, 2, 2, 10)    nsym 9
  std::vector<uint16_t> eob_pt512;  // (4, 2, 2, 11)    nsym 10
  std::vector<uint16_t> eob_pt1024; // (4, 2, 2, 12)    nsym 11
  std::vector<uint16_t> eob_extra;  // (4, 5, 2, 9, 3)  nsym 2
  std::vector<uint16_t> base;       // (4, 5, 2, 42, 5) nsym 4
  std::vector<uint16_t> base_eob;   // (4, 5, 2, 4, 4)  nsym 3
  std::vector<uint16_t> br;         // (4, 5, 2, 21, 5) nsym 4
  std::vector<uint16_t> dc_sign;    // (4, 2, 3, 3)     nsym 2
  std::vector<uint16_t> intra_ext_tx; // (2, 4, 13, 17)  nsym 7 (set1) / 5 (set2)
  std::vector<uint16_t> cfl_sign;   // (9,)             nsym 8
  std::vector<uint16_t> cfl_alpha;  // (6, 17)          nsym 16
  // context-aware trellis symbol costs (1/128-bit units, uploaded from
  // python tables.trellis_cost so both backends price bit-identically)
  std::vector<uint16_t> trellis_base;     // (4, 5, 2, 42, 4)
  std::vector<uint16_t> trellis_base_eob; // (4, 5, 2, 4, 3)
  std::vector<uint16_t> trellis_br;       // (4, 5, 2, 21, 4)
  // scans (forward diagonal) + coeff-base context offsets, per (w, h)
  // coded-area size; index = (log2(w)-2)*4 + (log2(h)-2), sizes 4..32.
  std::vector<int32_t> scan[16];
  std::vector<uint8_t> nzoff[16];
  // smooth-predictor weights per size 4..64 (index log2(n)-2)
  std::vector<uint8_t> sm_weights[5];
  // directional slope table dr_intra_derivative[90]
  std::vector<int32_t> dr;
  // 12-bit cos table for the integer inverse transform (64 entries)
  std::vector<int32_t> cospi;
};

SpecTables g_tables;

const struct DctMatrix& dct_matrix(int n);
// Pre-warm the DCT matrix cache at load time (single-threaded dlopen), so
// the lazy init never races between tile / search worker threads.
const bool g_dct_warm = [] {
  for (int n : {4, 8, 16, 32, 64}) dct_matrix(n);
  return true;
}();

int size_idx(int w, int h) {
  int lw = 0, lh = 0;
  while ((4 << lw) < w) lw++;
  while ((4 << lh) < h) lh++;
  return lw * 4 + lh;
}

// ---------------------------------------------------------------------------
// Range encoder: exact mirror of av1/ec.py (od_ec_enc).
// ---------------------------------------------------------------------------

constexpr int EC_PROB_SHIFT = 6;
constexpr int EC_MIN_PROB = 4;
constexpr uint32_t PROB_TOP = 1u << 15;

inline int bitlength(uint32_t v) {
  int n = 0;
  while (v) { n++; v >>= 1; }
  return n;
}

inline uint32_t interval(uint32_t rng, uint32_t icdf_s, int n_minus_1_minus_s) {
  return (((rng >> 8) * (icdf_s >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) +
         EC_MIN_PROB * (uint32_t)n_minus_1_minus_s;
}

struct RangeEncoder {
  std::vector<uint32_t> precarry;  // 9-bit entries
  uint64_t low = 0;
  uint32_t rng = PROB_TOP;
  int cnt = -9;

  void normalize(uint64_t lw, uint32_t r) {
    int d = 16 - bitlength(r);
    int s = cnt + d;
    if (s >= 0) {
      int c = cnt;
      uint64_t m = (1ull << (c + 16)) - 1;
      if (s > 7) {
        precarry.push_back((uint32_t)((lw >> (c + 16)) & 0xFFFF));
        lw &= m;
        c -= 8;
        m >>= 8;
      }
      precarry.push_back((uint32_t)((lw >> (c + 16)) & 0xFFFF));
      lw &= m;
      s = c + d - 8;
    }
    low = (lw << d) & 0xFFFFFFFFull;
    rng = r << d;
    cnt = s;
  }

  void encode_symbol(int s, const uint16_t* icdf, int n) {
    uint32_t r = rng;
    uint64_t lw = low;
    uint32_t v = interval(r, icdf[s], n - 1 - s);
    if (s > 0) {
      uint32_t u = interval(r, icdf[s - 1], n - s);
      lw += r - u;
      r = u - v;
    } else {
      r -= v;
    }
    normalize(lw, r);
  }

  void encode_symbol2(int s, uint32_t icdf0) {
    // 2-symbol fast path (icdf = {icdf0, 0})
    uint32_t r = rng;
    uint64_t lw = low;
    if (s > 0) {
      uint32_t u = interval(r, icdf0, 1);   // n - s = 1
      uint32_t v = interval(r, 0, 0);       // icdf[1] = 0, n - 1 - s = 0
      lw += r - u;
      r = u - v;
    } else {
      r -= interval(r, icdf0, 1);           // n - 1 - s = 1
    }
    normalize(lw, r);
  }

  void encode_literal(uint32_t value, int bits) {
    for (int i = bits - 1; i >= 0; i--)
      encode_symbol2((value >> i) & 1, PROB_TOP >> 1);
  }

  // Returns number of bytes written to out (caller sized it); -1 on overflow.
  int done(uint8_t* out, int cap) {
    int c = cnt;
    int s = c + 10;
    std::vector<uint32_t> entries = precarry;
    if (s > 0) {
      uint64_t m = (1ull << (c + 16)) - 1;
      uint64_t e = ((low + 0x3FFF) & ~0x3FFFull) | 0x4000;
      while (s > 0) {
        entries.push_back((uint32_t)((e >> (c + 16)) & 0xFFFF));
        e &= m;
        s -= 8;
        c -= 8;
        m >>= 8;
      }
    }
    int n = (int)entries.size();
    if (n == 0) {
      if (cap < 1) return -1;
      out[0] = 0;
      return 1;
    }
    if (n > cap) return -1;
    uint32_t carry = 0;
    for (int i = n - 1; i >= 0; i--) {
      uint32_t v = entries[i] + carry;
      out[i] = (uint8_t)(v & 0xFF);
      carry = v >> 8;
    }
    return n;
  }
};

// ---------------------------------------------------------------------------
// Adaptive CDF store: materialized copies of the default tables + counter.
// Mirrors symbols.Cdfs (lazy copy ≡ eager copy: first use sees defaults).
// ---------------------------------------------------------------------------

constexpr int CDF_MAX = 16;

struct CdfRow {
  uint16_t v[CDF_MAX];
  uint16_t count;
};

inline void load_row(CdfRow& row, const uint16_t* src, int nsym) {
  for (int i = 0; i < nsym; i++) row.v[i] = src[i];
  row.count = 0;
}

inline void update_cdf(CdfRow& row, int val, int nsym) {
  int count = row.count;
  int nbits = bitlength((uint32_t)nsym) - 1;
  if (nbits > 2) nbits = 2;
  int rate = 3 + (count > 15) + (count > 31) + nbits;
  int tmp = (int)PROB_TOP;
  for (int i = 0; i < nsym - 1; i++) {
    if (i == val) tmp = 0;
    if (tmp < row.v[i])
      row.v[i] -= (uint16_t)((row.v[i] - tmp) >> rate);
    else
      row.v[i] += (uint16_t)((tmp - row.v[i]) >> rate);
  }
  row.count = (uint16_t)(count + (count < 32));
}

// ---------------------------------------------------------------------------
// Tile state (contexts + adaptive CDFs), mirroring symbols.TileWriter.
// ---------------------------------------------------------------------------

// Opcodes + strides from the shared contract header (single definition
// site with the Python side; see op_contract.h for per-op operand docs).
// NAME##_N = total int32 stride including the opcode.
#include "op_contract.h"
#define CAVIF_X(NAME, CODE, ARITY) \
  constexpr int NAME = CODE;       \
  constexpr int NAME##_N = ARITY;
CAVIF_OP_TABLE(CAVIF_X)
#undef CAVIF_X

constexpr int DC_PRED = 0, V_PRED = 1, D67 = 8;

const int INTRA_MODE_CONTEXT[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};

const int SKIP_CONTEXTS[5][5] = {
    {1, 2, 2, 2, 3},
    {1, 4, 4, 4, 5},
    {1, 4, 4, 4, 5},
    {1, 4, 4, 4, 5},
    {1, 4, 4, 4, 6},
};

int q_ctx(int base_q) {
  if (base_q <= 20) return 0;
  if (base_q <= 60) return 1;
  if (base_q <= 120) return 2;
  return 3;
}

int txsize_ctx(int w, int h) {
  int sqr = w < h ? w : h;
  int sqr_up = w < h ? h : w;
  int a = bitlength((uint32_t)sqr) - 3;
  int b = bitlength((uint32_t)sqr_up) - 3;
  int t = (a + b + 1) >> 1;
  return t < 4 ? t : 4;
}

// Optional stage profiler for the block pipeline: rebuild with
// -DCAVIF_BP_PROF (native/__init__.py env CAVIF_TPU_BP_PROF=1 at first
// build) to print per-stage accumulators per bp_encode_tile call. Not
// compiled by default: the instrumented write_coeffs epilogue costs ~6%
// encode time even when disabled at runtime.
#ifdef CAVIF_BP_PROF
static thread_local double g_bpt[4];  // predict, fwd+quant, inv+recon, ec
static inline double bp_now() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
#define BP_PROF_MARK(slot, t0) \
  { double t1_ = bp_now(); g_bpt[slot] += t1_ - (t0); (t0) = t1_; }
#else
#define BP_PROF_MARK(slot, t0)
#endif

struct TileCoder {
  RangeEncoder enc;
  bool cdf_update;
  bool reduced_tx_set = false;
  // ec_off: run the block pipeline WITHOUT entropy coding (every write_*
  // is a no-op). Used by the deferred-EC encode flow: the pipeline's
  // decisions/recon/op-capture run first, the loop-restoration decision
  // lands, and the bitstream is produced ONCE by the replay coder
  // (encode_tile_native) — instead of coding every symbol here and again
  // in the LR re-serialization. Decisions never read EC state (rates come
  // from the uploaded cost tables), so outputs are unchanged; the replay
  // byte-identity tests pin that.
  bool ec_off = false;
  int qctx;
  int num_planes;
  int w4, h4;        // context array extents (tile + 32 slack)
  int mi_w4, mi_h4;  // tile mi dimensions (context-write clamp bound)

  // contexts
  std::vector<uint8_t> above_part, left_part;
  std::vector<int16_t> y_modes;   // h4 * w4
  std::vector<uint8_t> skips;     // h4 * w4
  std::vector<uint8_t> above_ctx[3], left_ctx[3];

  // adaptive CDFs (q dim pre-sliced where applicable)
  CdfRow cdf_partition[20];
  CdfRow cdf_kf_y[25];
  CdfRow cdf_uv[2][13];
  CdfRow cdf_skip[3];
  CdfRow cdf_wiener;
  CdfRow cdf_sgrproj;
  CdfRow cdf_switchable;
  CdfRow cdf_angle[8];
  CdfRow cdf_cfl_sign;
  CdfRow cdf_cfl_alpha[6];
  CdfRow cdf_txb_skip[5][13];
  CdfRow cdf_eob_pt[7][2];        // [log2(area)/... idx][ptype], ctx = 0
  CdfRow cdf_eob_extra[5][2][9];
  CdfRow cdf_base[5][2][42];
  CdfRow cdf_base_eob[5][2][4];
  CdfRow cdf_br[5][2][21];        // txs ctx clamped to 0..3 by callers; 5 kept
  CdfRow cdf_dc_sign[2][3];
  CdfRow cdf_ext_tx[2][4][13];
  CdfRow cdf_delta_q;
  // per-superblock adaptive quantization (spec read_delta_qindex):
  // CurrentQIndex starts at base_q per tile; the first block of each SB
  // codes the delta toward the pending target (unless it is an SB-sized
  // skip block, where the spec omits the symbol and q stays)
  int dq_res_log2 = 2;
  int cur_qindex = 0;
  int pending_qindex = -1;

  // scratch for coefficient coding
  std::vector<int32_t> padbuf;

  void init(int mi_col_start, int mi_col_end, int mi_row_start, int mi_row_end,
            int base_q, int planes, int disable_cdf_update) {
    cdf_update = !disable_cdf_update;
    qctx = q_ctx(base_q);
    cur_qindex = base_q;  // spec decode_tile: CurrentQIndex = base_q_idx
    pending_qindex = -1;
    num_planes = planes;
    w4 = mi_col_end - mi_col_start + 32;
    h4 = mi_row_end - mi_row_start + 32;
    mi_w4 = mi_col_end - mi_col_start;
    mi_h4 = mi_row_end - mi_row_start;
    above_part.assign(w4, 0);
    left_part.assign(h4, 0);
    y_modes.assign((size_t)w4 * h4, -1);
    skips.assign((size_t)w4 * h4, 0);
    for (int p = 0; p < 3; p++) {
      above_ctx[p].assign(w4, 0);
      left_ctx[p].assign(h4, 0);
    }
    const SpecTables& T = g_tables;
    for (int i = 0; i < 20; i++)
      load_row(cdf_partition[i], &T.partition[i * 11], 10);
    for (int i = 0; i < 25; i++)
      load_row(cdf_kf_y[i], &T.kf_y[i * 14], 13);
    for (int cfl = 0; cfl < 2; cfl++)
      for (int m = 0; m < 13; m++)
        load_row(cdf_uv[cfl][m], &T.uv[(cfl * 13 + m) * 15], cfl ? 14 : 13);
    for (int i = 0; i < 3; i++) load_row(cdf_skip[i], &T.skip[i * 3], 2);
    {
      // use_wiener default CDF (libaom default_wiener_restore_cdf,
      // AOM_CDF2(11570)) in the same inverted layout as the npz rows
      static const uint16_t wrow[3] = {32768 - 11570, 0, 0};
      load_row(cdf_wiener, wrow, 2);
      // default_sgrproj_restore_cdf AOM_CDF2(16855) and
      // default_switchable_restore_cdf AOM_CDF3(9413, 22581)
      static const uint16_t srow[3] = {32768 - 16855, 0, 0};
      load_row(cdf_sgrproj, srow, 2);
      static const uint16_t swrow[4] = {32768 - 9413, 32768 - 22581, 0, 0};
      load_row(cdf_switchable, swrow, 3);
      // default_delta_q_cdf AOM_CDF4(28160, 32120, 32677) — spec
      // Default_Delta_Q_Cdf; dav1d-validated by tests/test_delta_q.py
      static const uint16_t dqrow[5] = {32768 - 28160, 32768 - 32120,
                                        32768 - 32677, 0, 0};
      load_row(cdf_delta_q, dqrow, 4);
    }
    lr_init();
    for (int i = 0; i < 8; i++) load_row(cdf_angle[i], &T.angle[i * 8], 7);
    if (!T.cfl_sign.empty()) load_row(cdf_cfl_sign, T.cfl_sign.data(), 8);
    if (!T.cfl_alpha.empty())
      for (int i = 0; i < 6; i++)
        load_row(cdf_cfl_alpha[i], &T.cfl_alpha[i * 17], 16);
    for (int t = 0; t < 5; t++)
      for (int c = 0; c < 13; c++)
        load_row(cdf_txb_skip[t][c], &T.txb_skip[((qctx * 5 + t) * 13 + c) * 3], 2);
    const std::vector<uint16_t>* eob_tabs[7] = {
        &T.eob_pt16, &T.eob_pt32, &T.eob_pt64, &T.eob_pt128,
        &T.eob_pt256, &T.eob_pt512, &T.eob_pt1024};
    for (int k = 0; k < 7; k++) {
      int stride = 5 + k + 1;  // nsym + 1
      for (int p = 0; p < 2; p++)
        load_row(cdf_eob_pt[k][p],
                 &(*eob_tabs[k])[((qctx * 2 + p) * 2 + 0) * stride], 5 + k);
    }
    for (int t = 0; t < 5; t++)
      for (int p = 0; p < 2; p++) {
        for (int c = 0; c < 9; c++)
          load_row(cdf_eob_extra[t][p][c],
                   &T.eob_extra[(((qctx * 5 + t) * 2 + p) * 9 + c) * 3], 2);
        for (int c = 0; c < 42; c++)
          load_row(cdf_base[t][p][c],
                   &T.base[(((qctx * 5 + t) * 2 + p) * 42 + c) * 5], 4);
        for (int c = 0; c < 4; c++)
          load_row(cdf_base_eob[t][p][c],
                   &T.base_eob[(((qctx * 5 + t) * 2 + p) * 4 + c) * 4], 3);
        for (int c = 0; c < 21; c++)
          load_row(cdf_br[t][p][c],
                   &T.br[(((qctx * 5 + t) * 2 + p) * 21 + c) * 5], 4);
      }
    for (int p = 0; p < 2; p++)
      for (int c = 0; c < 3; c++)
        load_row(cdf_dc_sign[p][c], &T.dc_sign[((qctx * 2 + p) * 3 + c) * 3], 2);
    for (int st = 0; st < 2; st++)
      for (int tsq = 0; tsq < 4; tsq++)
        for (int m = 0; m < 13; m++)
          load_row(cdf_ext_tx[st][tsq][m],
                   &T.intra_ext_tx[((st * 4 + tsq) * 13 + m) * 17],
                   st == 0 ? 7 : 5);
  }

  void code(CdfRow& row, int sym, int nsym) {
    enc.encode_symbol(sym, row.v, nsym);
    if (cdf_update) update_cdf(row, sym, nsym);
  }

  // ---- ops ----------------------------------------------------------------

  void clear_left() {
    std::memset(left_part.data(), 0, left_part.size());
    for (int p = 0; p < 3; p++)
      std::memset(left_ctx[p].data(), 0, left_ctx[p].size());
  }

  static int part_nsym(int bsl) { return bsl == 1 ? 4 : (bsl == 5 ? 8 : 10); }

  // -- loop restoration (read_lr_unit mirror, spec 5.11.58) ---------------
  static constexpr int WIENER_MIN[3] = {-5, -23, -17};
  static constexpr int WIENER_MAX[3] = {10, 8, 46};
  static constexpr int WIENER_K[3] = {1, 2, 3};
  int ref_wiener[3][2][3];
  int ref_sgr[3][2];

  void lr_init() {
    static const int mid[3] = {3, -7, 15};
    for (int pl = 0; pl < 3; pl++)
      for (int ps = 0; ps < 2; ps++)
        for (int j = 0; j < 3; j++) ref_wiener[pl][ps][j] = mid[j];
    for (int pl = 0; pl < 3; pl++) {  // Sgrproj_Xqd_Mid
      ref_sgr[pl][0] = -32;
      ref_sgr[pl][1] = 31;
    }
  }

  void ns_bool(int v, int n) {
    int w = bitlength((uint32_t)n);
    int m = (1 << w) - n;
    if (v < m) {
      enc.encode_literal((uint32_t)v, w - 1);
    } else {
      int x = v + m;
      enc.encode_literal((uint32_t)(x >> 1), w - 1);
      enc.encode_literal((uint32_t)(x & 1), 1);
    }
  }

  void subexp_bool(int v, int num_syms, int k) {
    int i = 0, mk = 0;
    for (;;) {
      int b2 = i ? k + i - 1 : k;
      int a = 1 << b2;
      if (num_syms <= mk + 3 * a) {
        ns_bool(v - mk, num_syms - mk);
        return;
      }
      if (v >= mk + a) {
        enc.encode_literal(1, 1);
        i++;
        mk += a;
      } else {
        enc.encode_literal(0, 1);
        enc.encode_literal((uint32_t)(v - mk), b2);
        return;
      }
    }
  }

  static int recenter(int r, int v) {
    if (v > 2 * r) return v;
    if (v >= r) return (v - r) * 2;
    return (r - v) * 2 - 1;
  }

  void signed_subexp_ref(int v, int low, int high, int k, int ref) {
    int x = v - low, r = ref - low, mx = high - low;
    if ((r << 1) <= mx) subexp_bool(recenter(r, x), mx, k);
    else subexp_bool(recenter(mx - 1 - r, mx - 1 - x), mx, k);
  }

  void wiener_taps(int plane, const int32_t* taps) {
    for (int ps = 0; ps < 2; ps++) {
      for (int j = plane ? 1 : 0; j < 3; j++) {
        int v = taps[ps * 3 + j];
        signed_subexp_ref(v, WIENER_MIN[j], WIENER_MAX[j] + 1, WIENER_K[j],
                          ref_wiener[plane][ps][j]);
        ref_wiener[plane][ps][j] = v;
      }
    }
  }

  void write_lr_unit(int plane, int use, const int32_t* taps) {
    if (ec_off) return;
    code(cdf_wiener, use ? 1 : 0, 2);
    if (!use) return;
    wiener_taps(plane, taps);
  }

  // read_sgrproj_filter mirror (after the restore decision). For a
  // zero-radius pass the decoder derives the new reference itself; the
  // caller passes those derived values in xqd0/xqd1.
  void sgr_params(int plane, int set, int xqd0, int xqd1) {
    static constexpr int XQD_MIN[2] = {-96, -32};
    static constexpr int XQD_MAX[2] = {31, 95};
    enc.encode_literal((uint32_t)set, 4);
    const int r0 = (set >= 10 && set <= 13) ? 0 : 2;
    const int r1 = (set >= 14) ? 0 : 1;
    const int xqd[2] = {xqd0, xqd1};
    const int rr[2] = {r0, r1};
    for (int i = 0; i < 2; i++) {
      if (rr[i])
        signed_subexp_ref(xqd[i], XQD_MIN[i], XQD_MAX[i] + 1, 4,
                          ref_sgr[plane][i]);
      ref_sgr[plane][i] = xqd[i];
    }
  }

  // Generic unit: frame_type 1 switchable / 2 wiener / 3 sgrproj;
  // use_type 0 none / 1 wiener / 2 sgrproj (spec read_lr_unit).
  void write_lr_generic(int plane, int frame_type, int use_type, int set,
                        int xqd0, int xqd1, const int32_t* taps) {
    if (ec_off) return;
    if (frame_type == 2) {
      code(cdf_wiener, use_type == 1 ? 1 : 0, 2);
    } else if (frame_type == 3) {
      code(cdf_sgrproj, use_type == 2 ? 1 : 0, 2);
    } else {
      code(cdf_switchable, use_type, 3);
    }
    if (use_type == 1) wiener_taps(plane, taps);
    else if (use_type == 2) sgr_params(plane, set, xqd0, xqd1);
  }

  void write_partition(int r, int c, int bsl, int part) {
    if (ec_off) return;
    int above = (above_part[c] >> (bsl - 1)) & 1;
    int left = (left_part[r] >> (bsl - 1)) & 1;
    int ctx = left * 2 + above;
    code(cdf_partition[(bsl - 1) * 4 + ctx], part, part_nsym(bsl));
  }

  void write_split_binary(int r, int c, int bsl, int horz, int split) {
    if (ec_off) return;
    int above = (above_part[c] >> (bsl - 1)) & 1;
    int left = (left_part[r] >> (bsl - 1)) & 1;
    int ctx = left * 2 + above;
    const CdfRow& row = cdf_partition[(bsl - 1) * 4 + ctx];
    int nsym = part_nsym(bsl);
    // gather_split_binary (symbols.py): subtract "alike" partition probs
    static const int horz_sub[6] = {2, 3, 4, 6, 7, 9};
    static const int vert_sub[6] = {1, 3, 4, 5, 6, 8};
    const int* sub = horz ? horz_sub : vert_sub;
    int nsub = (bsl != 5) ? 6 : 5;
    int p = 32768;
    for (int i = 0; i < nsub; i++) {
      int s = sub[i];
      if (s < nsym) {
        int hi = (s == 0) ? 32768 : row.v[s - 1];
        int lo = (s == nsym - 1) ? 0 : row.v[s];
        p -= hi - lo;
      }
    }
    enc.encode_symbol2(split, (uint32_t)(32768 - p));
  }

  void update_partition_ctx(int r, int c, int bw4, int bh4) {
    int wl = bitlength((uint32_t)bw4) - 1;
    int hl = bitlength((uint32_t)bh4) - 1;
    uint8_t av = (uint8_t)((0x1F << wl) & 0x1F);
    uint8_t lv = (uint8_t)((0x1F << hl) & 0x1F);
    for (int i = 0; i < bw4; i++) above_part[c + i] = av;
    for (int i = 0; i < bh4; i++) left_part[r + i] = lv;
  }

  // read_delta_qindex mirror (spec 5.11.34): 4-symbol abs (3 = escape to
  // a length-prefixed tail), then sign; CurrentQIndex steps by
  // delta << dq_res_log2 (caller guarantees divisibility).
  void write_delta_qindex(int target) {
    if (ec_off) return;
    int delta = (target - cur_qindex) >> dq_res_log2;
    int abs_ = delta < 0 ? -delta : delta;
    int small = abs_ < 3 ? abs_ : 3;
    code(cdf_delta_q, small, 4);
    if (small == 3) {
      int v = abs_ - 1;  // >= 2
      int rem = 0;
      while ((2 << rem) <= v) rem++;  // floor(log2 v) >= 1
      enc.encode_literal((uint32_t)(rem - 1), 3);
      enc.encode_literal((uint32_t)(v - (1 << rem)), rem);
    }
    if (abs_) enc.encode_literal(delta < 0 ? 1u : 0u, 1);
    cur_qindex += delta << dq_res_log2;
    if (cur_qindex < 1) cur_qindex = 1;
    if (cur_qindex > 255) cur_qindex = 255;
  }

  void write_block(int r, int c, int bw4, int bh4, int y_mode, int uv_mode,
                   int skip, int cfl_allowed, int y_delta, int uv_delta,
                   int cfl_signs = 0, int cfl_au = 0, int cfl_av = 0) {
    if (ec_off) return;
    // skip
    {
      int above = r > 0 ? skips[(size_t)(r - 1) * w4 + c] : 0;
      int left = c > 0 ? skips[(size_t)r * w4 + (c - 1)] : 0;
      code(cdf_skip[above + left], skip, 2);
    }
    // per-SB delta_q: coded in the first block's mode_info right after
    // skip, unless the block is superblock-sized AND skip (spec
    // read_delta_qindex's exemption — q then stays at CurrentQIndex)
    if (pending_qindex >= 0) {
      if (!(bw4 == 16 && bh4 == 16 && skip)) write_delta_qindex(pending_qindex);
      pending_qindex = -1;
    }
    // intra modes
    {
      int am = r > 0 ? y_modes[(size_t)(r - 1) * w4 + c] : DC_PRED;
      int lm = c > 0 ? y_modes[(size_t)r * w4 + (c - 1)] : DC_PRED;
      if (am < 0) am = DC_PRED;
      if (lm < 0) lm = DC_PRED;
      int actx = INTRA_MODE_CONTEXT[am];
      int lctx = INTRA_MODE_CONTEXT[lm];
      code(cdf_kf_y[actx * 5 + lctx], y_mode, 13);
      int mind = bw4 < bh4 ? bw4 : bh4;
      if (y_mode >= V_PRED && y_mode <= D67 && mind >= 2)
        code(cdf_angle[y_mode - V_PRED], y_delta + 3, 7);
      if (num_planes > 1) {
        code(cdf_uv[cfl_allowed][y_mode], uv_mode, cfl_allowed ? 14 : 13);
        if (uv_mode == 13) {  // UV_CFL_PRED: joint sign + per-plane alphas
          code(cdf_cfl_sign, cfl_signs, 8);
          const int sign_u = (cfl_signs + 1) / 3;
          const int sign_v = (cfl_signs + 1) % 3;
          if (sign_u != 0) code(cdf_cfl_alpha[cfl_signs - 2], cfl_au, 16);
          if (sign_v != 0)
            code(cdf_cfl_alpha[sign_v * 3 + sign_u - 3], cfl_av, 16);
        }
        if (uv_mode >= V_PRED && uv_mode <= D67 && mind >= 2)
          code(cdf_angle[uv_mode - V_PRED], uv_delta + 3, 7);
      }
    }
    // record + partition ctx + (skip) entropy ctx reset
    for (int i = 0; i < bh4; i++) {
      int16_t* ym = &y_modes[(size_t)(r + i) * w4 + c];
      uint8_t* sk = &skips[(size_t)(r + i) * w4 + c];
      for (int j = 0; j < bw4; j++) { ym[j] = (int16_t)y_mode; sk[j] = (uint8_t)skip; }
    }
    update_partition_ctx(r, c, bw4, bh4);
    if (skip) {
      for (int p = 0; p < num_planes; p++) {
        for (int i = 0; i < bw4; i++) above_ctx[p][c + i] = 0;
        for (int i = 0; i < bh4; i++) left_ctx[p][r + i] = 0;
      }
    }
  }

  int dc_sign_ctx(int plane, int c4, int bw4, int r4, int bh4) {
    int s = 0;
    for (int i = 0; i < bw4; i++) {
      int cat = above_ctx[plane][c4 + i] >> 6;
      s += cat == 2 ? 1 : (cat == 1 ? -1 : 0);
    }
    for (int i = 0; i < bh4; i++) {
      int cat = left_ctx[plane][r4 + i] >> 6;
      s += cat == 2 ? 1 : (cat == 1 ? -1 : 0);
    }
    return s > 0 ? 2 : (s < 0 ? 1 : 0);
  }

  void write_coeffs(int plane, int r4, int c4, int txw, int txh,
                    int eq_block, int ch, int cw, const int32_t* lv,
                    int y_mode, int v_adst, int h_adst) {
    if (ec_off) return;
#ifdef CAVIF_BP_PROF
    struct EcT { double t0 = bp_now();
                 ~EcT() { g_bpt[3] += bp_now() - t0; } } ect;
#endif
    int ptype = plane > 0 ? 1 : 0;
    int bw4 = txw >> 2;
    int bh4 = txh >> 2;
    // decoders clamp context *writes* to the tile mi bounds for blocks
    // overhanging the bottom/right edge (dav1d memsets with imin(txh,
    // bh-by)); reads then see zeros beyond the edge. Mirror exactly.
    int w4w = bw4 < (mi_w4 - c4) ? bw4 : (mi_w4 - c4);
    int h4w = bh4 < (mi_h4 - r4) ? bh4 : (mi_h4 - r4);
    int tctx = txsize_ctx(txw, txh);
    int sidx = size_idx(cw, ch);
    const int32_t* scan = g_tables.scan[sidx].data();
    const uint8_t* nzoff = g_tables.nzoff[sidx].data();
    int area = cw * ch;

    // eob from scan order
    int eob = 0;
    for (int i = area - 1; i >= 0; i--) {
      if (lv[scan[i]] != 0) { eob = i + 1; break; }
    }

    // txb_skip
    {
      int sctx;
      if (plane == 0) {
        if (eq_block) {
          sctx = 0;
        } else {
          int above = 0, left = 0;
          for (int i = 0; i < bw4; i++) {
            int v = above_ctx[0][c4 + i] & 63;
            if (v > above) above = v;
          }
          for (int i = 0; i < bh4; i++) {
            int v = left_ctx[0][r4 + i] & 63;
            if (v > left) left = v;
          }
          sctx = SKIP_CONTEXTS[above < 4 ? above : 4][left < 4 ? left : 4];
        }
      } else {
        int anz = 0, lnz = 0;
        for (int i = 0; i < bw4; i++) anz |= above_ctx[plane][c4 + i] != 0;
        for (int i = 0; i < bh4; i++) lnz |= left_ctx[plane][r4 + i] != 0;
        // chroma base offset 10 when the plane block exceeds the tx size
        // (libaom get_txb_skip_ctx) — 64px blocks with 32x32 chroma txbs
        sctx = (eq_block ? 7 : 10) + anz + lnz;
      }
      code(cdf_txb_skip[tctx][sctx], eob == 0 ? 1 : 0, 2);
    }
    if (eob == 0) {
      for (int i = 0; i < w4w; i++) above_ctx[plane][c4 + i] = 0;
      for (int i = 0; i < h4w; i++) left_ctx[plane][r4 + i] = 0;
      return;
    }

    // transform_type(): luma, tx sets 1/2 (sqr_up <= 16); symbol orders
    // per spec Tx_Type_Intra_Inv_Set1/2
    if (plane == 0 && (txw > txh ? txw : txh) <= 16) {
      int sqr = txw < txh ? txw : txh;
      int tx_sqr = bitlength((uint32_t)sqr) - 3;
      int set_idx = (reduced_tx_set || sqr == 16) ? 2 : 1;
      int sym;
      if (!v_adst && !h_adst) sym = 1;
      else if (v_adst && h_adst) sym = set_idx == 2 ? 2 : 4;
      else if (v_adst) sym = set_idx == 2 ? 3 : 5;
      else sym = set_idx == 2 ? 4 : 6;
      code(cdf_ext_tx[set_idx - 1][tx_sqr][y_mode], sym, set_idx == 1 ? 7 : 5);
    }

    // eob position class
    int eob_pt;
    if (eob == 1) eob_pt = 1;
    else if (eob == 2) eob_pt = 2;
    else eob_pt = bitlength((uint32_t)(eob - 1)) + 1;
    int kidx;  // area 16->0 ... 1024->6
    {
      int a = area; kidx = 0;
      while (a > 16) { a >>= 1; kidx++; }
    }
    code(cdf_eob_pt[kidx][ptype], eob_pt - 1, 5 + kidx);
    if (eob_pt >= 3) {
      int base_v = (1 << (eob_pt - 2)) + 1;
      int offset = eob - base_v;
      int msb = (offset >> (eob_pt - 3)) & 1;
      code(cdf_eob_extra[tctx][ptype][eob_pt - 3], msb, 2);
      for (int i = eob_pt - 4; i >= 0; i--)
        enc.encode_literal((uint32_t)(offset >> i) & 1, 1);
    }

    // level coding, reverse scan; pad = abs levels seen so far (clamped 127)
    int pstride = cw + 2;
    padbuf.assign((size_t)(ch + 2) * pstride, 0);
    int32_t* pad = padbuf.data();
    int brt = tctx < 3 ? tctx : 3;
    for (int si = eob - 1; si >= 0; si--) {
      int pos = scan[si];
      int row = pos / cw, col = pos % cw;
      int v = lv[pos];
      int a = v < 0 ? -v : v;
      if (si == eob - 1) {
        int ectx;
        if (si == 0) ectx = 0;
        else if (si <= area / 8) ectx = 1;
        else if (si <= area / 4) ectx = 2;
        else ectx = 3;
        int sym = (a < 3 ? a : 3) - 1;
        code(cdf_base_eob[tctx][ptype][ectx], sym, 3);
      } else {
        int p1 = pad[row * pstride + col + 1];
        int p2 = pad[(row + 1) * pstride + col];
        int p3 = pad[(row + 1) * pstride + col + 1];
        int p4 = pad[row * pstride + col + 2];
        int p5 = pad[(row + 2) * pstride + col];
        int mag = (p1 < 3 ? p1 : 3) + (p2 < 3 ? p2 : 3) + (p3 < 3 ? p3 : 3) +
                  (p4 < 3 ? p4 : 3) + (p5 < 3 ? p5 : 3);
        int mctx = (mag + 1) >> 1;
        if (mctx > 4) mctx = 4;
        int bctx = pos == 0 ? 0 : mctx + nzoff[row * cw + col];
        code(cdf_base[tctx][ptype][bctx], a < 3 ? a : 3, 4);
      }
      if (a > 2) {
        int p1 = pad[row * pstride + col + 1];
        int p2 = pad[(row + 1) * pstride + col];
        int p3 = pad[(row + 1) * pstride + col + 1];
        int magb = (p1 < 15 ? p1 : 15) + (p2 < 15 ? p2 : 15) + (p3 < 15 ? p3 : 15);
        int bmag = (magb + 1) >> 1;
        if (bmag > 6) bmag = 6;
        int brctx;
        if (pos == 0) brctx = bmag;
        else if (row < 2 && col < 2) brctx = bmag + 7;
        else brctx = bmag + 14;
        int rem = (a < 15 ? a : 15) - 3;
        for (int k = 0; k < 4; k++) {
          int sym = rem < 3 ? rem : 3;
          code(cdf_br[brt][ptype][brctx], sym, 4);
          rem -= sym;
          if (sym < 3) break;
        }
      }
      pad[row * pstride + col] = a < 127 ? a : 127;
    }

    // signs + golomb, forward scan
    int cul = 0;
    int dc_cat = 0;
    for (int si = 0; si < eob; si++) {
      int pos = scan[si];
      int v = lv[pos];
      int a = v < 0 ? -v : v;
      int sign = v < 0 ? 1 : 0;
      if (a != 0) {
        if (si == 0) {
          int dctx = dc_sign_ctx(plane, c4, bw4, r4, bh4);
          code(cdf_dc_sign[ptype][dctx], sign, 2);
          dc_cat = sign ? 1 : 2;
        } else {
          enc.encode_literal((uint32_t)sign, 1);
        }
      }
      if (a > 14) {
        uint32_t x = (uint32_t)(a - 14);
        int n = bitlength(x);
        for (int i = 0; i < n - 1; i++) enc.encode_literal(0, 1);
        enc.encode_literal(1, 1);
        for (int i = n - 2; i >= 0; i--)
          enc.encode_literal((x >> i) & 1, 1);
      }
      cul += a;
    }
    if (cul > 63) cul = 63;
    uint8_t packed = (uint8_t)(cul | (dc_cat << 6));
    for (int i = 0; i < w4w; i++) above_ctx[plane][c4 + i] = packed;
    for (int i = 0; i < h4w; i++) left_ctx[plane][r4 + i] = packed;
  }
};


// ---------------------------------------------------------------------------
// Exact integer inverse DCT (av1_inv_txfm1d structure, cos_bit 12).
// Encoder reconstruction must be BIT-EXACT with the decoder: any model error
// drifts through intra prediction chains. Butterfly structure is validated
// against the ideal DCT in av1/itx.py; rounding semantics here mirror
// libaom round_shift/half_btf; end-to-end exactness is tested against dav1d.
// ---------------------------------------------------------------------------

static inline int64_t rsh(int64_t v, int bit) {
  return (v + (1ll << (bit - 1))) >> bit;
}

static inline int64_t hbf(int64_t w0, int64_t x0, int64_t w1, int64_t x1) {
  return rsh(w0 * x0 + w1 * x1, 12);
}

static void iidct4(const int64_t* s, int64_t* out, const int32_t* c) {
  int64_t b0 = hbf(c[32], s[0], c[32], s[1]);
  int64_t b1 = hbf(c[32], s[0], -c[32], s[1]);
  int64_t b2 = hbf(c[48], s[2], -c[16], s[3]);
  int64_t b3 = hbf(c[16], s[2], c[48], s[3]);
  out[0] = b0 + b3; out[1] = b1 + b2; out[2] = b1 - b2; out[3] = b0 - b3;
}

static void iidct8(const int64_t* s, int64_t* out, const int32_t* c) {
  int64_t b4 = hbf(c[56], s[4], -c[8], s[7]);
  int64_t b5 = hbf(c[24], s[5], -c[40], s[6]);
  int64_t b6 = hbf(c[40], s[5], c[24], s[6]);
  int64_t b7 = hbf(c[8], s[4], c[56], s[7]);
  int64_t t[4];
  iidct4(s, t, c);
  int64_t c4 = b4 + b5, c5 = b4 - b5, c6 = -b6 + b7, c7 = b6 + b7;
  int64_t d5 = hbf(-c[32], c5, c[32], c6);
  int64_t d6 = hbf(c[32], c5, c[32], c6);
  out[0] = t[0] + c7; out[1] = t[1] + d6; out[2] = t[2] + d5; out[3] = t[3] + c4;
  out[4] = t[3] - c4; out[5] = t[2] - d5; out[6] = t[1] - d6; out[7] = t[0] - c7;
}

static void iidct16(const int64_t* s, int64_t* out, const int32_t* c) {
  int64_t b8 = hbf(c[60], s[8], -c[4], s[15]);
  int64_t b9 = hbf(c[28], s[9], -c[36], s[14]);
  int64_t b10 = hbf(c[44], s[10], -c[20], s[13]);
  int64_t b11 = hbf(c[12], s[11], -c[52], s[12]);
  int64_t b12 = hbf(c[52], s[11], c[12], s[12]);
  int64_t b13 = hbf(c[20], s[10], c[44], s[13]);
  int64_t b14 = hbf(c[36], s[9], c[28], s[14]);
  int64_t b15 = hbf(c[4], s[8], c[60], s[15]);
  int64_t t[8];
  iidct8(s, t, c);
  int64_t c8 = b8 + b9, c9 = b8 - b9, c10 = -b10 + b11, c11 = b10 + b11;
  int64_t c12 = b12 + b13, c13 = b12 - b13, c14 = -b14 + b15, c15 = b14 + b15;
  int64_t d9 = hbf(-c[16], c9, c[48], c14);
  int64_t d14 = hbf(c[48], c9, c[16], c14);
  int64_t d10 = hbf(-c[48], c10, -c[16], c13);
  int64_t d13 = hbf(-c[16], c10, c[48], c13);
  int64_t e8 = c8 + c11, e9 = d9 + d10, e10 = d9 - d10, e11 = c8 - c11;
  int64_t e12 = c15 - c12, e13 = d14 - d13, e14 = d14 + d13, e15 = c15 + c12;
  int64_t f10 = hbf(-c[32], e10, c[32], e13);
  int64_t f13 = hbf(c[32], e10, c[32], e13);
  int64_t f11 = hbf(-c[32], e11, c[32], e12);
  int64_t f12 = hbf(c[32], e11, c[32], e12);
  int64_t g[8] = {e8, e9, f10, f11, f12, f13, e14, e15};
  for (int i = 0; i < 8; i++) {
    out[i] = t[i] + g[7 - i];
    out[15 - i] = t[i] - g[7 - i];
  }
}

static void iidct32(const int64_t* s, int64_t* out, const int32_t* c) {
  int64_t b[16];
  b[0] = hbf(c[62], s[16], -c[2], s[31]);
  b[1] = hbf(c[30], s[17], -c[34], s[30]);
  b[2] = hbf(c[46], s[18], -c[18], s[29]);
  b[3] = hbf(c[14], s[19], -c[50], s[28]);
  b[4] = hbf(c[54], s[20], -c[10], s[27]);
  b[5] = hbf(c[22], s[21], -c[42], s[26]);
  b[6] = hbf(c[38], s[22], -c[26], s[25]);
  b[7] = hbf(c[6], s[23], -c[58], s[24]);
  b[8] = hbf(c[58], s[23], c[6], s[24]);
  b[9] = hbf(c[26], s[22], c[38], s[25]);
  b[10] = hbf(c[42], s[21], c[22], s[26]);
  b[11] = hbf(c[10], s[20], c[54], s[27]);
  b[12] = hbf(c[50], s[19], c[14], s[28]);
  b[13] = hbf(c[18], s[18], c[46], s[29]);
  b[14] = hbf(c[34], s[17], c[30], s[30]);
  b[15] = hbf(c[2], s[16], c[62], s[31]);
  int64_t t[16];
  iidct16(s, t, c);
  int64_t c16 = b[0] + b[1], c17 = b[0] - b[1];
  int64_t c18 = -b[2] + b[3], c19 = b[2] + b[3];
  int64_t c20 = b[4] + b[5], c21 = b[4] - b[5];
  int64_t c22 = -b[6] + b[7], c23 = b[6] + b[7];
  int64_t c24 = b[8] + b[9], c25 = b[8] - b[9];
  int64_t c26 = -b[10] + b[11], c27 = b[10] + b[11];
  int64_t c28 = b[12] + b[13], c29 = b[12] - b[13];
  int64_t c30 = -b[14] + b[15], c31 = b[14] + b[15];
  int64_t d17 = hbf(-c[8], c17, c[56], c30);
  int64_t d30 = hbf(c[56], c17, c[8], c30);
  int64_t d18 = hbf(-c[56], c18, -c[8], c29);
  int64_t d29 = hbf(-c[8], c18, c[56], c29);
  int64_t d21 = hbf(-c[40], c21, c[24], c26);
  int64_t d26 = hbf(c[24], c21, c[40], c26);
  int64_t d22 = hbf(-c[24], c22, -c[40], c25);
  int64_t d25 = hbf(-c[40], c22, c[24], c25);
  int64_t e16 = c16 + c19, e17 = d17 + d18, e18 = d17 - d18, e19 = c16 - c19;
  int64_t e20 = c23 - c20, e21 = d22 - d21, e22 = d22 + d21, e23 = c23 + c20;
  int64_t e24 = c24 + c27, e25 = d25 + d26, e26 = d25 - d26, e27 = c24 - c27;
  int64_t e28 = c31 - c28, e29 = d30 - d29, e30 = d30 + d29, e31 = c31 + c28;
  int64_t f18 = hbf(-c[16], e18, c[48], e29);
  int64_t f29 = hbf(c[48], e18, c[16], e29);
  int64_t f19 = hbf(-c[16], e19, c[48], e28);
  int64_t f28 = hbf(c[48], e19, c[16], e28);
  int64_t f20 = hbf(-c[48], e20, -c[16], e27);
  int64_t f27 = hbf(-c[16], e20, c[48], e27);
  int64_t f21 = hbf(-c[48], e21, -c[16], e26);
  int64_t f26 = hbf(-c[16], e21, c[48], e26);
  int64_t g16 = e16 + e23, g17 = e17 + e22, g18 = f18 + f21, g19 = f19 + f20;
  int64_t g20 = f19 - f20, g21 = f18 - f21, g22 = e17 - e22, g23 = e16 - e23;
  int64_t g24 = e31 - e24, g25 = e30 - e25, g26 = f29 - f26, g27 = f28 - f27;
  int64_t g28 = f28 + f27, g29 = f29 + f26, g30 = e30 + e25, g31 = e31 + e24;
  int64_t h20 = hbf(-c[32], g20, c[32], g27);
  int64_t h27 = hbf(c[32], g20, c[32], g27);
  int64_t h21 = hbf(-c[32], g21, c[32], g26);
  int64_t h26 = hbf(c[32], g21, c[32], g26);
  int64_t h22 = hbf(-c[32], g22, c[32], g25);
  int64_t h25 = hbf(c[32], g22, c[32], g25);
  int64_t h23 = hbf(-c[32], g23, c[32], g24);
  int64_t h24 = hbf(c[32], g23, c[32], g24);
  int64_t g[16] = {g16, g17, g18, g19, h20, h21, h22, h23,
                   h24, h25, h26, h27, g28, g29, g30, g31};
  for (int i = 0; i < 16; i++) {
    out[i] = t[i] + g[15 - i];
    out[31 - i] = t[i] - g[15 - i];
  }
}

// input reorder (even/odd recursive split; odd part in AV1 order)
static void reorder_for_idct(const int64_t* in, int64_t* out, int n) {
  static const int ro4[4] = {0, 2, 1, 3};
  static const int ro8[8] = {0, 4, 2, 6, 1, 5, 3, 7};
  static const int ro16[16] = {0, 8, 4, 12, 2, 10, 6, 14,
                               1, 9, 5, 13, 3, 11, 7, 15};
  static const int ro32[32] = {0, 16, 8, 24, 4, 20, 12, 28,
                               2, 18, 10, 26, 6, 22, 14, 30,
                               1, 17, 9, 25, 5, 21, 13, 29,
                               3, 19, 11, 27, 7, 23, 15, 31};
  const int* ro = n == 4 ? ro4 : n == 8 ? ro8 : n == 16 ? ro16 : ro32;
  for (int i = 0; i < n; i++) out[i] = in[ro[i]];
}

// 64-point inverse DCT: the same recursive stage network the explicit
// iidct8/16/32 above instantiate, one level deeper (even half = iidct32;
// the 32-lane odd part runs cross-middle hbf rotations with bit-reversed
// odd cospi angles, then alternating-sign add/sub merges). Mirrors
// av1/itx.py _idct_generic, which is pinned equal to the explicit 8/16/32
// networks in tests; decoder-exactness of this integer form is pinned
// end-to-end (libaom+dav1d recon equality, tests/test_tx64.py).
static int brev_k(int x, int bits) {
  int out = 0;
  for (int i = 0; i < bits; i++) { out = (out << 1) | (x & 1); x >>= 1; }
  return out;
}

static void iidct_generic(const int64_t* s, int64_t* out, int n,
                          const int32_t* c) {
  if (n == 4) { iidct4(s, out, c); return; }
  const int m = n / 2;
  int64_t t[32], x[32], nx[32];
  iidct_generic(s, t, m, c);
  for (int i = 0; i < m; i++) x[i] = s[m + i];
  // stage b: cross-middle rotations, angles = bit-reversed odds * (64/n);
  // the odd input order has m entries, so the reversal width is log2(m)
  const int scale = 64 / n;
  int obits = 0;
  while ((1 << obits) < m) obits++;
  for (int p = 0; p < m / 2; p++) {
    int q = (1 + 2 * brev_k(p, obits)) * scale;
    int64_t a0 = x[p], a1 = x[m - 1 - p];
    nx[p] = hbf(c[64 - q], a0, -c[q], a1);
    nx[m - 1 - p] = hbf(c[q], a0, c[64 - q], a1);
  }
  // stage c: add/sub pairs, sign pattern alternating by pair parity
  for (int k = 0; k < m / 2; k++) {
    int64_t a0 = nx[2 * k], a1 = nx[2 * k + 1];
    if (k % 2 == 0) { x[2 * k] = a0 + a1; x[2 * k + 1] = a0 - a1; }
    else { x[2 * k] = a1 - a0; x[2 * k + 1] = a1 + a0; }
  }
  // merge levels: rotation on the middle half of each 2g-block, then
  // add/sub within the doubled groups (final level: the cross-merge below
  // is its add/sub)
  for (int g = 2; g <= m / 2; g *= 2) {
    const int G = 2 * g;
    const int amul = 64 * g / m;
    int blocks = m / (2 * G);
    int bbits = 0;
    while ((1 << bbits) < blocks) bbits++;
    for (int i = 0; i < m; i++) nx[i] = x[i];
    for (int p = 0; p < m / 2; p++) {
      int pm = p % G;
      if (pm < G / 4 || pm >= 3 * G / 4) continue;
      int j = m - 1 - p;
      int a = amul * (1 + 4 * brev_k(p / G, bbits));
      if (pm < G / 2) {
        nx[p] = hbf(-c[a], x[p], c[64 - a], x[j]);
        nx[j] = hbf(c[64 - a], x[p], c[a], x[j]);
      } else {
        nx[p] = hbf(-c[64 - a], x[p], -c[a], x[j]);
        nx[j] = hbf(-c[a], x[p], c[64 - a], x[j]);
      }
    }
    if (G < m) {
      for (int base = 0; base < m; base += G) {
        int odd_grp = (base / G) & 1;
        for (int i = 0; i < G / 2; i++) {
          int64_t lo = nx[base + i], hi = nx[base + G - 1 - i];
          if (!odd_grp) { x[base + i] = lo + hi; x[base + G - 1 - i] = lo - hi; }
          else { x[base + i] = hi - lo; x[base + G - 1 - i] = hi + lo; }
        }
      }
    } else {
      for (int i = 0; i < m; i++) x[i] = nx[i];
    }
  }
  for (int i = 0; i < m; i++) {
    out[i] = t[i] + x[m - 1 - i];
    out[n - 1 - i] = t[i] - x[m - 1 - i];
  }
}

static void idct_1d(const int64_t* in, int64_t* out, int n, const int32_t* c) {
  int64_t s[64];
  if (n == 64) {
    // reorder: even lanes follow the 32-pt order doubled; odd lanes in
    // bit-reversed odd order
    int64_t ev[32];
    for (int i = 0; i < 32; i++) ev[i] = in[2 * i];
    reorder_for_idct(ev, s, 32);
    for (int i = 0; i < 32; i++) {
      int brv = 0, v = i;
      for (int b = 0; b < 5; b++) { brv = (brv << 1) | (v & 1); v >>= 1; }
      s[32 + i] = in[1 + 2 * brv];
    }
    iidct_generic(s, out, 64, c);
    return;
  }
  reorder_for_idct(in, s, n);
  if (n == 4) iidct4(s, out, c);
  else if (n == 8) iidct8(s, out, c);
  else if (n == 16) iidct16(s, out, c);
  else iidct32(s, out, c);
}


// ---- exact integer inverse ADST (av1_iadst4/8/16_c structure) ----

static void iiadst4(const int64_t* x, int64_t* out, const int32_t* sp) {
  int64_t s0 = (int64_t)sp[1] * x[0];
  int64_t s1 = (int64_t)sp[2] * x[0];
  int64_t s2 = (int64_t)sp[3] * x[1];
  int64_t s3 = (int64_t)sp[4] * x[2];
  int64_t s4 = (int64_t)sp[1] * x[2];
  int64_t s5 = (int64_t)sp[2] * x[3];
  int64_t s6 = (int64_t)sp[4] * x[3];
  int64_t s7 = (x[0] - x[2]) + x[3];
  s0 = s0 + s3;
  s1 = s1 - s4;
  s3 = s2;
  s2 = (int64_t)sp[3] * s7;
  s0 = s0 + s5;
  s1 = s1 - s6;
  out[0] = rsh(s0 + s3, 12);
  out[1] = rsh(s1 + s3, 12);
  out[2] = rsh(s2, 12);
  out[3] = rsh((s0 + s1) - s3, 12);
}

static void iiadst8(const int64_t* x, int64_t* out, const int32_t* c) {
  int64_t b[8] = {x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]};
  int64_t s[8] = {
      hbf(c[4], b[0], c[60], b[1]),  hbf(c[60], b[0], -c[4], b[1]),
      hbf(c[20], b[2], c[44], b[3]), hbf(c[44], b[2], -c[20], b[3]),
      hbf(c[36], b[4], c[28], b[5]), hbf(c[28], b[4], -c[36], b[5]),
      hbf(c[52], b[6], c[12], b[7]), hbf(c[12], b[6], -c[52], b[7]),
  };
  int64_t t[8] = {s[0] + s[4], s[1] + s[5], s[2] + s[6], s[3] + s[7],
                  s[0] - s[4], s[1] - s[5], s[2] - s[6], s[3] - s[7]};
  int64_t u[8] = {t[0], t[1], t[2], t[3],
                  hbf(c[16], t[4], c[48], t[5]),
                  hbf(c[48], t[4], -c[16], t[5]),
                  hbf(-c[48], t[6], c[16], t[7]),
                  hbf(c[16], t[6], c[48], t[7])};
  int64_t v[8] = {u[0] + u[2], u[1] + u[3], u[0] - u[2], u[1] - u[3],
                  u[4] + u[6], u[5] + u[7], u[4] - u[6], u[5] - u[7]};
  int64_t w[8] = {v[0], v[1],
                  hbf(c[32], v[2], c[32], v[3]),
                  hbf(c[32], v[2], -c[32], v[3]),
                  v[4], v[5],
                  hbf(c[32], v[6], c[32], v[7]),
                  hbf(c[32], v[6], -c[32], v[7])};
  out[0] = w[0]; out[1] = -w[4]; out[2] = w[6]; out[3] = -w[2];
  out[4] = w[3]; out[5] = -w[7]; out[6] = w[5]; out[7] = -w[1];
}

static void iiadst16(const int64_t* x, int64_t* out, const int32_t* c) {
  int64_t b[16] = {x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6],
                   x[7], x[8], x[5], x[10], x[3], x[12], x[1], x[14]};
  int64_t s[16] = {
      hbf(c[2], b[0], c[62], b[1]),   hbf(c[62], b[0], -c[2], b[1]),
      hbf(c[10], b[2], c[54], b[3]),  hbf(c[54], b[2], -c[10], b[3]),
      hbf(c[18], b[4], c[46], b[5]),  hbf(c[46], b[4], -c[18], b[5]),
      hbf(c[26], b[6], c[38], b[7]),  hbf(c[38], b[6], -c[26], b[7]),
      hbf(c[34], b[8], c[30], b[9]),  hbf(c[30], b[8], -c[34], b[9]),
      hbf(c[42], b[10], c[22], b[11]), hbf(c[22], b[10], -c[42], b[11]),
      hbf(c[50], b[12], c[14], b[13]), hbf(c[14], b[12], -c[50], b[13]),
      hbf(c[58], b[14], c[6], b[15]),  hbf(c[6], b[14], -c[58], b[15]),
  };
  int64_t t[16];
  for (int i = 0; i < 8; i++) { t[i] = s[i] + s[i + 8]; t[i + 8] = s[i] - s[i + 8]; }
  int64_t u[16];
  for (int i = 0; i < 8; i++) u[i] = t[i];
  u[8] = hbf(c[8], t[8], c[56], t[9]);
  u[9] = hbf(c[56], t[8], -c[8], t[9]);
  u[10] = hbf(c[40], t[10], c[24], t[11]);
  u[11] = hbf(c[24], t[10], -c[40], t[11]);
  u[12] = hbf(-c[56], t[12], c[8], t[13]);
  u[13] = hbf(c[8], t[12], c[56], t[13]);
  u[14] = hbf(-c[24], t[14], c[40], t[15]);
  u[15] = hbf(c[40], t[14], c[24], t[15]);
  int64_t v[16];
  for (int i = 0; i < 4; i++) { v[i] = u[i] + u[i + 4]; v[i + 4] = u[i] - u[i + 4]; }
  for (int i = 0; i < 4; i++) { v[8 + i] = u[8 + i] + u[12 + i]; v[12 + i] = u[8 + i] - u[12 + i]; }
  int64_t w[16];
  for (int i = 0; i < 16; i++) w[i] = v[i];
  w[4] = hbf(c[16], v[4], c[48], v[5]);
  w[5] = hbf(c[48], v[4], -c[16], v[5]);
  w[6] = hbf(-c[48], v[6], c[16], v[7]);
  w[7] = hbf(c[16], v[6], c[48], v[7]);
  w[12] = hbf(c[16], v[12], c[48], v[13]);
  w[13] = hbf(c[48], v[12], -c[16], v[13]);
  w[14] = hbf(-c[48], v[14], c[16], v[15]);
  w[15] = hbf(c[16], v[14], c[48], v[15]);
  int64_t y[16];
  for (int g = 0; g < 4; g++) {
    int o = g * 4;
    y[o + 0] = w[o + 0] + w[o + 2];
    y[o + 1] = w[o + 1] + w[o + 3];
    y[o + 2] = w[o + 0] - w[o + 2];
    y[o + 3] = w[o + 1] - w[o + 3];
  }
  int64_t z[16];
  for (int i = 0; i < 16; i++) z[i] = y[i];
  for (int k = 2; k < 16; k += 4) {
    z[k] = hbf(c[32], y[k], c[32], y[k + 1]);
    z[k + 1] = hbf(c[32], y[k], -c[32], y[k + 1]);
  }
  out[0] = z[0];  out[1] = -z[8];  out[2] = z[12]; out[3] = -z[4];
  out[4] = z[6];  out[5] = -z[14]; out[6] = z[10]; out[7] = -z[2];
  out[8] = z[3];  out[9] = -z[11]; out[10] = z[15]; out[11] = -z[7];
  out[12] = z[5]; out[13] = -z[13]; out[14] = z[9]; out[15] = -z[1];
}

// sinpi table (bit 12) installed with cospi
static std::vector<int32_t> g_sinpi;
// forward ADST matrices per size (rows = basis functions), from itx.py
static std::vector<double> g_fwd_adst[3];  // 4, 8, 16

static void itx_1d(const int64_t* in, int64_t* out, int n, int is_adst,
                   const int32_t* c) {
  if (!is_adst) { idct_1d(in, out, n, c); return; }
  if (n == 4) { iiadst4(in, out, g_sinpi.data()); return; }
  if (n == 8) { iiadst8(in, out, c); return; }
  iiadst16(in, out, c);
}

// Per-tx-size decoder gain relative to the orthonormal idct: exactly 1/8
// for EVERY size (dav1d-validated roundtrip through inv_txfm_exact,
// tests/test_recon_exact.py). An earlier calibration wrongly doubled
// TX_8X4/TX_4X8, silently halving their coded residuals.
static inline double tx_gain_factor(int txw, int txh) {
  (void)txw;
  (void)txh;
  return 1.0;
}

// Debug tripwire for the deliberately-omitted spec 7.13.3 intermediate
// clamps (see the NOTE below): with CAVIF_TPU_ITX_CLAMP_CHECK set, every
// dequanted value and row-pass output is range-checked against the
// signed (BitDepth+8)-bit window the decoders clip to, and violations
// are counted instead of silently diverging from real decoders. The
// count is readable/resettable via tc_itx_clamp_violations (ADVICE r04:
// a future path driving intermediates out of range must surface in CI,
// not as silent quality drift).
static std::atomic<long long> g_itx_range_hits{0};
static std::atomic<int> g_itx_check{-1};
static inline bool itx_check_on() {
  int v = g_itx_check.load(std::memory_order_relaxed);
  if (v < 0) {
    const char* e = getenv("CAVIF_TPU_ITX_CLAMP_CHECK");
    v = (e && *e && strcmp(e, "0") != 0) ? 1 : 0;
    g_itx_check.store(v, std::memory_order_relaxed);
  }
  return v == 1;
}
static inline void itx_range_count(const int64_t* v, int n, int bit_depth) {
  int64_t hi = ((int64_t)1 << (bit_depth + 7)) - 1, lo = -hi - 1;
  long long bad = 0;
  for (int i = 0; i < n; i++)
    if (v[i] < lo || v[i] > hi) bad++;
  if (bad) g_itx_range_hits.fetch_add(bad, std::memory_order_relaxed);
}

// Full exact inverse: dequant + rect scale + row pass + col pass.
// levels: (ch x cw) coded area of a (txh x txw) transform; out: (txh x txw)
// residual values to add to prediction.
static void inv_txfm_exact(const int32_t* levels, int ch, int cw, int txw,
                           int txh, int dc_q, int ac_q, int bit_depth,
                           int v_adst, int h_adst, int32_t* out) {
  const int32_t* c = g_tables.cospi.data();
  int lw = bitlength((uint32_t)txw) - 1, lh = bitlength((uint32_t)txh) - 1;
  int mxd = txw > txh ? txw : txh;
  int tx_scale = mxd >= 64 ? 2 : (mxd >= 32 ? 1 : 0);
  int cf_max = (1 << (bit_depth + 7)) - 1;
  // shift pairs (after row pass, after col pass)
  int s0, s1 = 4;
  int mx = txw > txh ? txw : txh;
  if (mx <= 4) s0 = 0;
  else if ((txw == 8 && txh == 4) || (txw == 4 && txh == 8)) s0 = 0;
  else if (mx == 8) s0 = 1;
  else if (txw == txh && txw >= 16) s0 = 2;
  else if ((txw == 32 && txh == 16) || (txw == 16 && txh == 32) ||
           (txw == 16 && txh == 8) || (txw == 8 && txh == 16)) s0 = 1;
  else if ((txw == 32 && txh == 8) || (txw == 8 && txh == 32)) s0 = 2;
  else s0 = 1;
  bool rect = (lw - lh == 1) || (lh - lw == 1);

  static thread_local std::vector<int64_t> buf;
  buf.resize((size_t)txw * txh);
  // dequant into row-major (txh x txw)
  for (int y = 0; y < txh; y++)
    for (int x = 0; x < txw; x++) {
      int64_t v = 0;
      if (y < ch && x < cw) {
        int32_t lv = levels[y * cw + x];
        int q = (y == 0 && x == 0) ? dc_q : ac_q;
        int64_t a = (int64_t)(lv < 0 ? -lv : lv) * q;
        a >>= tx_scale;
        if (a > cf_max) a = cf_max;
        v = lv < 0 ? -a : a;
      }
      if (rect && v) v = rsh(v * 2896, 12);
      else if (rect) v = 0;
      buf[(size_t)y * txw + x] = v;
    }
  // NOTE on spec 7.13.3 intermediate clamping: the decoders clip
  // dequanted values and row-pass outputs to a signed (BitDepth+8)-bit
  // range. This mirror deliberately does NOT clamp — measured a no-op
  // on every stream the encoder emits (recon dav1d-bit-exact without
  // clamps, TX_64-rects included: conformance-bounded levels keep the
  // intermediates in range), and the device kernels
  // (ops/device_itx.py) pin equality against this function over
  // unconstrained stress inputs where a clamp WOULD diverge.
  if (itx_check_on()) itx_range_count(buf.data(), txw * txh, bit_depth);
  // row pass (horizontal transform)
  int64_t tmp[64], o[64];
  for (int y = 0; y < txh; y++) {
    itx_1d(&buf[(size_t)y * txw], o, txw, h_adst, c);
    for (int x = 0; x < txw; x++)
      buf[(size_t)y * txw + x] = s0 ? rsh(o[x], s0) : o[x];
  }
  if (itx_check_on()) itx_range_count(buf.data(), txw * txh, bit_depth);
  // col pass (vertical transform)
  for (int x = 0; x < txw; x++) {
    for (int y = 0; y < txh; y++) tmp[y] = buf[(size_t)y * txw + x];
    itx_1d(tmp, o, txh, v_adst, c);
    for (int y = 0; y < txh; y++)
      out[y * txw + x] = (int32_t)rsh(o[y], s1);
  }
}

// ---------------------------------------------------------------------------
// Block pipeline: intra predict + forward DCT + quantize + reconstruct.
// Mirrors av1/predict.py (bit-exact integer predictors) and av1/transforms.py
// (orthonormal float DCT with the calibrated decoder gain). Drives the
// TileCoder directly, so pass 2 of the encoder runs entirely native.
// ---------------------------------------------------------------------------

struct DctMatrix {
  int n = 0;
  std::vector<double> d;  // (n, n), rows = frequencies
};

const double PI = 3.14159265358979323846;

const DctMatrix& dct_matrix(int n) {
  static DctMatrix cache[8];
  int idx = bitlength((uint32_t)n) - 3;  // 4->0 .. 64->4
  DctMatrix& m = cache[idx];
  if (m.n != n) {
    m.n = n;
    m.d.resize((size_t)n * n);
    double s = std::sqrt(2.0 / n);
    for (int k = 0; k < n; k++)
      for (int j = 0; j < n; j++)
        m.d[(size_t)k * n + j] = s * std::cos(PI * (2 * j + 1) * k / (2 * n));
    double r = 1.0 / std::sqrt(2.0);
    for (int j = 0; j < n; j++) m.d[j] *= r;
  }
  return m;
}

// out = A(h x h) * X(h x w) * B(w x w)^T, all row-major doubles.
void mat_sandwich(const double* A, const double* X, const double* B, int h,
                  int w, double* tmp, double* out) {
  // tmp = A * X
  for (int i = 0; i < h; i++) {
    for (int j = 0; j < w; j++) tmp[(size_t)i * w + j] = 0.0;
    for (int k = 0; k < h; k++) {
      double a = A[(size_t)i * h + k];
      const double* xr = &X[(size_t)k * w];
      double* tr = &tmp[(size_t)i * w];
      for (int j = 0; j < w; j++) tr[j] += a * xr[j];
    }
  }
  // out = tmp * B^T  (out[i][j] = sum_k tmp[i][k] * B[j][k])
  for (int i = 0; i < h; i++) {
    const double* tr = &tmp[(size_t)i * w];
    double* orow = &out[(size_t)i * w];
    for (int j = 0; j < w; j++) {
      const double* br = &B[(size_t)j * w];
      double acc = 0.0;
      for (int k = 0; k < w; k++) acc += tr[k] * br[k];
      orow[j] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// Lee fast DCT (recursive even/odd split of the unnormalized DCT-II),
// applied along the ROW-index dimension of an (n, w) array so every
// butterfly operates on length-w lane vectors the compiler vectorizes.
// O(n log n) multiplies per column vs n^2 for the matrix product; exact to
// fp rounding vs dct_matrix (validated 1e-14 in f64). Twiddles
// 0.5/cos(pi(2i+1)/2n) are warmed at load (thread-safe for the search
// worker pool).
// ---------------------------------------------------------------------------

static std::vector<double> g_lee_tw[8];  // per n = 4 << idx, length n/2

const bool g_lee_warm = [] {
  for (int n : {2, 4, 8, 16, 32, 64}) {
    int idx = bitlength((uint32_t)n) - 1;  // 2->0, 4->1 .. 64->5
    std::vector<double>& tw = g_lee_tw[idx];
    tw.resize(n / 2);
    for (int i = 0; i < n / 2; i++)
      tw[i] = 0.5 / std::cos(PI * (2 * i + 1) / (2 * n));
  }
  return true;
}();

// x: (n, w) input, destroyed; y: (n, w) output; scratch: >= 2*n*w.
template <typename T>
static void lee_rec(int n, int w, T* x, T* y, T* scratch) {
  if (n == 1) {
    for (int j = 0; j < w; j++) y[j] = x[j];
    return;
  }
  int h = n / 2;
  const std::vector<double>& twd = g_lee_tw[bitlength((uint32_t)n) - 1];
  T* g = scratch;
  T* d = scratch + (size_t)h * w;
  for (int i = 0; i < h; i++) {
    const T* xa = &x[(size_t)i * w];
    const T* xb = &x[(size_t)(n - 1 - i) * w];
    T* gr = &g[(size_t)i * w];
    T* dr = &d[(size_t)i * w];
    T tw = (T)twd[i];
    for (int j = 0; j < w; j++) {
      T a = xa[j], b = xb[j];
      gr[j] = a + b;
      dr[j] = (a - b) * tw;
    }
  }
  T* G = x;
  T* D = x + (size_t)h * w;
  lee_rec(h, w, g, G, scratch + (size_t)n * w);
  lee_rec(h, w, d, D, scratch + (size_t)n * w);
  for (int k = 0; k < h; k++) {
    const T* Gr = &G[(size_t)k * w];
    T* yr = &y[(size_t)(2 * k) * w];
    for (int j = 0; j < w; j++) yr[j] = Gr[j];
  }
  for (int k = 0; k + 1 < h; k++) {
    const T* Da = &D[(size_t)k * w];
    const T* Db = &D[(size_t)(k + 1) * w];
    T* yr = &y[(size_t)(2 * k + 1) * w];
    for (int j = 0; j < w; j++) yr[j] = Da[j] + Db[j];
  }
  {
    const T* Dl = &D[(size_t)(h - 1) * w];
    T* yr = &y[(size_t)(n - 1) * w];
    for (int j = 0; j < w; j++) yr[j] = Dl[j];
  }
}

// 2-D DCT of res (h, w) -> out (w, h), TRANSPOSED and UNNORMALIZED: out
// holds D_w * (D_h * res)^T without the orthonormal sqrt(2/n)/sqrt(1/2)
// row scales (callers fold them into quantization). work: >= 3*h*w + the
// larger of (2*h*w, 2*w*h) recursion scratch => 5*h*w is always enough.
template <typename T>
static void fdct2d_lee(const T* res, int h, int w, T* out, T* work) {
  T* x = work;                      // (h, w) mutable copy
  T* t1 = work + (size_t)h * w;     // stage-1 output (h, w)
  T* scr = work + 2 * (size_t)h * w;
  for (int i = 0; i < h * w; i++) x[i] = res[i];
  lee_rec(h, w, x, t1, scr);
  // transpose t1 (h, w) -> x reused as (w, h)
  T* xt = work;
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) xt[(size_t)j * h + i] = t1[(size_t)i * w + j];
  lee_rec(w, h, xt, out, scr);
}

// AC quantizer deadzone (transforms.AC_BIAS); env override is A/B tooling.
static double ac_bias_env() {
  static double v = -1.0;
  if (v < 0.0) {
    const char* e = getenv("CAVIF_TPU_AC_BIAS");
    v = e ? atof(e) : 0.42;
  }
  return v;
}

// Magnitude-tiered AC bias: coefficients landing above CAVIF_TPU_AC_T
// (in level units) round with CAVIF_TPU_AC_BIAS_HI instead — the cheap
// form of trellis marginal-rate weighting (small levels cost more bits
// per step than large ones). Measured NEGATIVE on the BD corpus (best
// tiered variant ties flat 0.42 on SSIM and loses PSNR), so the defaults
// collapse to the flat bias; kept as A/B tooling. Closing the remaining
// BD-SSIM gap needs context-aware (CDF) coefficient rates — a trellis.
// Frequency-ramped AC bias amplitude (CAVIF_TPU_AC_BIAS_HF): added to the
// AC deadzone scaled by the coefficient's normalized frequency. 0 = off
// (flat deadzone, the shipped default).
static double ac_bias_hf_env() {
  static double v = -1.0;
  if (v < 0.0) {
    const char* e = getenv("CAVIF_TPU_AC_BIAS_HF");
    v = e ? atof(e) : 0.0;
  }
  return v;
}

static double ac_bias_hi_env() {
  static double v = -1.0;
  if (v < 0.0) {
    const char* e = getenv("CAVIF_TPU_AC_BIAS_HI");
    v = e ? atof(e) : ac_bias_env();
  }
  return v;
}
// CDF-derived bits to code |level| = l (AC; sign included; context-
// averaged default CDFs at qctx 3 — derivation in the round-2 log).
// Drives the EOB-cut rate model (eob_bits_env); the context-aware
// trellis below prices with the per-context tables instead.
static const double LEVEL_BITS[20] = {
    0.27, 3.87, 8.00, 11.39, 12.53, 13.49, 13.82, 14.96, 15.92, 16.24,
    17.38, 18.34, 18.66, 19.80, 20.76, 20.82, 22.82, 22.82, 24.82, 24.82};
static inline double level_bits(int l) {
  if (l < 20) return LEVEL_BITS[l];
  return 24.82 + 0.6 * (l - 19);
}
// EXPERIMENTAL (A/B tooling, default off): low-frequency protection for
// the trellis — scale the step-down threshold by si/(si+S) so early-scan
// (structure-carrying) coefficients are trimmed less and the tail more.
// SSIM's contrast/structure terms punish the systematic variance
// shrinkage of level-down moves; PSNR does not (tools/ssim_probe.py).
static double trellis_lf_env() {
  static double v = -1.0;
  if (v < 0.0) {
    const char* e = getenv("CAVIF_TPU_TRELLIS_LF");
    v = e ? atof(e) : 0.0;
  }
  return v;
}

// RD-justified UP-steps — undo the AC deadzone where the distortion
// drop of |level|+1 beats its context-priced rate (the deadzone floor
// leaves frac in (0.5, 1-bias) rounded down regardless of how cheap the
// extra level is locally). Default 1.0 since r05: with the ADAPTIVE
// CDF rates the up-steps are priced correctly and measure positive on
// both tunes (psnr +0.271 -> +0.285 dB at BD-rate -0.1 -> -0.3%; ssim
// +0.236 -> +0.240 / -0.00080 -> -0.00078); with the frame-initial
// tables they were mispriced and previously measured negative.
static double trellis_up_env() {
  // re-read per call (tests flip it per case); callers hoist to one
  // read per transform block so the coefficient loops stay getenv-free
  const char* e = getenv("CAVIF_TPU_TRELLIS_UP");
  return e ? atof(e) : 1.0;
}

// Quality ramp for the trellis strength: the high-rate probe
// (tools/ssim_probe.py) measured the trellis NEGATIVE on BOTH axes at
// high quality (base_q <= ~80: -0.04 dB PSNR and -0.0007 SSIM at matched
// rate) while positive for PSNR at mid rates — so the strength ramps
// from 0 at base_q <= Q0 to full at base_q >= Q1. Env knobs are
// calibration tooling (python _trellis_ramp mirrors exactly).
static double trellis_ramp(int base_q) {
  static double q0 = -1.0, q1 = -1.0;
  if (q0 < 0.0) {
    const char* e0 = getenv("CAVIF_TPU_TRELLIS_Q0");
    const char* e1 = getenv("CAVIF_TPU_TRELLIS_Q1");
    q0 = e0 ? atof(e0) : 80.0;
    q1 = e1 ? atof(e1) : 121.0;
  }
  if (q1 <= q0) return 1.0;
  double t = ((double)base_q - q0) / (q1 - q0);
  return t < 0.0 ? 0.0 : (t > 1.0 ? 1.0 : t);
}

// Context-aware trellis strength: lambda multiplier per CDF bit
// (0 = off). Unlike the removed context-FREE variant (which priced
// every reduction with the averaged LEVEL_BITS and measured negative:
// it over-reduces clustered coefficients whose real contexts are cheap
// and under-reduces isolated ones), this pass prices each |level| step
// with the REAL coding contexts — base/base_eob ctx from the
// already-decided reverse-scan neighbors, br rounds, golomb tail and
// the sign bit — using the uploaded trellis_* cost tables (the same
// default CDFs the range coder initializes with). Default 1.2 = the
// BD-corpus knee (tools/trellis_sweep.py): photo/bench1024 — the two
// images that trailed libaom-s6 — flip BD-PSNR positive (-0.014/-0.018
// -> +0.010/+0.009 dB) at ~flat mean BD-SSIM; every corpus image is
// then BD-PSNR-positive. Stronger keeps buying PSNR on those images
// but BD-SSIM falls off fast (-0.0041 at 1.6, -0.0056 at 2.4).
static double trellis_ctx_env() {
  // default 0.9 = the r05 knee with ADAPTIVE rates (dense BD, device
  // path): 0.9 dominates {0.6, 0.75, 1.2, 1.6} on both axes at both
  // tunes (psnr +0.271 dB / -0.00117); 1.2 was the knee for the
  // frame-initial tables, whose mispriced steps needed a stronger
  // multiplier to trim the same coefficients.
  const char* e = getenv("CAVIF_TPU_TRELLIS_CTX");
  return e ? atof(e) : 0.9;
}

static inline int bitlen_u32(uint32_t x);

// Adaptive-CDF trellis rates (CAVIF_TPU_TRELLIS_ADAPT, default 1): the
// trellis prices each |level| step from LIVE mirrors of the tile's
// coefficient CDFs (base/base_eob/br), initialized from the same
// per-qctx defaults the TileCoder loads and advanced with the exact
// spec update_cdf as each txb's FINAL levels are counted in coding
// order. The static trellis_* tables price every block with the
// frame-initial distributions; on real content the CDFs adapt sharply
// within the first superblock rows, so frame-initial prices
// systematically mis-rank level steps (VERDICT r05 next-2: the
// residual BD-SSIM gap is coefficient-level coding efficiency).
// 0 = frame-initial tables (the r04 behavior).
static int trellis_adapt_env() {
  // re-read per call (cheap): tests flip it per case, and a static
  // cache would freeze whichever value the first encode saw
  const char* e = getenv("CAVIF_TPU_TRELLIS_ADAPT");
  return e ? atoi(e) : 1;
}

// symbol cost in 1/128-bit units from a live CDF row (same formula as
// tables.trellis_cost: round((15 - log2(p)) * 128)). The cost of every
// possible probability is a 64 KB table filled once with the exact
// formula — the trellis inner loops call this several times per
// coefficient and the log2+lrint pair was measurable there.
static const uint16_t* acdf_cost_table() {
  static uint16_t tab[32769];
  static std::once_flag once;
  std::call_once(once, [] {
    tab[0] = tab[1] = (uint16_t)lrint(15.0 * 128.0);
    for (int p = 2; p <= 32768; p++)
      tab[p] = (uint16_t)lrint((15.0 - log2((double)p)) * 128.0);
  });
  return tab;
}

static inline int acdf_cost(const CdfRow& r, int sym, int nsym) {
  int hi = sym == 0 ? 32768 : (int)r.v[sym - 1];
  int lo = sym == nsym - 1 ? 0 : (int)r.v[sym];
  int p = hi - lo;
  if (p < 1) p = 1;
  return (int)acdf_cost_table()[p];
}

// Bits (1/128 units) to code |level| = L in fixed contexts: base symbol
// (base_eob row at the eob-1 position, base row otherwise), up to 4
// coeff_br rounds past level 2, golomb tail past 14, plus 1 bit of sign
// (dc_sign is ~uniform). Mirrored exactly by encoder._trellis_cost_level.
static inline int trellis_cost_level(int L, bool is_eob,
                                     const uint16_t* baserow,
                                     const uint16_t* brrow) {
  if (L == 0) return is_eob ? 0 : (int)baserow[0];
  int c = is_eob ? (int)baserow[(L < 3 ? L : 3) - 1]
                 : (int)baserow[L < 3 ? L : 3];
  c += 128;  // sign bit
  if (L > 2) {
    int rem = (L < 15 ? L : 15) - 3;
    for (int r = 0; r < 4; r++) {
      int sym = rem < 3 ? rem : 3;
      c += (int)brrow[sym];
      rem -= sym;
      if (sym < 3) break;
    }
    if (L > 14) {
      int n = bitlen_u32((uint32_t)(L - 14));
      c += 128 * (2 * n - 1);
    }
  }
  return c;
}

// live-CDF twin of trellis_cost_level
static inline int trellis_cost_level_a(int L, bool is_eob,
                                       const CdfRow& baser,
                                       const CdfRow& brr) {
  if (L == 0) return is_eob ? 0 : acdf_cost(baser, 0, 4);
  int c = is_eob ? acdf_cost(baser, (L < 3 ? L : 3) - 1, 3)
                 : acdf_cost(baser, L < 3 ? L : 3, 4);
  c += 128;  // sign bit
  if (L > 2) {
    int rem = (L < 15 ? L : 15) - 3;
    for (int r = 0; r < 4; r++) {
      int sym = rem < 3 ? rem : 3;
      c += acdf_cost(brr, sym, 4);
      rem -= sym;
      if (sym < 3) break;
    }
    if (L > 14) {
      int n = bitlen_u32((uint32_t)(L - 14));
      c += 128 * (2 * n - 1);
    }
  }
  return c;
}

static double ac_thresh_env() {
  static double v = -1.0;
  if (v < 0.0) {
    const char* e = getenv("CAVIF_TPU_AC_T");
    v = e ? atof(e) : 1e30;
  }
  return v;
}

// EOB-cut rate model: 0 = the |level|+2 proxy; > 0 = price the
// dropped tail with CDF-derived LEVEL_BITS plus the eob-position-class
// saving, scaled by this many proxy-units per bit (python _eob_optimize
// mirrors it bit-for-bit for the native/python contract). Default 1.2 =
// the BD-corpus knee: the gap images (photo/bench1024) gain on BOTH
// axes (BD-PSNR -0.040->-0.015 / -0.043->-0.018, BD-SSIM +0.0003 each)
// for a small give-back on the far-ahead smooth gradient; corpus mean
// BD-PSNR +0.336->+0.338, BD-SSIM -0.00368->-0.00355. 1.6 keeps buying
// PSNR but costs SSIM (photo -0.0073) — past the knee.
static double eob_bits_env() {
  static double v = -1.0;
  if (v < 0.0) {
    const char* e = getenv("CAVIF_TPU_EOB_BITS");
    v = e ? atof(e) : 1.2;
  }
  return v;
}

// Adaptive-CDF EOB-cut rate model (CAVIF_TPU_EOB_ADAPT, scale-per-bit
// like EOB_BITS; requires TRELLIS_ADAPT). Prices a tail cut with the
// LIVE mirrors instead of the static LEVEL_BITS model, and fixes three
// blind spots of the static model: (a) the zero coefficients inside
// the dropped tail each cost a base-0 symbol today — the cut drops
// them too, previously unpriced; (b) the new last coefficient switches
// from a base context to the (cheaper, 3-ary) base_eob context; (c)
// the eob position class change is priced from the live eob_pt /
// eob_extra rows rather than a flat 2 bits per class. The effective
// value is per-call config (tune-dependent: the accurate pricing cuts
// more tail, a BD-rate/BD-PSNR win that tune=ssim's headline axis does
// not want — see BASELINE.md r05 A/B); CAVIF_TPU_EOB_ADAPT overrides
// for sweeps, re-read per call so tests can flip it per case.
static double eob_adapt_env(double cfg) {
  const char* e = getenv("CAVIF_TPU_EOB_ADAPT");
  return e ? atof(e) : cfg;
}

static inline int bitlen_u32(uint32_t x) {
  int n = 0;
  while (x) { n++; x >>= 1; }
  return n;
}

// Mode_To_Txfm_Type: per intra mode, (vertical_adst, horizontal_adst);
// IDTX/flip types never arise for the derived chroma transform.
static const int MODE_V_ADST[13] = {0, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 1};
static const int MODE_H_ADST[13] = {0, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1};

struct BlockPipe {
  // adaptive-EOB cut scale (eob_adapt_env): per-call config from the
  // encoder (1.0 at tune=psnr, 0 at tune=ssim), env-overridable
  double eob_adapt_cfg = 1.0;
  int cfl_search = 0;
  int tx_exhaustive = 0;   // slow presets: RD over all 4 DCT/ADST combos
  int tx_override = -1;    // compute_txb: force (va | ha<<1) when >= 0
  const int32_t* src;  // (P, Hp, Wp) plane-major padded source
  int32_t* recon;      // same shape, scratch owned by caller or us
  std::vector<int32_t> recon_store;
  int P, Hp, Wp;
  int mi_rows, mi_cols;
  int mi_r0, mi_c0;  // tile origin (mi units)
  int mi_r1, mi_c1;  // tile end (mi units, clamped to frame)
  int bit_depth;
  int dc_q, ac_q;
  int qctx = 3;  // frame-level coefficient-CDF quality context (q_ctx)
  int frame_base_q = 255;  // frame base_q (trellis quality ramp)
  double gain;
  double lam = 0.0;  // RD weight for coefficient-tail optimization
  // per-SB psychovisual lambda multipliers for the coefficient-level
  // decisions (trellis + EOB cut): variance-weighted SSIM-like distortion
  // scaling, nullptr = flat. Indexed on the absolute 64px SB grid.
  const double* psy = nullptr;
  int psy_cols = 0;
  double psy_mul = 1.0;

  std::vector<double> fbuf, tbuf, cbuf, rbuf, wbuf;
  std::vector<int32_t> lvbuf;
  std::vector<int32_t> pred;

  // adaptive-CDF trellis mirrors (per tile, like the EC's CDF state;
  // see trellis_adapt_env). Counted on each txb's FINAL levels after
  // the EOB cut, so the mirrors track exactly the symbols the replay
  // coder will code.
  CdfRow acdf_base[5][2][42];
  CdfRow acdf_base_eob[5][2][4];
  CdfRow acdf_br[5][2][21];
  CdfRow acdf_eob_pt[7][2];        // [log2 area idx][ptype], ctx = 0
  CdfRow acdf_eob_extra[5][2][9];
  bool acdf_ready = false;

  void acdf_init() {
    SpecTables& T = g_tables;
    if (T.base.empty() || T.base_eob.empty() || T.br.empty()) return;
    const std::vector<uint16_t>* eob_tabs[7] = {
        &T.eob_pt16, &T.eob_pt32, &T.eob_pt64, &T.eob_pt128,
        &T.eob_pt256, &T.eob_pt512, &T.eob_pt1024};
    for (int k = 0; k < 7; k++) {
      if (eob_tabs[k]->empty()) return;
      int stride = 5 + k + 1;  // nsym + 1
      for (int p = 0; p < 2; p++)
        load_row(acdf_eob_pt[k][p],
                 &(*eob_tabs[k])[(((size_t)qctx * 2 + p) * 2 + 0) * stride],
                 5 + k);
    }
    if (T.eob_extra.empty()) return;
    for (int t = 0; t < 5; t++)
      for (int p = 0; p < 2; p++)
        for (int c = 0; c < 9; c++)
          load_row(acdf_eob_extra[t][p][c],
                   &T.eob_extra[((((size_t)qctx * 5 + t) * 2 + p) * 9 + c) * 3],
                   2);
    for (int t = 0; t < 5; t++)
      for (int p = 0; p < 2; p++) {
        for (int c = 0; c < 42; c++)
          load_row(acdf_base[t][p][c],
                   &T.base[(((size_t)qctx * 5 + t) * 2 + p) * 42 * 5
                           + (size_t)c * 5], 4);
        for (int c = 0; c < 4; c++)
          load_row(acdf_base_eob[t][p][c],
                   &T.base_eob[(((size_t)qctx * 5 + t) * 2 + p) * 4 * 4
                               + (size_t)c * 4], 3);
        for (int c = 0; c < 21; c++)
          load_row(acdf_br[t][p][c],
                   &T.br[(((size_t)qctx * 5 + t) * 2 + p) * 21 * 5
                         + (size_t)c * 5], 4);
      }
    acdf_ready = true;
  }

  // mirror write_coeffs' level-coding CDF updates on final levels
  void acdf_count(const int32_t* lv, int cw, int ch, int pl, int txw,
                  int txh) {
    int area = cw * ch;
    int sidx = size_idx(cw, ch);
    const int32_t* scan = g_tables.scan[sidx].data();
    const uint8_t* nzoff = g_tables.nzoff[sidx].data();
    int eob = 0;
    for (int i = area - 1; i >= 0; i--)
      if (lv[scan[i]] != 0) { eob = i + 1; break; }
    if (eob == 0) return;
    int tctx = txsize_ctx(txw, txh);
    int pt = pl > 0 ? 1 : 0;
    // mirror the EC's eob position-class updates (write_coeffs eob_pt /
    // eob_extra MSB; ctx = 0 slice, matching cdf_eob_pt)
    {
      int ept = eob == 1 ? 1
                : eob == 2 ? 2
                           : bitlen_u32((uint32_t)(eob - 1)) + 1;
      int kidx = 0;
      for (int a2 = area; a2 > 16; a2 >>= 1) kidx++;
      update_cdf(acdf_eob_pt[kidx][pt], ept - 1, 5 + kidx);
      if (ept >= 3) {
        int base_v = (1 << (ept - 2)) + 1;
        int msb = ((eob - base_v) >> (ept - 3)) & 1;
        update_cdf(acdf_eob_extra[tctx][pt][ept - 3], msb, 2);
      }
    }
    int brt = tctx < 3 ? tctx : 3;
    int pstride = cw + 2;
    int32_t pad[34 * 34];
    std::memset(pad, 0, sizeof(int32_t) * (size_t)(ch + 2) * pstride);
    for (int si = eob - 1; si >= 0; si--) {
      int pos = scan[si];
      int row = pos / cw, col = pos % cw;
      int v = lv[pos];
      int a = v < 0 ? -v : v;
      if (si == eob - 1) {
        int ectx = si == 0 ? 0
                   : si <= area / 8 ? 1
                   : si <= area / 4 ? 2 : 3;
        update_cdf(acdf_base_eob[tctx][pt][ectx], (a < 3 ? a : 3) - 1,
                   3);
      } else {
        int32_t* p0 = &pad[(size_t)row * pstride + col];
        int mag = (p0[1] < 3 ? p0[1] : 3) + (p0[pstride] < 3 ? p0[pstride] : 3)
                  + (p0[pstride + 1] < 3 ? p0[pstride + 1] : 3)
                  + (p0[2] < 3 ? p0[2] : 3)
                  + (p0[2 * pstride] < 3 ? p0[2 * pstride] : 3);
        int mctx = (mag + 1) >> 1;
        if (mctx > 4) mctx = 4;
        int bctx = pos == 0 ? 0 : mctx + (int)nzoff[pos];
        update_cdf(acdf_base[tctx][pt][bctx], a < 3 ? a : 3, 4);
      }
      if (a > 2) {
        int32_t* p0 = &pad[(size_t)row * pstride + col];
        int magb = (p0[1] < 15 ? p0[1] : 15)
                   + (p0[pstride] < 15 ? p0[pstride] : 15)
                   + (p0[pstride + 1] < 15 ? p0[pstride + 1] : 15);
        int bmag = (magb + 1) >> 1;
        if (bmag > 6) bmag = 6;
        int brctx = pos == 0 ? bmag
                    : (row < 2 && col < 2) ? bmag + 7 : bmag + 14;
        int rem = (a < 15 ? a : 15) - 3;
        for (int k = 0; k < 4; k++) {
          int sym = rem < 3 ? rem : 3;
          update_cdf(acdf_br[brt][pt][brctx], sym, 4);
          rem -= sym;
          if (sym < 3) break;
        }
      }
      pad[(size_t)row * pstride + col] = a < 127 ? a : 127;
    }
  }
  // Optional replay-stream recorder: the expanded op stream (concrete
  // OP_BLOCK/OP_COEFFS rows + levels) of this encode, so a later
  // re-serialization (output-filter parameter pass) re-runs ONLY the
  // entropy coder via tc_encode_tile instead of the whole pipeline.
  int32_t* rops = nullptr;
  int rops_cap = 0, rops_n = 0;
  int32_t* rlvl = nullptr;
  int rlvl_cap = 0, rlvl_n = 0;
  bool rec_overflow = false;

  void rec_row(const int32_t* row, int n) {
    if (!rops) return;
    if (rops_n + n > rops_cap) {
      rec_overflow = true;
      rops = nullptr;
      return;
    }
    std::memcpy(rops + rops_n, row, (size_t)n * 4);
    rops_n += n;
  }
  // BlockDecoded mirror for the current superblock, +1 offsets (18x18)
  uint8_t mask[18][18];
  int sb_r = 0, sb_c = 0;

  void reset_mask(int r, int c) {
    sb_r = r; sb_c = c;
    std::memset(mask, 0, sizeof(mask));
    // whole previous SB row is decoded (incl. above-right of the last
    // block column); left column from the previous SB
    for (int x = 0; x < 18; x++) mask[0][x] = 1;
    for (int y = 1; y < 17; y++) mask[y][0] = 1;
  }

  void init(const int32_t* s, int p, int hp, int wp, int mir, int mic,
            int r0, int c0, int r1, int c1, int bd, int dq, int aq,
            double g, double lam_) {
    src = s; P = p; Hp = hp; Wp = wp;
    mi_rows = mir; mi_cols = mic; mi_r0 = r0; mi_c0 = c0;
    mi_r1 = r1 < mir ? r1 : mir; mi_c1 = c1 < mic ? c1 : mic;
    bit_depth = bd; dc_q = dq; ac_q = aq; gain = g; lam = lam_;
    recon_store.assign((size_t)P * Hp * Wp, 0);
    recon = recon_store.data();
    fbuf.resize(64 * 64); tbuf.resize(64 * 64);
    cbuf.resize(64 * 64); rbuf.resize(64 * 64);
    lvbuf.resize(32 * 32); pred.resize(64 * 64);
    // per-mi mode grids over the tile (edge-filter neighbor smoothness)
    tile_w4 = (c1 - c0) + 16;
    tile_h4 = (r1 - r0) + 16;
    ymg.assign((size_t)tile_h4 * tile_w4, -1);
    uvmg.assign((size_t)tile_h4 * tile_w4, -1);
  }

  int tile_w4 = 0, tile_h4 = 0;
  std::vector<int16_t> ymg, uvmg;

  // intra predict into pred[] (txh x txw), reading recon neighbors
  void predict(int pl, int px, int py, int txw, int txh, int mode, int delta) {
    const int32_t* rp = &recon[(size_t)pl * Hp * Wp];
    int rr4 = (py >> 2) - mi_r0;
    int cc4 = (px >> 2) - mi_c0;
    bool have_a = rr4 > 0;
    bool have_l = cc4 > 0;
    int base = 1 << (bit_depth - 1);
    if (mode >= 1 && mode <= 8 && !(delta == 0 && (mode == 1 || mode == 2))) {
      predict_directional(pl, px, py, txw, txh, mode, delta, have_a, have_l);
      return;
    }
    int64_t above[64], left[64], al;
    // tile-edge clamp: reads never pass the tile mi bounds (blocks at a
    // partial bottom/right superblock overhang the grid; the decoder
    // replicates the last in-bounds row/column)
    const int max_x = mi_c1 * 4 - 1, max_y = mi_r1 * 4 - 1;
    if (!have_a && !have_l) {
      for (int i = 0; i < txw; i++) above[i] = base - 1;
      for (int i = 0; i < txh; i++) left[i] = base + 1;
      al = base;
    } else if (!have_a) {
      for (int i = 0; i < txh; i++) {
        int yy = py + i; if (yy > max_y) yy = max_y;
        left[i] = rp[(size_t)yy * Wp + px - 1];
      }
      for (int i = 0; i < txw; i++) above[i] = left[0];
      al = left[0];
    } else if (!have_l) {
      for (int i = 0; i < txw; i++) {
        int xx = px + i; if (xx > max_x) xx = max_x;
        above[i] = rp[(size_t)(py - 1) * Wp + xx];
      }
      for (int i = 0; i < txh; i++) left[i] = above[0];
      al = above[0];
    } else {
      for (int i = 0; i < txw; i++) {
        int xx = px + i; if (xx > max_x) xx = max_x;
        above[i] = rp[(size_t)(py - 1) * Wp + xx];
      }
      for (int i = 0; i < txh; i++) {
        int yy = py + i; if (yy > max_y) yy = max_y;
        left[i] = rp[(size_t)yy * Wp + px - 1];
      }
      al = rp[(size_t)(py - 1) * Wp + px - 1];
    }
    int32_t* out = pred.data();
    switch (mode) {
      case 0: {  // DC
        int64_t avg;
        if (have_a && have_l) {
          int64_t s = 0;
          for (int i = 0; i < txw; i++) s += above[i];
          for (int i = 0; i < txh; i++) s += left[i];
          avg = (s + ((txw + txh) >> 1)) / (txw + txh);
        } else if (have_a) {
          int64_t s = 0;
          for (int i = 0; i < txw; i++) s += above[i];
          avg = (s + (txw >> 1)) >> (bitlength((uint32_t)txw) - 1);
        } else if (have_l) {
          int64_t s = 0;
          for (int i = 0; i < txh; i++) s += left[i];
          avg = (s + (txh >> 1)) >> (bitlength((uint32_t)txh) - 1);
        } else {
          avg = base;
        }
        for (int i = 0; i < txh * txw; i++) out[i] = (int32_t)avg;
        break;
      }
      case 1:  // V
        for (int y = 0; y < txh; y++)
          for (int x = 0; x < txw; x++) out[y * txw + x] = (int32_t)above[x];
        break;
      case 2:  // H
        for (int y = 0; y < txh; y++)
          for (int x = 0; x < txw; x++) out[y * txw + x] = (int32_t)left[y];
        break;
      case 9: {  // SMOOTH
        const uint8_t* wh = g_tables.sm_weights[bitlength((uint32_t)txh) - 3].data();
        const uint8_t* ww = g_tables.sm_weights[bitlength((uint32_t)txw) - 3].data();
        int64_t below = left[txh - 1], right = above[txw - 1];
        for (int y = 0; y < txh; y++)
          for (int x = 0; x < txw; x++) {
            int64_t t = (int64_t)wh[y] * above[x] + (256 - wh[y]) * below +
                        (int64_t)ww[x] * left[y] + (256 - ww[x]) * right;
            out[y * txw + x] = (int32_t)((t + 256) >> 9);
          }
        break;
      }
      case 10: {  // SMOOTH_V
        const uint8_t* wh = g_tables.sm_weights[bitlength((uint32_t)txh) - 3].data();
        int64_t below = left[txh - 1];
        for (int y = 0; y < txh; y++)
          for (int x = 0; x < txw; x++) {
            int64_t t = (int64_t)wh[y] * above[x] + (256 - wh[y]) * below;
            out[y * txw + x] = (int32_t)((t + 128) >> 8);
          }
        break;
      }
      case 11: {  // SMOOTH_H
        const uint8_t* ww = g_tables.sm_weights[bitlength((uint32_t)txw) - 3].data();
        int64_t right = above[txw - 1];
        for (int y = 0; y < txh; y++)
          for (int x = 0; x < txw; x++) {
            int64_t t = (int64_t)ww[x] * left[y] + (256 - ww[x]) * right;
            out[y * txw + x] = (int32_t)((t + 128) >> 8);
          }
        break;
      }
      case 12: {  // PAETH
        for (int y = 0; y < txh; y++)
          for (int x = 0; x < txw; x++) {
            int64_t b = left[y] + above[x] - al;
            int64_t pl_ = b - left[y]; if (pl_ < 0) pl_ = -pl_;
            int64_t pt = b - above[x]; if (pt < 0) pt = -pt;
            int64_t ptl = b - al; if (ptl < 0) ptl = -ptl;
            int64_t v;
            if (pl_ <= pt && pl_ <= ptl) v = left[y];
            else if (pt <= ptl) v = above[x];
            else v = al;
            out[y * txw + x] = (int32_t)v;
          }
        break;
      }
      default:
        for (int i = 0; i < txh * txw; i++) out[i] = base;
    }
  }

  // Directional predictor (spec 7.11.2.4, no edge filter/upsample),
  // with spec neighbor extension: AboveRow/LeftCol length w+h, real pixels
  // up to the availability bound (above-right / below-left from the
  // BlockDecoded mirror), frame-edge-clamped reads, replication beyond.
  // --- intra edge filtering (spec 7.11.2.9-12), decoder-exact ---------
  static int edge_strength(int w, int h, int ftype, int delta) {
    int d = delta < 0 ? -delta : delta;
    int wh = w + h;
    if (ftype == 0) {
      if (wh <= 8) { if (d >= 56) return 1; }
      else if (wh <= 12) { if (d >= 40) return 1; }
      else if (wh <= 16) { if (d >= 40) return 1; }
      else if (wh <= 24) {
        if (d >= 32) return 3;
        if (d >= 16) return 2;
        if (d >= 8) return 1;
      } else if (wh <= 32) {
        if (d >= 32) return 3;
        if (d >= 4) return 2;
        return 1;
      } else return 3;
      return 0;
    }
    if (wh <= 8) { if (d >= 64) return 2; if (d >= 40) return 1; }
    else if (wh <= 16) { if (d >= 48) return 2; if (d >= 20) return 1; }
    else if (wh <= 24) { if (d >= 4) return 3; }
    else return 3;
    return 0;
  }

  static bool use_upsample(int w, int h, int ftype, int delta) {
    int d = delta < 0 ? -delta : delta;
    if (d <= 0 || d >= 40) return false;
    return ftype ? (w + h <= 8) : (w + h <= 16);
  }

  // smooth e[0..n_px-1] (the edge) with the corner as virtual index -1;
  // rounded kernel shift, clamped window reads from a copy
  static void edge_smooth(int64_t corner, int64_t* e, int n_px,
                          int strength) {
    if (!strength || n_px < 1) return;
    static const int KER[3][5] = {
        {0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
    const int* k = KER[strength - 1];
    const int sz = n_px + 1;
    int64_t orig[132];
    orig[0] = corner;
    for (int i = 0; i < n_px; i++) orig[i + 1] = e[i];
    for (int i = 1; i < sz; i++) {
      long long sum = 0;
      for (int j = 0; j < 5; j++) {
        int idx = i - 2 + j;
        idx = idx < 0 ? 0 : (idx > sz - 1 ? sz - 1 : idx);
        sum += k[j] * orig[idx];
      }
      e[i - 1] = (sum + 8) >> 4;
    }
  }

  // 2x upsample of [corner, e0..e_{sz-1}] into out such that the spec's
  // buf[k] lives at out[2 + k] (k from -2); returns entries written
  static int upsample_edge(int64_t corner, const int64_t* e, int sz,
                           int maxv, int64_t* out) {
    int64_t dup[262];
    dup[0] = corner;
    dup[1] = corner;
    for (int i = 0; i < sz; i++) dup[2 + i] = e[i];
    dup[sz + 2] = e[sz - 1];
    out[0] = dup[0];
    for (int i = 0; i < sz; i++) {
      long long v = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      v = (v + 8) >> 4;
      v = v < 0 ? 0 : (v > maxv ? maxv : v);
      out[2 + 2 * i - 1] = v;
      out[2 + 2 * i] = dup[i + 2];
    }
    return 2 * sz + 2;
  }

  int edge_filter = 0;   // cfg.intra_edge_filter
  int cur_ftype_y = 0;   // per-block neighbor-smoothness filter types
  int cur_ftype_uv = 0;

  void predict_directional(int pl, int px, int py, int txw, int txh, int mode,
                           int delta, bool have_a, bool have_l) {
    static const int MODE_ANGLE[8] = {90, 180, 45, 135, 113, 157, 203, 67};
    const int32_t* rp = &recon[(size_t)pl * Hp * Wp];
    int w = txw, h = txh, ext = w + h;
    int base = 1 << (bit_depth - 1);
    // tile-edge clamp (tiles are independent; spec maxX/maxY use the tile)
    int max_x = mi_c1 * 4 - 1;
    int max_y = mi_r1 * 4 - 1;
    int w4 = w >> 2, h4 = h >> 2;
    int sy = (py >> 2) - sb_r, sx = (px >> 2) - sb_c;
    bool have_ar = have_a && mask[sy][sx + w4 + 1];
    bool have_bl = have_l && mask[sy + h4 + 1][sx];
    int64_t above_ext[128], left_ext[128], al;
    if (!have_a && !have_l) {
      for (int i = 0; i < ext; i++) above_ext[i] = base - 1;
      for (int i = 0; i < ext; i++) left_ext[i] = base + 1;
      al = base;
    } else if (!have_a) {
      int n_lv = h + (have_bl ? h : 0);
      for (int i = 0; i < ext; i++) {
        int k = i < n_lv - 1 ? i : n_lv - 1;
        int yy = py + k; if (yy > max_y) yy = max_y;
        left_ext[i] = rp[(size_t)yy * Wp + px - 1];
      }
      for (int i = 0; i < ext; i++) above_ext[i] = left_ext[0];
      al = left_ext[0];
    } else if (!have_l) {
      int n_av = w + (have_ar ? w : 0);
      for (int i = 0; i < ext; i++) {
        int k = i < n_av - 1 ? i : n_av - 1;
        int xx = px + k; if (xx > max_x) xx = max_x;
        above_ext[i] = rp[(size_t)(py - 1) * Wp + xx];
      }
      for (int i = 0; i < ext; i++) left_ext[i] = above_ext[0];
      al = above_ext[0];
    } else {
      int n_av = w + (have_ar ? w : 0);
      for (int i = 0; i < ext; i++) {
        int k = i < n_av - 1 ? i : n_av - 1;
        int xx = px + k; if (xx > max_x) xx = max_x;
        above_ext[i] = rp[(size_t)(py - 1) * Wp + xx];
      }
      int n_lv = h + (have_bl ? h : 0);
      for (int i = 0; i < ext; i++) {
        int k = i < n_lv - 1 ? i : n_lv - 1;
        int yy = py + k; if (yy > max_y) yy = max_y;
        left_ext[i] = rp[(size_t)yy * Wp + px - 1];
      }
      al = rp[(size_t)(py - 1) * Wp + px - 1];
    }
    int p_angle = MODE_ANGLE[mode - 1] + delta * 3;
    int up_a = 0, up_l = 0;
    int64_t ab_up[262], lc_up[262];
    if (edge_filter && p_angle != 90 && p_angle != 180) {
      const int ftype = pl == 0 ? cur_ftype_y : cur_ftype_uv;
      if (p_angle > 90 && p_angle < 180 && (w + h) >= 24 && have_l &&
          have_a)
        al = (left_ext[0] * 5 + al * 6 + above_ext[0] * 5 + 8) >> 4;
      if (have_a) {
        int strength = edge_strength(w, h, ftype, p_angle - 90);
        int n_top = w < (max_x - px + 1) ? w : (max_x - px + 1);
        if (n_top < 0) n_top = 0;
        edge_smooth(al, above_ext, n_top + (p_angle < 90 ? h : 0),
                    strength);
      }
      if (have_l) {
        int strength = edge_strength(w, h, ftype, p_angle - 180);
        int n_left = h < (max_y - py + 1) ? h : (max_y - py + 1);
        if (n_left < 0) n_left = 0;
        edge_smooth(al, left_ext, n_left + (p_angle > 180 ? w : 0),
                    strength);
      }
      up_a = use_upsample(w, h, ftype, p_angle - 90) ? 1 : 0;
      up_l = use_upsample(w, h, ftype, p_angle - 180) ? 1 : 0;
      const int maxv = (1 << bit_depth) - 1;
      if (up_a)
        upsample_edge(al, above_ext, w + (p_angle < 90 ? h : 0), maxv,
                      ab_up);
      if (up_l)
        upsample_edge(al, left_ext, h + (p_angle > 180 ? w : 0), maxv,
                      lc_up);
    }
    int32_t* out = pred.data();
    const int32_t* dr = g_tables.dr.data();
    if (p_angle == 90) {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) out[i * w + j] = (int32_t)above_ext[j];
      return;
    }
    if (p_angle == 180) {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) out[i * w + j] = (int32_t)left_ext[i];
      return;
    }
    int max_base = w + h - 1;
    if (p_angle < 90) {
      int dx = dr[p_angle];
      if (up_a) {
        const int64_t* src = ab_up + 2;  // buf[k] for k >= 0
        const int mb = (w + h - 1) << 1;
        for (int i = 0; i < h; i++) {
          int64_t idx = (int64_t)(i + 1) * dx;
          for (int j = 0; j < w; j++) {
            int64_t b = (idx >> 5) + ((int64_t)j << 1);
            int shift = (int)(((idx << 1) >> 1) & 0x1F);
            int64_t v = b < mb
                ? (src[b] * (32 - shift) + src[b + 1] * shift + 16) >> 5
                : src[mb];
            out[i * w + j] = (int32_t)v;
          }
        }
        return;
      }
      for (int i = 0; i < h; i++) {
        int64_t idx = (int64_t)(i + 1) * dx;
        for (int j = 0; j < w; j++) {
          int64_t b = (idx >> 6) + j;
          int shift = (int)((idx >> 1) & 0x1F);
          int64_t v;
          if (b < max_base)
            v = (above_ext[b] * (32 - shift) + above_ext[b + 1] * shift + 16) >> 5;
          else
            v = above_ext[max_base];
          out[i * w + j] = (int32_t)v;
        }
      }
    } else if (p_angle < 180) {
      int dx = dr[180 - p_angle];
      int dy = dr[p_angle - 90];
      const int lim = -(1 << up_a);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int64_t b, av;
          int shift;
          if (up_a) {
            int64_t idx = ((int64_t)j << 7) - (int64_t)(i + 1) * (dx << 1);
            b = idx >> 6;
            shift = (int)((idx >> 1) & 0x1F);
            int64_t bi = b < -2 ? -2 : b;
            av = (ab_up[bi + 2] * (32 - shift) + ab_up[bi + 3] * shift +
                  16) >> 5;
          } else {
            int64_t idx = ((int64_t)j << 6) - (int64_t)(i + 1) * dx;
            b = idx >> 6;
            shift = (int)((idx >> 1) & 0x1F);
            int64_t bi = b < -1 ? -1 : b;
            int64_t a0 = bi < 0 ? al : above_ext[bi];
            int64_t a1 = above_ext[bi + 1];
            av = (a0 * (32 - shift) + a1 * shift + 16) >> 5;
          }
          int64_t v;
          if (b >= lim) {
            v = av;
          } else if (up_l) {
            int64_t idx2 = ((int64_t)i << 7) - (int64_t)(j + 1) * (dy << 1);
            int64_t b2 = idx2 >> 6;
            int shift2 = (int)((idx2 >> 1) & 0x1F);
            int64_t bi = b2 < -2 ? -2 : b2;
            v = (lc_up[bi + 2] * (32 - shift2) + lc_up[bi + 3] * shift2 +
                 16) >> 5;
          } else {
            int64_t idx2 = ((int64_t)i << 6) - (int64_t)(j + 1) * dy;
            int64_t b2 = idx2 >> 6;
            int shift2 = (int)((idx2 >> 1) & 0x1F);
            int64_t bi = b2 < -1 ? -1 : b2;
            int64_t l0 = bi < 0 ? al : left_ext[bi];
            int64_t l1 = bi + 1 < 0 ? al : left_ext[bi + 1];
            v = (l0 * (32 - shift2) + l1 * shift2 + 16) >> 5;
          }
          out[i * w + j] = (int32_t)v;
        }
    } else {
      int dy = dr[270 - p_angle];
      if (up_l) {
        const int64_t* src = lc_up + 2;
        const int mb = (w + h - 1) << 1;
        for (int i = 0; i < h; i++)
          for (int j = 0; j < w; j++) {
            int64_t idx = (int64_t)(j + 1) * dy;
            int64_t b = (idx >> 5) + ((int64_t)i << 1);
            int shift = (int)(((idx << 1) >> 1) & 0x1F);
            int64_t v = b < mb
                ? (src[b] * (32 - shift) + src[b + 1] * shift + 16) >> 5
                : src[mb];
            out[i * w + j] = (int32_t)v;
          }
        return;
      }
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int64_t idx = (int64_t)(j + 1) * dy;
          int64_t b = (idx >> 6) + i;
          int shift = (int)((idx >> 1) & 0x1F);
          int64_t v;
          if (b < max_base)
            v = (left_ext[b] * (32 - shift) + left_ext[b + 1] * shift + 16) >> 5;
          else
            v = left_ext[max_base];
          out[i * w + j] = (int32_t)v;
        }
    }
  }

  // Compute one txb with fixed mode: quantize + reconstruct.
  // Returns levels in lvbuf (ch x cw); recon plane updated. force_skip
  // zeroes levels and reconstructs as pure prediction.
  // cost of the last compute_txb quantization (coef SSE + lam*rate)
  double last_cost = 0.0;

  // CfL state for compute_txb(mode == 13): block luma AC + fitted alpha
  const int32_t* cfl_ac = nullptr;
  int cfl_alpha = 0;

  void predict_cfl(int pl, int px, int py, int txw, int txh) {
    predict(pl, px, py, txw, txh, 0, 0);  // DC base
    const int maxv = (1 << bit_depth) - 1;
    const int n = txw * txh;
    for (int i = 0; i < n; i++) {
      long long t = (long long)cfl_alpha * cfl_ac[i];
      long long a = t < 0 ? -t : t;
      long long sc = (a + 32) >> 6;  // Round2Signed(alpha * ac, 6)
      long long v = pred[i] + (t < 0 ? -sc : sc);
      pred[i] = v < 0 ? 0 : (v > maxv ? maxv : (int32_t)v);
    }
  }

  void compute_txb(int pl, int px, int py, int txw, int txh, int mode,
                   int delta, bool force_skip, int* out_ch, int* out_cw,
                   bool* any_nz, int try_adst) {
#ifdef CAVIF_BP_PROF
    double tp0 = bp_now();
#endif
    if (mode == 13) predict_cfl(pl, px, py, txw, txh);
    else predict(pl, px, py, txw, txh, mode, delta);
    BP_PROF_MARK(0, tp0)
    int cw = txw < 32 ? txw : 32;
    int ch = txh < 32 ? txh : 32;
    // tx <= 16x16: transform follows the prediction mode — derived
    // (unsignaled) for chroma; for luma the caller RD-selects between
    // DCT_DCT and the mode transform via try_adst
    // (Mode_To_Txfm_Type[UV_CFL_PRED] is DCT: mode 13 keeps 0)
    int v_adst = 0, h_adst = 0;
    if ((txw > txh ? txw : txh) <= 16 && !force_skip && mode != 13) {
      if (pl == 0 && tx_override >= 0) {
        v_adst = tx_override & 1;
        h_adst = (tx_override >> 1) & 1;
      } else if (pl > 0 || try_adst) {
        v_adst = MODE_V_ADST[mode];
        h_adst = MODE_H_ADST[mode];
      }
    }
    *out_ch = ch; *out_cw = cw;
    int32_t* rp = &recon[(size_t)pl * Hp * Wp];
    const int32_t* sp = &src[(size_t)pl * Hp * Wp];
    int maxv = (1 << bit_depth) - 1;
    if (force_skip) {
      for (int i = 0; i < ch * cw; i++) lvbuf[i] = 0;
      *any_nz = false;
      for (int y = 0; y < txh; y++)
        for (int x = 0; x < txw; x++)
          rp[(size_t)(py + y) * Wp + px + x] = pred[y * txw + x];
      return;
    }
    // residual
    for (int y = 0; y < txh; y++)
      for (int x = 0; x < txw; x++)
        fbuf[y * txw + x] =
            (double)(sp[(size_t)(py + y) * Wp + px + x] - pred[y * txw + x]);
    if (!v_adst && !h_adst) {
      // Lee fast DCT (transposed, unnormalized) -> normalize + transpose
      // back into cbuf's standard (txh, txw) orientation
      wbuf.resize(4 * (size_t)txh * txw);
      fdct2d_lee(fbuf.data(), txh, txw, tbuf.data(), wbuf.data());
      const double r2 = 0.70710678118654752440;
      double s = 2.0 / std::sqrt((double)(txh * txw));
      for (int a = 0; a < txw; a++) {
        double rs = s * (a == 0 ? r2 : 1.0);
        const double* col = &tbuf[(size_t)a * txh];
        for (int b = 0; b < txh; b++)
          cbuf[(size_t)b * txw + a] = col[b] * rs * (b == 0 ? r2 : 1.0);
      }
    } else {
      const double* mh = dct_matrix(txh).d.data();
      const double* mw = dct_matrix(txw).d.data();
      if (v_adst) mh = g_fwd_adst[txh == 4 ? 0 : txh == 8 ? 1 : 2].data();
      if (h_adst) mw = g_fwd_adst[txw == 4 ? 0 : txw == 8 ? 1 : 2].data();
      mat_sandwich(mh, fbuf.data(), mw, txh, txw, tbuf.data(), cbuf.data());
    }
    // quantize coded area (top-left ch x cw of the txh x txw coef array);
    // clamp to the dequant conformance bound |level * q| < 1 << (7 + bd)
    // (spec 7.13.3 — transforms.level_limits mirrors this)
    double gsz = gain * tx_gain_factor(txw, txh);
    double inv_ac = 1.0 / ((double)ac_q * gsz);
    double inv_dc = 1.0 / ((double)dc_q * gsz);
    int coeff_max = (1 << (7 + bit_depth)) - 1;
    int max_dc = coeff_max / dc_q; if (max_dc > 32767) max_dc = 32767;
    int max_ac = coeff_max / ac_q; if (max_ac > 32767) max_ac = 32767;
    bool nz = false;
    // HF rounding probe (CAVIF_TPU_AC_BIAS_HF, default 0): raise the AC
    // rounding bias linearly with normalized coefficient frequency —
    // preserves high-frequency residual energy (SSIM contrast) at a rate
    // cost; A/B tooling for the variance-restoration hunt.
    const double hf_amp = ac_bias_hf_env();
    const double hf_den = (ch + cw > 2) ? 1.0 / (double)(ch + cw - 2) : 0.0;
    for (int y = 0; y < ch; y++)
      for (int x = 0; x < cw; x++) {
        bool is_dc = (y == 0 && x == 0);
        double t = cbuf[y * txw + x] * (is_dc ? inv_dc : inv_ac);
        double ab = std::fabs(t) >= ac_thresh_env() ? ac_bias_hi_env()
                                                    : ac_bias_env();
        if (hf_amp != 0.0) {
          double f = (double)(y + x) * hf_den;
          ab += hf_amp * f;
          if (ab > 0.499) ab = 0.499;
          if (ab < 0.0) ab = 0.0;
        }
        double a = std::floor(std::fabs(t) + (is_dc ? 0.5 : ab));
        int32_t lv = (int32_t)(t < 0 ? -a : a);
        int lim = is_dc ? max_dc : max_ac;
        if (lv > lim) lv = lim;
        if (lv < -lim) lv = -lim;
        lvbuf[y * cw + x] = lv;
        nz |= lv != 0;
      }
    // Context-aware trellis (libaom optimize_txb analog): walk the
    // coefficients in coding (reverse-scan) order and step each |level|
    // down while the distortion added stays under lambda * U * the CDF
    // bit saving priced with the REAL coding contexts — base/base_eob
    // ctx from the already-decided neighbors (pad mirrors the writer's
    // context state with the ADJUSTED levels), br rounds, golomb, sign.
    // The last coefficient stays >= 1 (the eob does not move; the EOB
    // cut below owns tail moves). encoder._trellis_optimize mirrors
    // this pass bit-for-bit.
    double tru = trellis_ctx_env() * trellis_ramp(frame_base_q);
    bool use_acdf = trellis_adapt_env() != 0;
    if (use_acdf && !acdf_ready) {
      acdf_init();
      use_acdf = acdf_ready;
    }
    // Adaptive-EOB recording (eob_adapt_env): per-position live-CDF
    // costs captured during the trellis walk for the cut model below.
    // rec_full[si] = 1/128-bit cost the EC will pay for position si's
    // final level at its real context (incl. base-0 symbols for zeros
    // before the eob — the static model's unpriced tail zeros);
    // rec_bmid/rec_beob = the base symbol alone at the mid vs eob
    // context (the cut's new-last-coefficient context switch).
    int32_t rec_full[1024], rec_bmid[1024], rec_beob[1024];
    int rec_eob = -1;
    const bool rec = use_acdf && eob_adapt_env(eob_adapt_cfg) > 0.0;
    if (nz && lam > 0.0 && tru > 0.0 && !g_tables.trellis_base.empty()) {
      int sidx = size_idx(cw, ch);
      const int32_t* scan = g_tables.scan[sidx].data();
      const uint8_t* nzoff = g_tables.nzoff[sidx].data();
      int area = cw * ch;
      int eob = 0;
      for (int i = area - 1; i >= 0; i--)
        if (lvbuf[scan[i]] != 0) { eob = i + 1; break; }
      int tctx = txsize_ctx(txw, txh);
      int pt = pl > 0 ? 1 : 0;
      const uint16_t* tb =
          &g_tables.trellis_base[((((size_t)qctx * 5 + tctx) * 2 + pt) * 42) * 4];
      const uint16_t* te =
          &g_tables.trellis_base_eob[((((size_t)qctx * 5 + tctx) * 2 + pt) * 4) * 3];
      int brt = tctx < 3 ? tctx : 3;
      const uint16_t* tbr =
          &g_tables.trellis_br[((((size_t)qctx * 5 + brt) * 2 + pt) * 21) * 4];
      double s_ac = (double)ac_q * gsz, s_dc = (double)dc_q * gsz;
      const double uu = trellis_up_env();  // hoisted: per-txb, not per-coef
      int padw = cw + 2;
      int32_t padbuf[34 * 34];
      std::memset(padbuf, 0, sizeof(int32_t) * (size_t)(ch + 2) * padw);
      for (int si = eob - 1; si >= 0; si--) {
        int pos = scan[si];
        int row = pos / cw, col = pos % cw;
        int lv = lvbuf[pos];
        int l = lv < 0 ? -lv : lv;
        if (l > 0) {
          bool is_eob = si == eob - 1;
          const uint16_t* baserow;
          const CdfRow* abase = nullptr;
          if (is_eob) {
            int ectx = si == 0 ? 0
                       : si <= area / 8 ? 1
                       : si <= area / 4 ? 2 : 3;
            baserow = te + (size_t)ectx * 3;
            if (use_acdf) abase = &acdf_base_eob[tctx][pt][ectx];
          } else {
            const int32_t* p0 = &padbuf[(size_t)row * padw + col];
            int mag = (p0[1] < 3 ? p0[1] : 3) +
                      (p0[padw] < 3 ? p0[padw] : 3) +
                      (p0[padw + 1] < 3 ? p0[padw + 1] : 3) +
                      (p0[2] < 3 ? p0[2] : 3) +
                      (p0[2 * padw] < 3 ? p0[2 * padw] : 3);
            int mctx = (mag + 1) >> 1;
            if (mctx > 4) mctx = 4;
            int bctx = pos == 0 ? 0 : mctx + (int)nzoff[pos];
            baserow = tb + (size_t)bctx * 4;
            if (use_acdf) abase = &acdf_base[tctx][pt][bctx];
          }
          const int32_t* p0 = &padbuf[(size_t)row * padw + col];
          int magb = (p0[1] < 15 ? p0[1] : 15) +
                     (p0[padw] < 15 ? p0[padw] : 15) +
                     (p0[padw + 1] < 15 ? p0[padw + 1] : 15);
          int bmag = (magb + 1) >> 1;
          if (bmag > 6) bmag = 6;
          int brctx = pos == 0 ? bmag
                      : (row < 2 && col < 2) ? bmag + 7 : bmag + 14;
          const uint16_t* brrow = tbr + (size_t)brctx * 4;
          const CdfRow* abr = use_acdf ? &acdf_br[brt][pt][brctx]
                                       : nullptr;
          double q = pos == 0 ? s_dc : s_ac;
          double cf = std::fabs(cbuf[(size_t)row * txw + col]);
          int min_l = is_eob ? 1 : 0;
          while (l > min_l) {
            double d_cur = cf - l * q;
            double d_new = cf - (l - 1) * q;
            double dd = d_new * d_new - d_cur * d_cur;
            int dr = use_acdf
                ? trellis_cost_level_a(l, is_eob, *abase, *abr) -
                      trellis_cost_level_a(l - 1, is_eob, *abase, *abr)
                : trellis_cost_level(l, is_eob, baserow, brrow) -
                      trellis_cost_level(l - 1, is_eob, baserow, brrow);
            double thr = lam * psy_mul * tru * ((double)dr / 128.0);
            double S = trellis_lf_env();
            if (S > 0.0) thr *= (double)si / ((double)si + S);
            if (dd < thr) l--;
            else break;
          }
          if (uu > 0.0 && l == (lv < 0 ? -lv : lv)) {
            int lim = pos == 0 ? max_dc : max_ac;
            while (l < lim) {
              double d_cur = cf - l * q;
              double d_new = cf - (l + 1) * q;
              double dd = d_cur * d_cur - d_new * d_new;  // >0 = improves
              int dr = use_acdf
                  ? trellis_cost_level_a(l + 1, is_eob, *abase, *abr) -
                        trellis_cost_level_a(l, is_eob, *abase, *abr)
                  : trellis_cost_level(l + 1, is_eob, baserow, brrow) -
                        trellis_cost_level(l, is_eob, baserow, brrow);
              if (dd > lam * psy_mul * uu * ((double)dr / 128.0)) l++;
              else break;
            }
          }
          lvbuf[pos] = lv < 0 ? -l : l;
          if (rec) {
            if (l > 0) {
              rec_full[si] = trellis_cost_level_a(l, is_eob, *abase, *abr);
              if (is_eob) {
                rec_bmid[si] = rec_beob[si] = 0;  // never a cut's new last
              } else {
                rec_bmid[si] = acdf_cost(*abase, l < 3 ? l : 3, 4);
                int ectx = si == 0 ? 0
                           : si <= area / 8 ? 1
                           : si <= area / 4 ? 2 : 3;
                rec_beob[si] = acdf_cost(acdf_base_eob[tctx][pt][ectx],
                                         (l < 3 ? l : 3) - 1, 3);
              }
            } else {  // trellis zeroed a mid position: EC pays base-0
              rec_full[si] = acdf_cost(*abase, 0, 4);
              rec_bmid[si] = rec_beob[si] = 0;
            }
          }
        } else if (rec) {
          // zero mid position (is_eob impossible): base-0 symbol cost
          // at its live context
          const int32_t* p0 = &padbuf[(size_t)row * padw + col];
          int mag = (p0[1] < 3 ? p0[1] : 3) +
                    (p0[padw] < 3 ? p0[padw] : 3) +
                    (p0[padw + 1] < 3 ? p0[padw + 1] : 3) +
                    (p0[2] < 3 ? p0[2] : 3) +
                    (p0[2 * padw] < 3 ? p0[2 * padw] : 3);
          int mctx = (mag + 1) >> 1;
          if (mctx > 4) mctx = 4;
          int bctx = pos == 0 ? 0 : mctx + (int)nzoff[pos];
          rec_full[si] = acdf_cost(acdf_base[tctx][pt][bctx], 0, 4);
          rec_bmid[si] = rec_beob[si] = 0;
        }
        padbuf[(size_t)row * padw + col] = l < 127 ? l : 127;
      }
      if (rec) rec_eob = eob;
      nz = false;
      for (int i = 0; i < ch * cw; i++)
        if (lvbuf[i]) { nz = true; break; }
    }
    // EOB optimization: drop the coefficient tail when the rate saved
    // (|level| + 2 per coefficient, in the search's rate-proxy units)
    // outweighs the added distortion (Parseval: coefficient-domain SSE).
    if (nz && lam > 0.0) {
      int sidx = size_idx(cw, ch);
      const int32_t* scan = g_tables.scan[sidx].data();
      int area = cw * ch;
      int eob = 0;
      for (int i = area - 1; i >= 0; i--)
        if (lvbuf[scan[i]] != 0) { eob = i + 1; break; }
      double s_ac = (double)ac_q * gsz, s_dc = (double)dc_q * gsz;
      double dd = 0.0, dr = 0.0, best = 0.0;
      int best_cut = eob;
      double ueb = eob_bits_env();
      if (rec_eob == eob) {
        // Live-CDF cut model (see eob_adapt_env): the rate saved by a
        // cut at si is the recorded EC cost of every dropped position
        // (nonzero levels AND the base-0 symbols of the tail zeros),
        // plus the new last coefficient's base->base_eob context switch,
        // plus the exact eob_pt/eob_extra position saving — all from
        // the same live mirrors the trellis priced with. Survivor
        // contexts shrink after a cut (their tail neighbors zero), so
        // the model is conservative in the cut's favor.
        const double uad = eob_adapt_env(eob_adapt_cfg);
        int tctx = txsize_ctx(txw, txh);
        int pt = pl > 0 ? 1 : 0;
        int kidx = 0;
        for (int a2 = area; a2 > 16; a2 >>= 1) kidx++;
        const CdfRow& eptrow = acdf_eob_pt[kidx][pt];
        auto eob_pos_cost = [&](int e) -> int {
          int ept = e == 1 ? 1
                    : e == 2 ? 2
                             : bitlen_u32((uint32_t)(e - 1)) + 1;
          int c = acdf_cost(eptrow, ept - 1, 5 + kidx);
          if (ept >= 3) {
            int base_v = (1 << (ept - 2)) + 1;
            int msb = ((e - base_v) >> (ept - 3)) & 1;
            c += acdf_cost(acdf_eob_extra[tctx][pt][ept - 3], msb, 2);
            c += 128 * (ept - 3);  // literal offset bits
          }
          return c;
        };
        const int c_eob_old = eob_pos_cost(eob);
        int dr128 = 0;
        for (int si = eob - 1; si >= 1; si--) {
          int pos = scan[si];
          int lvv = lvbuf[pos];
          if (lvv != 0) {
            int row = pos / cw, col = pos % cw;
            double cf = cbuf[row * txw + col];
            double dq = lvv * (pos == 0 ? s_dc : s_ac);
            dd += cf * cf - (cf - dq) * (cf - dq);
          }
          dr128 += rec_full[si];
          // context switch of the new last coefficient (zero there means
          // the EC will shorten the eob further; priced as the static
          // model does — no switch term)
          int sw = lvbuf[scan[si - 1]] != 0 ? rec_beob[si - 1] - rec_bmid[si - 1]
                                            : 0;
          int dre = dr128 + sw + c_eob_old - eob_pos_cost(si);
          double delta = lam * psy_mul * uad * ((double)dre / 128.0) - dd;
          if (delta > best) { best = delta; best_cut = si; }
        }
      } else
      for (int si = eob - 1; si >= 1; si--) {
        int pos = scan[si];
        int lvv = lvbuf[pos];
        if (lvv != 0) {
          int row = pos / cw, col = pos % cw;
          double cf = cbuf[row * txw + col];
          double dq = lvv * (pos == 0 ? s_dc : s_ac);
          double e_keep = (cf - dq) * (cf - dq);
          double e_drop = cf * cf;
          dd += e_drop - e_keep;
          if (ueb > 0.0)
            dr += ueb * level_bits(lvv < 0 ? -lvv : lvv);
          else
            dr += (double)(lvv < 0 ? -lvv : lvv) + 2.0;
        }
        double dr_eob = dr;
        if (ueb > 0.0) {
          // shorter eob = cheaper position class (~2 bits per class:
          // the eob_pt symbol probability halves-ish per class plus one
          // extra literal) — price the class shrink into the cut
          int cls_d = bitlen_u32((uint32_t)(eob - 1)) -
                      bitlen_u32((uint32_t)(si - 1));
          if (cls_d > 0) dr_eob += ueb * 2.0 * (double)cls_d;
        }
        double delta = lam * psy_mul * dr_eob - dd;  // net cut gain
        if (delta > best) { best = delta; best_cut = si; }
      }
      if (best_cut < eob) {
        for (int si = best_cut; si < eob; si++) lvbuf[scan[si]] = 0;
        nz = false;
        for (int i = 0; i < ch * cw; i++)
          if (lvbuf[i]) { nz = true; break; }
      }
    }
    // RD cost of this quantization (for the luma DCT-vs-ADST choice and
    // the CfL joint decision). Deliberately a separate pass: it has no
    // deadzone/floor branches so it vectorizes, which measured faster
    // than fusing it into the quant loop above.
    {
      double cst = 0.0;
      double s_ac2 = (double)ac_q * gsz, s_dc2 = (double)dc_q * gsz;
      for (int yy = 0; yy < ch; yy++)
        for (int xx = 0; xx < cw; xx++) {
          double cf = cbuf[yy * txw + xx];
          int lvv = lvbuf[yy * cw + xx];
          double dq = lvv * (yy == 0 && xx == 0 ? s_dc2 : s_ac2);
          double e = cf - dq;
          cst += e * e;
          if (lvv) cst += lam * ((lvv < 0 ? -lvv : lvv) + 2.0);
        }
      last_cost = cst;
    }
    BP_PROF_MARK(1, tp0)
    *any_nz = nz;
    if (!nz) {
      for (int y = 0; y < txh; y++)
        for (int x = 0; x < txw; x++)
          rp[(size_t)(py + y) * Wp + px + x] = pred[y * txw + x];
      return;
    }
    // exact integer inverse (decoder-bit-exact) -> zero model drift
    static thread_local std::vector<int32_t> resid;
    resid.resize((size_t)txw * txh);
    inv_txfm_exact(lvbuf.data(), ch, cw, txw, txh, dc_q, ac_q, bit_depth,
                   v_adst, h_adst, resid.data());
    for (int y = 0; y < txh; y++)
      for (int x = 0; x < txw; x++) {
        long long v = (long long)pred[y * txw + x] + resid[y * txw + x];
        if (v < 0) v = 0;
        if (v > maxv) v = maxv;
        rp[(size_t)(py + y) * Wp + px + x] = (int32_t)v;
      }
    BP_PROF_MARK(2, tp0)
  }

  // Full leaf block: compute all txbs, then emit skip/modes/coeffs.
  void encode_block(TileCoder& tc, int r, int c, int w4, int h4, int y_mode,
                    int y_delta, int uv_mode, int uv_delta, int num_planes) {
    int rr = r - mi_r0, cc = c - mi_c0;
    psy_mul = psy ? psy[(size_t)(r / 16) * psy_cols + (c / 16)] : 1.0;
    int bw = w4 * 4, bh = h4 * 4;
    int x0 = c * 4, y0 = r * 4;
    int mx = bw > bh ? bw : bh;
    // 64-dim tx codes its top-left 32x32 coefficients (inv_txfm_exact
    // runs the full 64-lane inverse network)
    bool force_skip = false;
    int cfl_allowed = mx <= 32;
    if (edge_filter) {
      auto smooth_of = [&](const std::vector<int16_t>& g) {
        int sm = 0;
        if (rr > 0) {
          int m_ = g[(size_t)(rr - 1) * tile_w4 + cc];
          if (m_ >= 9 && m_ <= 11) sm = 1;
        }
        if (cc > 0) {
          int m_ = g[(size_t)rr * tile_w4 + (cc - 1)];
          if (m_ >= 9 && m_ <= 11) sm = 1;
        }
        return sm;
      };
      cur_ftype_y = smooth_of(ymg);
      cur_ftype_uv = smooth_of(uvmg);
      for (int yy = 0; yy < h4 && rr + yy < tile_h4; yy++)
        for (int xx = 0; xx < w4 && cc + xx < tile_w4; xx++)
          ymg[(size_t)(rr + yy) * tile_w4 + cc + xx] = (int16_t)y_mode;
    }

    struct TxbRec { int pl, px, py, txw, txh, ch, cw, lvl_off, va, ha; };
    TxbRec recs[32];
    int nrec = 0;
    static thread_local std::vector<int32_t> all_levels;
    all_levels.clear();
    bool any_nz = false;
    // chroma-from-luma: single-txb chroma only (cfl_allowed), decided
    // jointly for U and V after the luma recon lands
    const bool try_cfl = cfl_search && cfl_allowed && !force_skip &&
                         num_planes == 3 && x0 + bw <= Wp && y0 + bh <= Hp;
    const int n_loop_planes = try_cfl ? 1 : num_planes;
    for (int pl = 0; pl < n_loop_planes; pl++) {
      int txw = pl == 0 ? (bw < 64 ? bw : 64) : (bw < 32 ? bw : 32);
      int txh = pl == 0 ? (bh < 64 ? bh : 64) : (bh < 32 ? bh : 32);
      int mode = pl == 0 ? y_mode : uv_mode;
      int delta = pl == 0 ? y_delta : uv_delta;
      for (int ty = 0; ty < bh; ty += txh)
        for (int tx = 0; tx < bw; tx += txw) {
          int px = x0 + tx, py = y0 + ty;
          if (px >= mi_cols * 4 || py >= mi_rows * 4) continue;
          int ch, cw; bool nz;
          int va = 0, ha = 0;
          bool small = (txw > txh ? txw : txh) <= 16 && !force_skip;
          int mode_combo =
              MODE_V_ADST[mode] | (MODE_H_ADST[mode] << 1);
          if (pl == 0 && small && (mode_combo || tx_exhaustive)) {
            // RD-select the signaled luma transform. Fast presets: DCT
            // vs the spec mode-derived combo. tx_exhaustive (bottom-up
            // presets): all four DCT/ADST combos — the symbol codes any
            // of them (write_coeffs tx sets 1/2).
            int combos[4] = {0, mode_combo, 0, 0};
            int ncomb = mode_combo ? 2 : 1;
            if (tx_exhaustive) {
              ncomb = 0;
              for (int cb = 0; cb < 4; cb++) combos[ncomb++] = cb;
            }
            static thread_local std::vector<int32_t> lv_best;
            double c_best = 0.0;
            int best_cb = 0;
            bool nz_best = false;
            for (int ci = 0; ci < ncomb; ci++) {
              tx_override = combos[ci];
              compute_txb(pl, px, py, txw, txh, mode, delta, force_skip,
                          &ch, &cw, &nz, 1);
              // DCT is the cheapest symbol in both tx sets: bias the
              // non-DCT combos by a small signaling term (A/B-tuned for
              // the 2-candidate fast path; reused for the exhaustive one)
              double c = last_cost + (combos[ci] ? lam * 2.0 : 0.0);
              if (ci == 0 || c < c_best) {
                c_best = c;
                best_cb = combos[ci];
                nz_best = nz;
                lv_best.assign(lvbuf.begin(), lvbuf.begin() + ch * cw);
              }
            }
            tx_override = -1;
            va = best_cb & 1;
            ha = (best_cb >> 1) & 1;
            if (best_cb != combos[ncomb - 1]) {
              // recon holds the last-evaluated combo; redo for the winner
              std::copy(lv_best.begin(), lv_best.end(), lvbuf.begin());
              nz = nz_best;
              predict(pl, px, py, txw, txh, mode, delta);
              int32_t* rp2 = &recon[(size_t)pl * Hp * Wp];
              int maxv2 = (1 << bit_depth) - 1;
              if (!nz) {
                for (int yy = 0; yy < txh; yy++)
                  for (int xx = 0; xx < txw; xx++)
                    rp2[(size_t)(py + yy) * Wp + px + xx] =
                        pred[yy * txw + xx];
              } else {
                static thread_local std::vector<int32_t> rsd;
                rsd.resize((size_t)txw * txh);
                inv_txfm_exact(lvbuf.data(), ch, cw, txw, txh, dc_q, ac_q,
                               bit_depth, va, ha, rsd.data());
                for (int yy = 0; yy < txh; yy++)
                  for (int xx = 0; xx < txw; xx++) {
                    long long v2 = (long long)pred[yy * txw + xx] +
                                   rsd[yy * txw + xx];
                    if (v2 < 0) v2 = 0;
                    if (v2 > maxv2) v2 = maxv2;
                    rp2[(size_t)(py + yy) * Wp + px + xx] = (int32_t)v2;
                  }
              }
            } else {
              nz = nz_best;
            }
          } else {
            compute_txb(pl, px, py, txw, txh, mode, delta, force_skip, &ch,
                        &cw, &nz, 1);
          }
          any_nz |= nz;
          int off = (int)all_levels.size();
          all_levels.insert(all_levels.end(), lvbuf.begin(),
                            lvbuf.begin() + ch * cw);
          recs[nrec++] = {pl, px, py, txw, txh, ch, cw, off, va, ha};
        }
    }
    int cfl_signs = 0, cfl_au = 0, cfl_av = 0;
    if (try_cfl) {
      const int txw = bw, txh = bh;  // cfl_allowed -> one chroma txb
      // luma AC of the block from the just-reconstructed luma (Q3) with
      // the rounded average (decoder-exact: tests/test_cfl.py)
      static thread_local std::vector<int32_t> acv;
      acv.resize((size_t)bw * bh);
      {
        const int32_t* lrp = recon;
        long long sum = 0;
        for (int yy = 0; yy < bh; yy++)
          for (int xx = 0; xx < bw; xx++) {
            int32_t L = lrp[(size_t)(y0 + yy) * Wp + x0 + xx] << 3;
            acv[(size_t)yy * bw + xx] = L;
            sum += L;
          }
        int shift = 0;
        while ((1 << shift) < bw * bh) shift++;
        int avg = (int)((sum + (1 << (shift - 1))) >> shift);
        for (int i = 0; i < bw * bh; i++) acv[i] -= avg;
      }
      double acd = 0.0;
      for (int i = 0; i < bw * bh; i++)
        acd += (double)acv[i] * acv[i];
      int alpha[2] = {0, 0};
      if (acd > 0.0) {
        for (int pl = 1; pl <= 2; pl++) {
          predict(pl, x0, y0, txw, txh, 0, 0);  // DC baseline
          const int32_t* sp2 = &src[(size_t)pl * Hp * Wp];
          double num = 0.0;
          for (int yy = 0; yy < bh; yy++)
            for (int xx = 0; xx < bw; xx++)
              num += (double)(sp2[(size_t)(y0 + yy) * Wp + x0 + xx] -
                              pred[yy * bw + xx]) *
                     acv[(size_t)yy * bw + xx];
          double a = 64.0 * num / acd;
          int ai = (int)std::lround(a);
          alpha[pl - 1] = ai < -16 ? -16 : (ai > 16 ? 16 : ai);
        }
      }
      // evaluate the batch uv mode and (when any alpha is nonzero) the
      // CfL candidate for both planes; pick jointly
      static thread_local std::vector<int32_t> lv_uv[2], lv_cf[2];
      int ch_ = 0, cw_ = 0;
      bool nz_uv[2], nz_cf[2] = {false, false};
      double c_uv = 0.0, c_cf = 0.0;
      for (int pl = 1; pl <= 2; pl++) {
        bool nz;
        compute_txb(pl, x0, y0, txw, txh, uv_mode, uv_delta, false, &ch_,
                    &cw_, &nz, 1);
        nz_uv[pl - 1] = nz;
        c_uv += last_cost;
        lv_uv[pl - 1].assign(lvbuf.begin(), lvbuf.begin() + ch_ * cw_);
      }
      bool use_cfl = false;
      if (alpha[0] || alpha[1]) {
        cfl_ac = acv.data();
        for (int pl = 1; pl <= 2; pl++) {
          bool nz;
          cfl_alpha = alpha[pl - 1];
          compute_txb(pl, x0, y0, txw, txh, 13, 0, false, &ch_, &cw_, &nz,
                      1);
          nz_cf[pl - 1] = nz;
          c_cf += last_cost;
          lv_cf[pl - 1].assign(lvbuf.begin(), lvbuf.begin() + ch_ * cw_);
        }
        cfl_ac = nullptr;
        use_cfl = c_cf + lam * 4.0 < c_uv;
      }
      // recon currently holds the LAST computed path; redo the loser's
      // planes from the winner's saved levels
      const int small = (txw > txh ? txw : txh) <= 16;
      for (int pl = 1; pl <= 2; pl++) {
        const std::vector<int32_t>& lv =
            use_cfl ? lv_cf[pl - 1] : lv_uv[pl - 1];
        bool nz = use_cfl ? nz_cf[pl - 1] : nz_uv[pl - 1];
        if (!(alpha[0] || alpha[1]) && !use_cfl) {
          // only the uv path ran: recon already correct
        } else {
          int va2 = 0, ha2 = 0;
          if (!use_cfl && small) {
            va2 = MODE_V_ADST[uv_mode];
            ha2 = MODE_H_ADST[uv_mode];
          }
          if (use_cfl) {
            cfl_ac = acv.data();
            cfl_alpha = alpha[pl - 1];
            predict_cfl(pl, x0, y0, txw, txh);
            cfl_ac = nullptr;
          } else {
            predict(pl, x0, y0, txw, txh, uv_mode, uv_delta);
          }
          int32_t* rp2 = &recon[(size_t)pl * Hp * Wp];
          const int maxv2 = (1 << bit_depth) - 1;
          if (!nz) {
            for (int yy = 0; yy < txh; yy++)
              for (int xx = 0; xx < txw; xx++)
                rp2[(size_t)(y0 + yy) * Wp + x0 + xx] =
                    pred[yy * txw + xx];
          } else {
            static thread_local std::vector<int32_t> rsd2;
            rsd2.resize((size_t)txw * txh);
            inv_txfm_exact(lv.data(), ch_, cw_, txw, txh, dc_q, ac_q,
                           bit_depth, va2, ha2, rsd2.data());
            for (int yy = 0; yy < txh; yy++)
              for (int xx = 0; xx < txw; xx++) {
                long long v2 = (long long)pred[yy * txw + xx] +
                               rsd2[yy * txw + xx];
                if (v2 < 0) v2 = 0;
                if (v2 > maxv2) v2 = maxv2;
                rp2[(size_t)(y0 + yy) * Wp + x0 + xx] = (int32_t)v2;
              }
          }
        }
        any_nz |= nz;
        int off = (int)all_levels.size();
        all_levels.insert(all_levels.end(), lv.begin(), lv.end());
        recs[nrec++] = {pl, x0, y0, txw, txh, ch_, cw_, off, 0, 0};
      }
      if (use_cfl) {
        uv_mode = 13;
        uv_delta = 0;
        int su = alpha[0] == 0 ? 0 : (alpha[0] < 0 ? 1 : 2);
        int sv = alpha[1] == 0 ? 0 : (alpha[1] < 0 ? 1 : 2);
        cfl_signs = su * 3 + sv - 1;
        cfl_au = su ? (alpha[0] < 0 ? -alpha[0] : alpha[0]) - 1 : 0;
        cfl_av = sv ? (alpha[1] < 0 ? -alpha[1] : alpha[1]) - 1 : 0;
      }
    }
    int skip = any_nz ? 0 : 1;
    if (edge_filter) {
      for (int yy = 0; yy < h4 && rr + yy < tile_h4; yy++)
        for (int xx = 0; xx < w4 && cc + xx < tile_w4; xx++)
          uvmg[(size_t)(rr + yy) * tile_w4 + cc + xx] = (int16_t)uv_mode;
    }
    // mark decoded in the superblock mask (+1 offsets)
    {
      int sy = r - sb_r, sx = c - sb_c;
      for (int yy = 0; yy < h4; yy++)
        for (int xx = 0; xx < w4; xx++) mask[sy + 1 + yy][sx + 1 + xx] = 1;
    }
    tc.write_block(rr, cc, w4, h4, y_mode, uv_mode, skip, cfl_allowed,
                   y_delta, uv_delta, cfl_signs, cfl_au, cfl_av);
    {
      int32_t row[OP_BLOCK_N] = {OP_BLOCK, rr,   cc,   w4,      h4,   y_mode,
                         uv_mode,  skip, cfl_allowed, y_delta, uv_delta};
      row[11] = cfl_signs; row[12] = cfl_au; row[13] = cfl_av;
      rec_row(row, OP_BLOCK_N);
    }
    if (skip) return;
    for (int i = 0; i < nrec; i++) {
      const TxbRec& t = recs[i];
      int eq = (t.txw == bw && t.txh == bh) ? 1 : 0;
      // advance the adaptive-CDF trellis mirrors on the block's FINAL
      // (winner-candidate, post-EOB-cut) levels, in coding order —
      // compute_txb runs speculatively for tx/CfL candidates, so
      // counting must happen here, not inside the quantizer
      if (acdf_ready)
        acdf_count(&all_levels[t.lvl_off], t.cw, t.ch, t.pl, t.txw,
                   t.txh);
      tc.write_coeffs(t.pl, (t.py / 4) - mi_r0, (t.px / 4) - mi_c0, t.txw,
                      t.txh, eq, t.ch, t.cw, &all_levels[t.lvl_off], y_mode,
                      t.va, t.ha);
      if (rops) {
        int n = t.ch * t.cw;
        if (rlvl_n + n > rlvl_cap) {
          rec_overflow = true;
          rops = nullptr;
        } else {
          std::memcpy(rlvl + rlvl_n, &all_levels[t.lvl_off], (size_t)n * 4);
          int32_t row[OP_COEFFS_N] = {OP_COEFFS,
                             t.pl,
                             (t.py / 4) - mi_r0,
                             (t.px / 4) - mi_c0,
                             t.txw,
                             t.txh,
                             eq,
                             t.ch,
                             t.cw,
                             rlvl_n,
                             y_mode,
                             t.va,
                             t.ha};
          rlvl_n += n;
          rec_row(row, OP_COEFFS_N);
        }
      }
    }
  }
};


// ---------------------------------------------------------------------------
// Batched intra mode search (the encoder's pass 1). Mirrors the numpy
// reference search in av1/encoder.py _batch_search: 13 candidates (7
// non-directional + 6 diagonals at delta 0), SAD prefilter with DC forced
// into the survivor set, transform-domain RD on the survivors, optional
// angle-delta refinement for directional winners. Threaded over blocks.
// ---------------------------------------------------------------------------

namespace search {

constexpr int CAND_MODES[CAVIF_CAND_MODES_N] = CAVIF_CAND_MODES;
constexpr int MODE_ANGLE[8] = {90, 180, 45, 135, 113, 157, 203, 67};

// predict one mode/delta from synthesized extended neighbors
static void predict_into(int mode, int delta, const int32_t* ae,
                         const int32_t* le, int al, int have_a, int have_l,
                         int w, int h, int bd, int32_t* out) {
  int base = 1 << (bd - 1);
  if (mode == 0) {  // DC from real sides
    int64_t avg;
    if (have_a && have_l) {
      int64_t sm = 0;
      for (int i = 0; i < w; i++) sm += ae[i];
      for (int i = 0; i < h; i++) sm += le[i];
      avg = (sm + ((w + h) >> 1)) / (w + h);
    } else if (have_a) {
      int64_t sm = 0;
      for (int i = 0; i < w; i++) sm += ae[i];
      avg = (sm + (w >> 1)) >> (bitlength((uint32_t)w) - 1);
    } else if (have_l) {
      int64_t sm = 0;
      for (int i = 0; i < h; i++) sm += le[i];
      avg = (sm + (h >> 1)) >> (bitlength((uint32_t)h) - 1);
    } else {
      avg = base;
    }
    for (int i = 0; i < w * h; i++) out[i] = (int32_t)avg;
    return;
  }
  if (mode >= 1 && mode <= 8) {  // directional
    int p_angle = MODE_ANGLE[mode - 1] + 3 * delta;
    const int32_t* dr = g_tables.dr.data();
    int max_base = w + h - 1;
    if (p_angle == 90) {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) out[i * w + j] = ae[j];
      return;
    }
    if (p_angle == 180) {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) out[i * w + j] = le[i];
      return;
    }
    if (p_angle < 90) {
      int dx = dr[p_angle];
      for (int i = 0; i < h; i++) {
        int32_t idx = (i + 1) * dx;
        for (int j = 0; j < w; j++) {
          int32_t b = (idx >> 6) + j;
          int sh = (int)((idx >> 1) & 0x1F);
          out[i * w + j] = b < max_base
              ? ((ae[b] * (32 - sh) + ae[b + 1] * sh + 16) >> 5)
              : ae[max_base];
        }
      }
      return;
    }
    if (p_angle < 180) {
      int dx = dr[180 - p_angle];
      int dy = dr[p_angle - 90];
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int32_t idx = (j << 6) - (i + 1) * dx;
          int32_t b = idx >> 6;
          int32_t v;
          if (b >= -1) {
            int sh = (int)((idx >> 1) & 0x1F);
            int32_t a0 = b < 0 ? al : ae[b];
            int32_t a1 = ae[b + 1];
            v = (a0 * (32 - sh) + a1 * sh + 16) >> 5;
          } else {
            int32_t idx2 = (i << 6) - (j + 1) * dy;
            int32_t b2 = idx2 >> 6;
            int sh2 = (int)((idx2 >> 1) & 0x1F);
            int32_t l0 = b2 < 0 ? al : le[b2];
            int32_t l1 = b2 + 1 < 0 ? al : le[b2 + 1];
            v = (l0 * (32 - sh2) + l1 * sh2 + 16) >> 5;
          }
          out[i * w + j] = v;
        }
      return;
    }
    int dy = dr[270 - p_angle];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int32_t idx = (j + 1) * dy;
        int32_t b = (idx >> 6) + i;
        int sh = (int)((idx >> 1) & 0x1F);
        out[i * w + j] = b < max_base
            ? ((le[b] * (32 - sh) + le[b + 1] * sh + 16) >> 5)
            : le[max_base];
      }
    return;
  }
  // smooth family + paeth (9..12)
  const uint8_t* wh = g_tables.sm_weights[bitlength((uint32_t)h) - 3].data();
  const uint8_t* ww = g_tables.sm_weights[bitlength((uint32_t)w) - 3].data();
  int32_t below = le[h - 1], right = ae[w - 1];
  switch (mode) {
    case 9:
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int32_t t = wh[i] * ae[j] + (256 - wh[i]) * below +
                      ww[j] * le[i] + (256 - ww[j]) * right;
          out[i * w + j] = (t + 256) >> 9;
        }
      break;
    case 10:
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          out[i * w + j] =
              (wh[i] * ae[j] + (256 - wh[i]) * below + 128) >> 8;
      break;
    case 11:
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          out[i * w + j] =
              (ww[j] * le[i] + (256 - ww[j]) * right + 128) >> 8;
      break;
    default:  // 12 PAETH
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int32_t b = le[i] + ae[j] - al;
          int32_t pl_ = b - le[i]; if (pl_ < 0) pl_ = -pl_;
          int32_t pt = b - ae[j]; if (pt < 0) pt = -pt;
          int32_t ptl = b - al; if (ptl < 0) ptl = -ptl;
          out[i * w + j] =
              (pl_ <= pt && pl_ <= ptl) ? le[i] : (pt <= ptl ? ae[j] : al);
        }
  }
}

struct Scratch {
  std::vector<int32_t> pred;
  std::vector<float> res, tmp, coef, work;
};

// transform-domain RD cost of one candidate (f32 decision path)
static double rd_cost(const int32_t* src, const int32_t* pred, int w, int h,
                      int dc_q, int ac_q, int bd, double lam, double gain,
                      Scratch& sc) {
  int n = w * h;
  sc.res.resize(n); sc.coef.resize(n); sc.work.resize(4 * (size_t)n);
  for (int i = 0; i < n; i++) sc.res[i] = (float)(src[i] - pred[i]);
  // Lee fast DCT; sc.coef ends up TRANSPOSED (w, h) which the quant cost
  // below doesn't care about (only DC's position, still index 0) —
  // normalize the orthonormal row scales here
  fdct2d_lee(sc.res.data(), h, w, sc.coef.data(), sc.work.data());
  {
    const float r2 = 0.70710678118654752440f;
    float s = 2.0f / std::sqrt((float)(h * w));
    for (int a = 0; a < w; a++) {
      float rs = s * (a == 0 ? r2 : 1.0f);
      float* row = &sc.coef[(size_t)a * h];
      for (int b = 0; b < h; b++) row[b] *= rs;
      row[0] *= r2;
    }
  }
  float s_ac = (float)(ac_q * gain), s_dc = (float)(dc_q * gain);
  float inv_ac = 1.0f / s_ac, inv_dc = 1.0f / s_dc;
  int coeff_max = (1 << (bd + 7)) - 1;
  int max_dc = coeff_max / dc_q; if (max_dc > 32767) max_dc = 32767;
  int max_ac = coeff_max / ac_q; if (max_ac > 32767) max_ac = 32767;
  const float acb_ = (float)ac_bias_env();
  if (w > 32 || h > 32) {
    // TX_64-family: only the top-left 32x32 coefficient area is coded;
    // the rest is pure distortion (numpy `tail`, encoder._batch_search).
    // coef layout here is TRANSPOSED (a over w, b over h), index a*h+b.
    int cw_ = w > 32 ? 32 : w, ch_ = h > 32 ? 32 : h;
    double cost = 0.0, tail = 0.0;
    int rate_abs = 0, rate_nz = 0;
    for (int a = 0; a < w; a++) {
      const float* col = &sc.coef[(size_t)a * h];
      if (a < cw_) {
        for (int b = (a == 0 ? 1 : 0); b < ch_; b++) {
          float c_ = col[b];
          float at = std::fabs(c_) * inv_ac;
          int la = (int)(at + acb_);
          la = la > max_ac ? max_ac : la;
          float e = std::fabs(c_) - la * s_ac;
          cost += (double)e * e;
          rate_abs += la;
          rate_nz += la != 0;
        }
        for (int b = ch_; b < h; b++)
          tail += (double)col[b] * col[b];
      } else {
        for (int b = 0; b < h; b++) tail += (double)col[b] * col[b];
      }
    }
    float t0 = sc.coef[0] * inv_dc;
    int la0 = (int)(std::fabs(t0) + 0.5f);
    if (la0 > max_dc) la0 = max_dc;
    int lvv0 = t0 < 0.0f ? -la0 : la0;
    float e0 = sc.coef[0] - lvv0 * s_dc;
    cost += (double)e0 * e0;
    rate_abs += la0;
    rate_nz += la0 != 0;
    return cost + tail + lam * (double)(rate_abs + 2 * rate_nz);
  }
  // DC (deadzone 0.5), then a branch-free AC loop (deadzone AC_BIAS,
  // shared with the pass-2 quantizer) the compiler can vectorize:
  // 4-way unrolled float accumulators
  const float acb = acb_;
  float t0 = sc.coef[0] * inv_dc;
  int la0 = (int)(std::fabs(t0) + 0.5f);
  if (la0 > max_dc) la0 = max_dc;
  int lvv0 = t0 < 0.0f ? -la0 : la0;
  float e0 = sc.coef[0] - lvv0 * s_dc;
  double cost = (double)e0 * e0;
  int rate_abs = la0, rate_nz = la0 != 0;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
  int ra0 = 0, ra1 = 0, ra2 = 0, ra3 = 0;
  int rn0 = 0, rn1 = 0, rn2 = 0, rn3 = 0;
  int i = 1;
  for (; i + 3 < n; i += 4) {
#define Q(S, J)                                                         \
    {                                                                   \
      float c_ = sc.coef[i + J];                                        \
      float at = std::fabs(c_) * inv_ac;                                \
      int la = (int)(at + acb);                                       \
      la = la > max_ac ? max_ac : la;                                   \
      float e = std::fabs(c_) - la * s_ac;                              \
      acc##S += e * e;                                                  \
      ra##S += la;                                                      \
      rn##S += la != 0;                                                 \
    }
    Q(0, 0) Q(1, 1) Q(2, 2) Q(3, 3)
#undef Q
  }
  for (; i < n; i++) {
    float c_ = sc.coef[i];
    float at = std::fabs(c_) * inv_ac;
    int la = (int)(at + acb);
    la = la > max_ac ? max_ac : la;
    float e = std::fabs(c_) - la * s_ac;
    acc0 += e * e;
    ra0 += la;
    rn0 += la != 0;
  }
  cost += (double)((acc0 + acc1) + (acc2 + acc3));
  rate_abs += ra0 + ra1 + ra2 + ra3;
  rate_nz += rn0 + rn1 + rn2 + rn3;
  return cost + lam * (double)(rate_abs + 2 * rate_nz);
}

}  // namespace search

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// Output filters: deblocking (spec 7.14 mirror). The encoder runs these on
// its decoder-exact reconstruction to (a) obtain the exact frame the decoder
// will feed into CDEF/loop-restoration, and (b) search filter parameters by
// measuring real output error. Assumes the headers this encoder writes:
// uniform filter levels, sharpness 0, no deltas, no segmentation, 4:4:4.
// ---------------------------------------------------------------------------

namespace deblock {

static inline int32_t iabs(int32_t v) { return v < 0 ? -v : v; }
static inline int32_t clip3(int32_t lo, int32_t hi, int32_t v) {
  return v < lo ? lo : (v > hi ? hi : v);
}
static inline int32_t rnd2(int32_t v, int n) { return (v + (1 << (n - 1))) >> n; }

struct LineCtx {
  int32_t limit, blimit, thresh;  // already bd-scaled
  int32_t clampLo, clampHi;       // signed filter clamp (+-(1<<(bd-1)))
  int32_t maxv;                   // (1<<bd)-1
  int32_t flatF;                  // 1 << (bd-8)
};

// filter one 1-pixel line across an edge; px points AT q0, pitch steps
// from p-side to q-side (px[-pitch] == p0). size in {4, 6, 8, 14}.
static void filter_line(int32_t* px, int pitch, int size, const LineCtx& c) {
  const int32_t q0 = px[0], q1 = px[pitch], q2 = px[2 * pitch],
                q3 = px[3 * pitch];
  const int32_t p0 = px[-pitch], p1 = px[-2 * pitch], p2 = px[-3 * pitch],
                p3 = px[-4 * pitch];
  bool mask = iabs(p1 - p0) <= c.limit && iabs(q1 - q0) <= c.limit &&
              2 * iabs(p0 - q0) + (iabs(p1 - q1) >> 1) <= c.blimit;
  if (size >= 8) {
    mask = mask && iabs(p2 - p1) <= c.limit && iabs(q2 - q1) <= c.limit &&
           iabs(p3 - p2) <= c.limit && iabs(q3 - q2) <= c.limit;
  } else if (size == 6) {
    mask = mask && iabs(p2 - p1) <= c.limit && iabs(q2 - q1) <= c.limit;
  }
  if (!mask) return;

  const int32_t F = c.flatF;
  if (size == 6) {
    bool flat = iabs(p1 - p0) <= F && iabs(q1 - q0) <= F &&
                iabs(p2 - p0) <= F && iabs(q2 - q0) <= F;
    if (flat) {
      px[-2 * pitch] = rnd2(p2 * 3 + p1 * 2 + p0 * 2 + q0, 3);
      px[-pitch] = rnd2(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1, 3);
      px[0] = rnd2(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2, 3);
      px[pitch] = rnd2(p0 + q0 * 2 + q1 * 2 + q2 * 3, 3);
      return;
    }
  } else if (size >= 8) {
    bool flat = iabs(p1 - p0) <= F && iabs(q1 - q0) <= F &&
                iabs(p2 - p0) <= F && iabs(q2 - q0) <= F &&
                iabs(p3 - p0) <= F && iabs(q3 - q0) <= F;
    if (flat && size == 14) {
      const int32_t q4 = px[4 * pitch], q5 = px[5 * pitch],
                    q6 = px[6 * pitch];
      const int32_t p4 = px[-5 * pitch], p5 = px[-6 * pitch],
                    p6 = px[-7 * pitch];
      bool flat2 = iabs(p6 - p0) <= F && iabs(q6 - q0) <= F &&
                   iabs(p5 - p0) <= F && iabs(q5 - q0) <= F &&
                   iabs(p4 - p0) <= F && iabs(q4 - q0) <= F;
      if (flat2) {
        px[-6 * pitch] =
            rnd2(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0, 4);
        px[-5 * pitch] = rnd2(
            p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1, 4);
        px[-4 * pitch] = rnd2(
            p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2,
            4);
        px[-3 * pitch] =
            rnd2(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 +
                     q2 + q3,
                 4);
        px[-2 * pitch] = rnd2(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 +
                                  p0 * 2 + q0 + q1 + q2 + q3 + q4,
                              4);
        px[-pitch] = rnd2(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 +
                              q1 + q2 + q3 + q4 + q5,
                          4);
        px[0] = rnd2(p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 +
                         q3 + q4 + q5 + q6,
                     4);
        px[pitch] = rnd2(p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 +
                             q3 + q4 + q5 + q6 * 2,
                         4);
        px[2 * pitch] = rnd2(p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 +
                                 q3 * 2 + q4 + q5 + q6 * 3,
                             4);
        px[3 * pitch] = rnd2(
            p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4,
            4);
        px[4 * pitch] = rnd2(
            p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5, 4);
        px[5 * pitch] =
            rnd2(p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7, 4);
        return;
      }
    }
    if (flat) {
      px[-3 * pitch] = rnd2(p3 * 3 + p2 * 2 + p1 + p0 + q0, 3);
      px[-2 * pitch] = rnd2(p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1, 3);
      px[-pitch] = rnd2(p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2, 3);
      px[0] = rnd2(p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3, 3);
      px[pitch] = rnd2(p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2, 3);
      px[2 * pitch] = rnd2(p0 + q0 + q1 + q2 * 2 + q3 * 3, 3);
      return;
    }
  }
  // narrow filter (filter4)
  bool hev = iabs(p1 - p0) > c.thresh || iabs(q1 - q0) > c.thresh;
  int32_t f = hev ? clip3(c.clampLo, c.clampHi, p1 - q1) : 0;
  f = clip3(c.clampLo, c.clampHi, f + 3 * (q0 - p0));
  int32_t f1 = clip3(c.clampLo, c.clampHi, f + 4) >> 3;
  int32_t f2 = clip3(c.clampLo, c.clampHi, f + 3) >> 3;
  px[0] = clip3(0, c.maxv, q0 - f1);
  px[-pitch] = clip3(0, c.maxv, p0 + f2);
  if (!hev) {
    int32_t f3 = (f1 + 1) >> 1;
    px[pitch] = clip3(0, c.maxv, q1 - f3);
    px[-2 * pitch] = clip3(0, c.maxv, p1 + f3);
  }
}

static void make_ctx(LineCtx& c, int lvl, int bit_depth) {
  // sharpness == 0
  int limit = lvl < 1 ? 1 : lvl;
  int blimit = 2 * (lvl + 2) + limit;
  int thresh = lvl >> 4;
  int s = bit_depth - 8;
  c.limit = limit << s;
  c.blimit = blimit << s;
  c.thresh = thresh << s;
  c.clampLo = -(1 << (bit_depth - 1));
  c.clampHi = (1 << (bit_depth - 1)) - 1;
  c.maxv = (1 << bit_depth) - 1;
  c.flatF = 1 << s;
}

}  // namespace deblock

// ---------------------------------------------------------------------------
// CDEF (spec 7.15 mirror): direction search + primary/secondary filter on
// the deblocked frame. The encoder simulates it to chain the decoder's
// output pipeline (deblock -> CDEF -> LR) and to search the signaled
// strengths by real output error. 4:4:4 / monochrome (no subsampled dir
// conversion needed).
// ---------------------------------------------------------------------------

namespace cdefns {

// {dy, dx} at distances 1 and 2 for the 8 directions (spec Cdef_Directions)
static const int DIRS[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
    {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}},
};
static const int PRI_TAPS[2][2] = {{4, 2}, {3, 3}};
static const int SEC_TAPS[2] = {2, 1};
// 840 / count (spec Div_Table)
static const int DIV_TABLE[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};

static inline int floor_log2(int v) {
  int r = 0;
  while (v > 1) { v >>= 1; r++; }
  return r;
}

// constrain with the damping adjustment precomputed (threshold constant
// across a block: hoists the floor_log2 loop out of the per-pixel path)
static inline int constrain_pre(int diff, int threshold, int adj) {
  const int a = diff < 0 ? -diff : diff;
  int v = threshold - (a >> adj);
  v = v < 0 ? 0 : v;
  v = a < v ? a : v;
  return diff < 0 ? -v : v;
}

static inline int constrain(int diff, int threshold, int damping) {
  if (!threshold) return 0;
  const int adj = damping - floor_log2(threshold) > 0
                      ? damping - floor_log2(threshold)
                      : 0;
  const int a = diff < 0 ? -diff : diff;
  int v = threshold - (a >> adj);
  if (v < 0) v = 0;
  if (a < v) v = a;
  return diff < 0 ? -v : v;
}

// direction + variance of one 8x8 from the (deblocked) luma (spec 7.15.2)
static void direction(const int32_t* img, int stride, int bd, int* out_dir,
                      int32_t* out_var) {
  int32_t partial[8][15];
  std::memset(partial, 0, sizeof(partial));
  const int shift = bd - 8;
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) {
      const int x = (img[i * stride + j] >> shift) - 128;
      partial[0][i + j] += x;
      partial[1][i + (j >> 1)] += x;
      partial[2][i] += x;
      partial[3][3 + i - (j >> 1)] += x;
      partial[4][7 + i - j] += x;
      partial[5][3 - (i >> 1) + j] += x;
      partial[6][j] += x;
      partial[7][(i >> 1) + j] += x;
    }
  int64_t cost[8] = {0};
  for (int i = 0; i < 8; i++) {
    cost[2] += (int64_t)partial[2][i] * partial[2][i];
    cost[6] += (int64_t)partial[6][i] * partial[6][i];
  }
  cost[2] *= 105;
  cost[6] *= 105;
  for (int d = 0; d < 8; d += 4) {
    for (int i = 0; i < 7; i++)
      cost[d] += DIV_TABLE[i + 1] * ((int64_t)partial[d][i] * partial[d][i] +
                                     (int64_t)partial[d][14 - i] *
                                         partial[d][14 - i]);
    cost[d] += 105 * (int64_t)partial[d][7] * partial[d][7];
  }
  for (int d = 1; d < 8; d += 2) {
    if (d == 2 || d == 6) continue;
    for (int i = 0; i < 11; i++) {
      int count = 2 * (i + 1);
      const int rcount = 2 * (11 - i);
      if (rcount < count) count = rcount;
      if (count > 8) count = 8;
      cost[d] += DIV_TABLE[count] * (int64_t)partial[d][i] * partial[d][i];
    }
  }
  int best = 0;
  for (int d = 1; d < 8; d++)
    if (cost[d] > cost[best]) best = d;
  *out_dir = best;
  *out_var = (int32_t)((cost[best] - cost[(best + 4) & 7]) >> 10);
}

struct FilterParams {
  int pri, sec, damping, bd, coeff_shift;
};

// filter one 8x8 at (y0, x0) of `in` (pre-CDEF), writing to out8 (8x8,
// row-major) — only the fh x fw valid area is computed. cw/ch: coded frame
// dims (availability bound).
static void filter8(const int32_t* __restrict in, int stride, int y0,
                    int x0, int fw, int fh, int cw, int ch, int dir,
                    int32_t var, bool luma, const FilterParams& fp,
                    int32_t* __restrict out8) {
  int pri = fp.pri << fp.coeff_shift;
  const int sec = fp.sec << fp.coeff_shift;
  int damping = fp.damping + fp.coeff_shift;
  if (fp.pri == 0) dir = 0;
  if (luma) {
    if (pri) {
      const int vs = (var >> 6) ? (floor_log2(var >> 6) < 12
                                       ? floor_log2(var >> 6)
                                       : 12)
                                : 0;
      pri = var ? (pri * (4 + vs) + 8) >> 4 : 0;
    }
  } else {
    damping -= 1;
  }
  const int pt = (pri >> fp.coeff_shift) & 1;  // taps pick: adjusted strength
  // interior fast path: every tap in bounds -> fixed offsets, branchless
  // constrain, compile-time tap counts (HP/HS) so the tap loops unroll
  // and the j loop vectorizes
  if (y0 >= 2 && x0 >= 2 && y0 + fh + 2 <= ch && x0 + fw + 2 <= cw
      && (pri || sec)) {
    const int adj_p = pri ? (damping > floor_log2(pri) ? damping - floor_log2(pri) : 0) : 0;
    const int adj_s = sec ? (damping > floor_log2(sec) ? damping - floor_log2(sec) : 0) : 0;
    ptrdiff_t poff[4];
    int pw[4];
    for (int k = 0; k < 2; k++)
      for (int s = -1, q = 0; s <= 1; s += 2, q = 1) {
        poff[k * 2 + q] = (ptrdiff_t)s * DIRS[dir][k][0] * stride
                          + s * DIRS[dir][k][1];
        pw[k * 2 + q] = PRI_TAPS[pt][k];
      }
    ptrdiff_t soff[8];
    int sw[8];
    int ns = 0;
    for (int dd = 2; dd <= 6; dd += 4) {
      const int d2 = (dir + dd) & 7;
      for (int k = 0; k < 2; k++)
        for (int s = -1; s <= 1; s += 2) {
          soff[ns] = (ptrdiff_t)s * DIRS[d2][k][0] * stride
                     + s * DIRS[d2][k][1];
          sw[ns++] = SEC_TAPS[k];
        }
    }
    auto run = [&](auto hp, auto hs) {
      constexpr bool HP = decltype(hp)::value;
      constexpr bool HS = decltype(hs)::value;
      for (int i = 0; i < fh; i++) {
        const int32_t* row = in + (size_t)(y0 + i) * stride + x0;
        int32_t* orow = out8 + i * 8;
        for (int j = 0; j < fw; j++) {
          const int32_t px = row[j];
          int sum = 0;
          int32_t mn = px, mx = px;
          if (HP) {
            for (int k = 0; k < 4; k++) {
              const int32_t p = row[j + poff[k]];
              const int d = p - px;
              int a = d < 0 ? -d : d;
              int v = pri - (a >> adj_p);
              v = v < 0 ? 0 : v;
              v = a < v ? a : v;
              sum += pw[k] * (d < 0 ? -v : v);
              mn = p < mn ? p : mn;
              mx = p > mx ? p : mx;
            }
          }
          if (HS) {
            for (int k = 0; k < 8; k++) {
              const int32_t p = row[j + soff[k]];
              const int d = p - px;
              int a = d < 0 ? -d : d;
              int v = sec - (a >> adj_s);
              v = v < 0 ? 0 : v;
              v = a < v ? a : v;
              sum += sw[k] * (d < 0 ? -v : v);
              mn = p < mn ? p : mn;
              mx = p > mx ? p : mx;
            }
          }
          int32_t v = px + ((8 + sum - (sum < 0)) >> 4);
          v = v < mn ? mn : v;
          v = v > mx ? mx : v;
          orow[j] = v;
        }
      }
    };
    using T = std::true_type;
    using F = std::false_type;
    if (pri && sec) run(T{}, T{});
    else if (pri) run(T{}, F{});
    else run(F{}, T{});
    return;
  }
  for (int i = 0; i < fh; i++)
    for (int j = 0; j < fw; j++) {
      const int y = y0 + i, x = x0 + j;
      const int32_t px = in[(size_t)y * stride + x];
      int sum = 0;
      int32_t mn = px, mx = px;
      if (pri) {
        for (int k = 0; k < 2; k++)
          for (int s = -1; s <= 1; s += 2) {
            const int yy = y + s * DIRS[dir][k][0];
            const int xx = x + s * DIRS[dir][k][1];
            if (yy < 0 || yy >= ch || xx < 0 || xx >= cw) continue;
            const int32_t p = in[(size_t)yy * stride + xx];
            sum += PRI_TAPS[pt][k] * constrain(p - px, pri, damping);
            if (p < mn) mn = p;
            if (p > mx) mx = p;
          }
      }
      if (sec) {
        for (int dd = 2; dd <= 6; dd += 4) {  // dir+2, dir+6 (mod 8)
          const int d2 = (dir + dd) & 7;
          for (int k = 0; k < 2; k++)
            for (int s = -1; s <= 1; s += 2) {
              const int yy = y + s * DIRS[d2][k][0];
              const int xx = x + s * DIRS[d2][k][1];
              if (yy < 0 || yy >= ch || xx < 0 || xx >= cw) continue;
              const int32_t p = in[(size_t)yy * stride + xx];
              sum += SEC_TAPS[k] * constrain(p - px, sec, damping);
              if (p < mn) mn = p;
              if (p > mx) mx = p;
            }
        }
      }
      int32_t v = px + ((8 + sum - (sum < 0)) >> 4);
      if (v < mn) v = mn;
      if (v > mx) v = mx;
      out8[i * 8 + j] = v;
    }
}

// ---------------------------------------------------------------------------
// Batched strength search: one pass over the frame evaluating ALL
// (primary, secondary) strength combos at once. The filter output is
// px + ((8 + psum + ssum) >> 4) clamped to the visited-tap min/max, where
// psum depends only on the primary strength and ssum only on the
// secondary; both are computed per candidate per pixel, then combined
// cheaply per combo. The secondary tap POSITIONS depend on whether the
// signaled primary is zero (dir is forced 0 then), so two ssum variants
// are kept. ~25x cheaper than re-filtering the frame per candidate.
// ---------------------------------------------------------------------------

static const int SEC_ACT[4] = {0, 1, 2, 4};

// 8-lane int32 vectors (GCC vector extensions -> AVX2): the strength
// search evaluates every candidate combo per pixel; one vector = one
// 8-px block row
typedef int32_t v8i __attribute__((vector_size(32)));
static inline v8i v8load(const int32_t* p) {
  v8i v;
  __builtin_memcpy(&v, p, 32);
  return v;
}
static inline v8i v8bc(int32_t x) {
  return v8i{x, x, x, x, x, x, x, x};
}
static inline int64_t v8sum(v8i v) {
  int64_t s = 0;
  for (int i = 0; i < 8; i++) s += v[i];
  return s;
}

struct SearchPlaneArgs {
  const int32_t* in;
  const int32_t* src;
  int Hp, Wp, mi_rows, mi_cols, bit_depth, damping;
  const int32_t* pri_cands;
  int n_pri;
  const uint8_t* skip;
  const uint8_t* dirs;
  const int32_t* vars;
  int vis_w, vis_h;
  int sub;  // block subsampling: 1 all, 2 checkerboard, 4 quarter
  int fast_sec;  // 1: drop secondary strength 1 (search {0, 2, 4})
  int per_sb;  // 1: accumulate per 64x64 superblock (acc[(sb, combo)])
};

// accumulate SSE deltas for one plane over block rows [br0, br1) into
// acc[n_pri * 4] (combo (i, j): pri_cands[i] x SEC_ACT[j])
static void search_plane_rows(const SearchPlaneArgs& a, bool luma, int br0,
                              int br1, double* acc) {
  const int sb64c = (a.mi_cols + 15) >> 4;
  // per-sb64 integer accumulators; flushed to acc at the end (a slab is
  // whole sb64 rows, so rows [br0, br1) span sb64 rows br0/8 .. )
  const int sb0 = br0 >> 3;
  const int nsb = ((br1 + 7) >> 3) - sb0;
  std::vector<int64_t> iacc((size_t)(a.per_sb ? nsb * sb64c : 1) * 16 * 4,
                            0);
  const int sb8c = (a.mi_cols + 1) >> 1;
  const int cw = a.mi_cols * 4, ch = a.mi_rows * 4;
  const int cs = a.bit_depth - 8;
  const int NP = a.n_pri;
  // per-candidate strength after coeff shift (luma var-adjust is per
  // block, done below); chroma: fixed
  std::vector<int> base_pri(NP);
  for (int i = 0; i < NP; i++) base_pri[i] = a.pri_cands[i] << cs;
  std::vector<int> eff(NP), pt(NP), eff_adj(NP);
  int damping = a.damping + cs;
  if (!luma) damping -= 1;
  const int sec_damp = damping;
  int sadj[4] = {0, 0, 0, 0};
  for (int j = 1; j < 4; j++) {
    const int st = SEC_ACT[j] << cs;
    const int d = sec_damp - floor_log2(st);
    sadj[j] = d > 0 ? d : 0;
  }
  int psum[16];
  int ssum_d[4], ssum_z[4];
  for (int br = br0; br < br1; br++) {
    const int y0 = br * 8;
    const int fh = (ch - y0) < 8 ? (ch - y0) : 8;
    for (int bc = 0; bc < sb8c; bc++) {
      int64_t* iac = iacc.data()
          + (a.per_sb
                 ? (size_t)(((br >> 3) - sb0) * sb64c + (bc >> 3)) * 16 * 4
                 : 0);
      if (a.sub == 2 && ((br + bc) & 1)) continue;
      if (a.sub >= 4 && ((br | bc) & 1)) continue;
      const int r1 = (br * 2 + 2) < a.mi_rows ? br * 2 + 2 : a.mi_rows;
      const int c1 = (bc * 2 + 2) < a.mi_cols ? bc * 2 + 2 : a.mi_cols;
      bool all_skip = true;
      for (int r = br * 2; r < r1 && all_skip; r++)
        for (int c = bc * 2; c < c1; c++)
          if (!a.skip[(size_t)r * a.mi_cols + c]) { all_skip = false; break; }
      if (all_skip) continue;
      const int x0 = bc * 8;
      const int fw = (cw - x0) < 8 ? (cw - x0) : 8;
      // nothing to measure if the block is fully outside the visible crop
      if (y0 >= a.vis_h || x0 >= a.vis_w) continue;
      const int dir = a.dirs[br * sb8c + bc];
      const int32_t var = a.vars[br * sb8c + bc];
      for (int i = 0; i < NP; i++) {
        int p = base_pri[i];
        if (luma && p) {
          const int v6 = var >> 6;
          const int vs = v6 ? (floor_log2(v6) < 12 ? floor_log2(v6) : 12) : 0;
          p = var ? (p * (4 + vs) + 8) >> 4 : 0;
        }
        eff[i] = p;
        pt[i] = (p >> cs) & 1;
        const int d = p ? damping - floor_log2(p) : 0;
        eff_adj[i] = d > 0 ? d : 0;
      }
      const int ih = fh < a.vis_h - y0 ? fh : a.vis_h - y0;
      const int iw = fw < a.vis_w - x0 ? fw : a.vis_w - x0;
      // interior 8x8 fast path: every tap in bounds and the full block
      // visible -> fixed-size per-row lanes the compiler vectorizes.
      // Integer arithmetic identical to the general path below.
      if (ih == 8 && iw == 8 && fh == 8 && fw == 8 && y0 >= 2 && x0 >= 2
          && y0 + 10 <= ch && x0 + 10 <= cw) {
        ptrdiff_t poff[4];
        int pk_[4];
        {
          int q = 0;
          for (int k = 0; k < 2; k++)
            for (int s = -1; s <= 1; s += 2) {
              poff[q] = (ptrdiff_t)s * DIRS[dir][k][0] * a.Wp
                        + s * DIRS[dir][k][1];
              pk_[q++] = k;
            }
        }
        ptrdiff_t soff_d[8], soff_z[8];
        int sk_[8];
        {
          int q = 0;
          for (int dd = 2; dd <= 6; dd += 4)
            for (int k = 0; k < 2; k++)
              for (int s = -1; s <= 1; s += 2) {
                const int d2 = (dir + dd) & 7, dz = dd & 7;
                soff_d[q] = (ptrdiff_t)s * DIRS[d2][k][0] * a.Wp
                            + s * DIRS[d2][k][1];
                soff_z[q] = (ptrdiff_t)s * DIRS[dz][k][0] * a.Wp
                            + s * DIRS[dz][k][1];
                sk_[q++] = k;
              }
        }
        v8i vacc[16 * 4];
        for (int i = 0; i < NP * 4; i++) vacc[i] = v8bc(0);
        const v8i vz0 = v8bc(0);
        for (int ii = 0; ii < 8; ii++) {
          const int32_t* row = a.in + (size_t)(y0 + ii) * a.Wp + x0;
          const int32_t* srow = a.src + (size_t)(y0 + ii) * a.Wp + x0;
          const v8i px = v8load(row);
          v8i pdv[4], pav[4], pmn = px, pmx = px;
          for (int k = 0; k < 4; k++) {
            const v8i p = v8load(row + poff[k]);
            const v8i d = p - px;
            pdv[k] = d;
            pav[k] = d < 0 ? -d : d;
            pmn = p < pmn ? p : pmn;
            pmx = p > pmx ? p : pmx;
          }
          v8i sddv[8], sdav[8], szdv[8], szav[8];
          v8i smnd = px, smxd = px, smnz = px, smxz = px;
          for (int k = 0; k < 8; k++) {
            const v8i p = v8load(row + soff_d[k]);
            const v8i d = p - px;
            sddv[k] = d;
            sdav[k] = d < 0 ? -d : d;
            smnd = p < smnd ? p : smnd;
            smxd = p > smxd ? p : smxd;
            const v8i pz = v8load(row + soff_z[k]);
            const v8i dz_ = pz - px;
            szdv[k] = dz_;
            szav[k] = dz_ < 0 ? -dz_ : dz_;
            smnz = pz < smnz ? pz : smnz;
            smxz = pz > smxz ? pz : smxz;
          }
          v8i psv[16];
          for (int i = 0; i < NP; i++) {
            if (!eff[i]) { psv[i] = vz0; continue; }
            const v8i e = v8bc(eff[i]);
            const int ad = eff_adj[i];
            const int w0 = PRI_TAPS[pt[i]][0], w1 = PRI_TAPS[pt[i]][1];
            v8i s = vz0;
            for (int k = 0; k < 4; k++) {
              v8i v = e - (pav[k] >> ad);
              v = v < vz0 ? vz0 : v;
              v = pav[k] < v ? pav[k] : v;
              s += (pk_[k] == 0 ? w0 : w1) * (pdv[k] < vz0 ? -v : v);
            }
            psv[i] = s;
          }
          v8i ssd[4], ssz[4];
          ssd[0] = vz0; ssz[0] = vz0;
          for (int jq = 1; jq < 4; jq++) {
            if (a.fast_sec && jq == 1) { ssd[jq] = vz0; ssz[jq] = vz0; continue; }
            const v8i st = v8bc(SEC_ACT[jq] << cs);
            const int ad = sadj[jq];
            v8i sd = vz0, sz = vz0;
            for (int k = 0; k < 8; k++) {
              v8i v = st - (sdav[k] >> ad);
              v = v < vz0 ? vz0 : v;
              v = sdav[k] < v ? sdav[k] : v;
              sd += SEC_TAPS[sk_[k]] * (sddv[k] < vz0 ? -v : v);
              v8i vv = st - (szav[k] >> ad);
              vv = vv < vz0 ? vz0 : vv;
              vv = szav[k] < vv ? szav[k] : vv;
              sz += SEC_TAPS[sk_[k]] * (szdv[k] < vz0 ? -vv : vv);
            }
            ssd[jq] = sd;
            ssz[jq] = sz;
          }
          const v8i sref = v8load(srow);
          const v8i od = px - sref;
          const v8i base_e = od * od;
          const v8i v8_8 = v8bc(8);
          for (int i = 0; i < NP; i++) {
            const bool sig_pri = a.pri_cands[i] != 0;
            const v8i* ss = sig_pri ? ssd : ssz;
            const v8i smn_ = sig_pri ? smnd : smnz;
            const v8i smx_ = sig_pri ? smxd : smxz;
            const bool use_p = eff[i] && sig_pri;
            for (int jq = 0; jq < 4; jq++) {
              if (!sig_pri && jq == 0) continue;
              if (a.fast_sec && jq == 1) continue;
              v8i sum = vz0, mn = px, mx = px;
              if (use_p) {
                sum += psv[i];
                mn = pmn < mn ? pmn : mn;
                mx = pmx > mx ? pmx : mx;
              }
              if (jq) {
                sum += ss[jq];
                mn = smn_ < mn ? smn_ : mn;
                mx = smx_ > mx ? smx_ : mx;
              }
              // (sum < 0) as a vector mask is -1 where true: 8+sum+mask
              // == the scalar 8 + sum - (sum < 0)
              v8i v = px + ((v8_8 + sum + (sum < vz0)) >> 4);
              v = v < mn ? mn : v;
              v = v > mx ? mx : v;
              const v8i nd = v - sref;
              vacc[i * 4 + jq] += nd * nd - base_e;
            }
          }
        }
        for (int i = 0; i < NP; i++)
          for (int jq = 0; jq < 4; jq++)
            if (!((a.pri_cands[i] == 0 && jq == 0)
                  || (a.fast_sec && jq == 1)))
              iac[i * 4 + jq] += v8sum(vacc[i * 4 + jq]);
        continue;
      }
      for (int ii = 0; ii < ih; ii++)
        for (int jj = 0; jj < iw; jj++) {
          const int y = y0 + ii, x = x0 + jj;
          const int32_t px = a.in[(size_t)y * a.Wp + x];
          // gather primary taps (available only)
          int32_t ptap[4];
          int ptk[4];  // distance index (tap weight row)
          int np_taps = 0;
          int32_t pmn = px, pmx = px;
          for (int k = 0; k < 2; k++)
            for (int s = -1; s <= 1; s += 2) {
              const int yy = y + s * DIRS[dir][k][0];
              const int xx = x + s * DIRS[dir][k][1];
              if (yy < 0 || yy >= ch || xx < 0 || xx >= cw) continue;
              const int32_t p = a.in[(size_t)yy * a.Wp + xx];
              ptap[np_taps] = p - px;
              ptk[np_taps++] = k;
              if (p < pmn) pmn = p;
              if (p > pmx) pmx = p;
            }
          // secondary taps, both dir variants (signaled pri 0 -> dir 0)
          int32_t stap_d[8], stap_z[8];
          int stk_d[8], stk_z[8];
          int ns_d = 0, ns_z = 0;
          int32_t smn_d = px, smx_d = px, smn_z = px, smx_z = px;
          for (int dd = 2; dd <= 6; dd += 4)
            for (int k = 0; k < 2; k++)
              for (int s = -1; s <= 1; s += 2) {
                int d2 = (dir + dd) & 7;
                int yy = y + s * DIRS[d2][k][0];
                int xx = x + s * DIRS[d2][k][1];
                if (yy >= 0 && yy < ch && xx >= 0 && xx < cw) {
                  const int32_t p = a.in[(size_t)yy * a.Wp + xx];
                  stap_d[ns_d] = p - px;
                  stk_d[ns_d++] = k;
                  if (p < smn_d) smn_d = p;
                  if (p > smx_d) smx_d = p;
                }
                if (dir != 0) {
                  d2 = dd & 7;
                  yy = y + s * DIRS[d2][k][0];
                  xx = x + s * DIRS[d2][k][1];
                }
                if (yy >= 0 && yy < ch && xx >= 0 && xx < cw) {
                  const int32_t p = a.in[(size_t)yy * a.Wp + xx];
                  stap_z[ns_z] = p - px;
                  stk_z[ns_z++] = k;
                  if (p < smn_z) smn_z = p;
                  if (p > smx_z) smx_z = p;
                }
              }
          // per-candidate primary sums (adj hoisted per block)
          for (int i = 0; i < NP; i++) {
            int s = 0;
            if (eff[i])
              for (int k = 0; k < np_taps; k++)
                s += PRI_TAPS[pt[i]][ptk[k]] *
                     constrain_pre(ptap[k], eff[i], eff_adj[i]);
            psum[i] = s;
          }
          // per-strength secondary sums, both variants (fast mode
          // drops the weakest nonzero secondary leg)
          ssum_d[0] = ssum_z[0] = 0;
          for (int j = 1; j < 4; j++) {
            if (a.fast_sec && j == 1) continue;
            const int st = SEC_ACT[j] << cs;
            int sd = 0, sz = 0;
            for (int k = 0; k < ns_d; k++)
              sd += SEC_TAPS[stk_d[k]] * constrain_pre(stap_d[k], st, sadj[j]);
            for (int k = 0; k < ns_z; k++)
              sz += SEC_TAPS[stk_z[k]] * constrain_pre(stap_z[k], st, sadj[j]);
            ssum_d[j] = sd;
            ssum_z[j] = sz;
          }
          const int32_t sref = a.src[(size_t)y * a.Wp + x];
          const int32_t od = px - sref;
          const int64_t base_err = (int64_t)od * od;
          for (int i = 0; i < NP; i++) {
            const bool sig_pri = a.pri_cands[i] != 0;
            const int* ss = sig_pri ? ssum_d : ssum_z;
            const int32_t smn = sig_pri ? smn_d : smn_z;
            const int32_t smx = sig_pri ? smx_d : smx_z;
            for (int j = 0; j < 4; j++) {
              if (!sig_pri && j == 0) continue;  // identity combo: delta 0
              if (a.fast_sec && j == 1) continue;
              int sum = 0;
              int32_t mn = px, mx = px;
              if (eff[i] && sig_pri) {
                sum += psum[i];
                if (pmn < mn) mn = pmn;
                if (pmx > mx) mx = pmx;
              }
              if (j) {
                sum += ss[j];
                if (smn < mn) mn = smn;
                if (smx > mx) mx = smx;
              }
              int32_t v = px + ((8 + sum - (sum < 0)) >> 4);
              if (v < mn) v = mn;
              if (v > mx) v = mx;
              const int32_t nd = v - sref;
              iac[i * 4 + j] += (int64_t)nd * nd - base_err;
            }
          }
        }
    }
  }
  if (a.per_sb) {
    for (int b = 0; b < nsb * sb64c; b++)
      for (int i = 0; i < a.n_pri * 4; i++)
        acc[(size_t)((sb0 * sb64c) + b) * (a.n_pri * 4) + i] +=
            (double)iacc[(size_t)b * 16 * 4 + i];
  } else {
    for (int i = 0; i < a.n_pri * 4; i++) acc[i] += (double)iacc[i];
  }
}

}  // namespace cdefns

extern "C" {

// Read (and with reset != 0, clear) the 7.13.3 clamp-tripwire counter;
// re-reads the env gate on reset so tests can flip it per-case.
long long tc_itx_clamp_violations(int reset) {
  long long v = g_itx_range_hits.load(std::memory_order_relaxed);
  if (reset) {
    g_itx_range_hits.store(0, std::memory_order_relaxed);
    g_itx_check.store(-1, std::memory_order_relaxed);
  }
  return v;
}

int tc_set_cdf_table(int table_id, const uint16_t* data, int n) {
  std::vector<uint16_t>* dst = nullptr;
  SpecTables& T = g_tables;
  switch (table_id) {
    case 0: dst = &T.partition; break;
    case 1: dst = &T.kf_y; break;
    case 2: dst = &T.uv; break;
    case 3: dst = &T.skip; break;
    case 4: dst = &T.angle; break;
    case 5: dst = &T.txb_skip; break;
    case 6: dst = &T.eob_pt16; break;
    case 7: dst = &T.eob_pt32; break;
    case 8: dst = &T.eob_pt64; break;
    case 9: dst = &T.eob_pt128; break;
    case 10: dst = &T.eob_pt256; break;
    case 11: dst = &T.eob_pt512; break;
    case 12: dst = &T.eob_pt1024; break;
    case 13: dst = &T.eob_extra; break;
    case 14: dst = &T.base; break;
    case 15: dst = &T.base_eob; break;
    case 16: dst = &T.br; break;
    case 17: dst = &T.dc_sign; break;
    case 18: dst = &T.intra_ext_tx; break;
    case 19: dst = &T.cfl_sign; break;
    case 20: dst = &T.cfl_alpha; break;
    case 21: dst = &T.trellis_base; break;
    case 22: dst = &T.trellis_base_eob; break;
    case 23: dst = &T.trellis_br; break;
    default: return -1;
  }
  dst->assign(data, data + n);
  return 0;
}

int tc_set_scan(int w, int h, const int32_t* scan, const uint8_t* nzoff) {
  if (w < 4 || w > 32 || h < 4 || h > 32) return -1;
  int idx = size_idx(w, h);
  g_tables.scan[idx].assign(scan, scan + (size_t)w * h);
  g_tables.nzoff[idx].assign(nzoff, nzoff + (size_t)w * h);
  return 0;
}

int tc_set_sm_weights(int n, const uint8_t* w) {
  if (n < 4 || n > 64) return -1;
  g_tables.sm_weights[bitlength((uint32_t)n) - 3].assign(w, w + n);
  return 0;
}

int tc_set_dr(const int32_t* dr) {
  g_tables.dr.assign(dr, dr + 90);
  return 0;
}

int tc_set_cospi(const int32_t* c) {
  g_tables.cospi.assign(c, c + 64);
  return 0;
}

int tc_set_sinpi(const int32_t* sp) {
  g_sinpi.assign(sp, sp + 5);
  return 0;
}

int tc_set_fwd_adst(int n, const double* m) {
  int idx = n == 4 ? 0 : n == 8 ? 1 : n == 16 ? 2 : -1;
  if (idx < 0) return -1;
  g_fwd_adst[idx].assign(m, m + (size_t)n * n);
  return 0;
}

// Full pass-2 tile encode: skeleton ops (partition walk + per-block modes),
// native predict/transform/quantize/reconstruct, entropy coding.
// src: (num_planes, Hp, Wp) plane-major padded int32 source.
int bp_encode_tile(const int32_t* src, int Hp, int Wp, int mi_rows,
                   int mi_cols, int mi_r0, int mi_r1, int mi_c0, int mi_c1,
                   int base_q, int bit_depth, int num_planes,
                   int disable_cdf_update, int reduced_tx_set,
                   int dc_q, int ac_q, double gain, double lam,
                   int cfl_search, int edge_filter, int tx_exhaustive,
                   double eob_adapt, const double* psy_map, int psy_sb_cols,
                   const int32_t* ops, int n_ops, uint8_t* out, int cap,
                   int32_t* recon_out, int32_t* rec_ops, int rec_ops_cap,
                   int32_t* rec_levels, int rec_levels_cap,
                   int32_t* rec_sizes, int ec_off) {
  TileCoder tc;
  tc.init(mi_c0, mi_c1, mi_r0, mi_r1, base_q, num_planes, disable_cdf_update);
  tc.reduced_tx_set = reduced_tx_set != 0;
  tc.ec_off = ec_off != 0;
  BlockPipe bp;
  bp.init(src, num_planes, Hp, Wp, mi_rows, mi_cols, mi_r0, mi_c0, mi_r1,
          mi_c1, bit_depth, dc_q, ac_q, gain, lam);
  bp.qctx = q_ctx(base_q);
  bp.frame_base_q = base_q;
  bp.psy = psy_map;
  bp.psy_cols = psy_sb_cols;
  bp.cfl_search = cfl_search;
  bp.edge_filter = edge_filter;
  bp.tx_exhaustive = tx_exhaustive;
  bp.eob_adapt_cfg = eob_adapt;
  if (rec_ops) {
    bp.rops = rec_ops;
    bp.rops_cap = rec_ops_cap;
    bp.rlvl = rec_levels;
    bp.rlvl_cap = rec_levels_cap;
  }
  int i = 0;
  while (i < n_ops) {
    switch (ops[i]) {
      case OP_CLEAR_LEFT:
        tc.clear_left();
        bp.rec_row(&ops[i], OP_CLEAR_LEFT_N);
        i += OP_CLEAR_LEFT_N;
        break;
      case OP_PARTITION:
        tc.write_partition(ops[i + 1], ops[i + 2], ops[i + 3], ops[i + 4]);
        bp.rec_row(&ops[i], OP_PARTITION_N);
        i += OP_PARTITION_N;
        break;
      case OP_SPLIT_BIN:
        tc.write_split_binary(ops[i + 1], ops[i + 2], ops[i + 3], ops[i + 4],
                              ops[i + 5]);
        bp.rec_row(&ops[i], OP_SPLIT_BIN_N);
        i += OP_SPLIT_BIN_N;
        break;
      case OP_BLOCK_COMPUTE:
        bp.encode_block(tc, ops[i + 1], ops[i + 2], ops[i + 3], ops[i + 4],
                        ops[i + 5], ops[i + 6], ops[i + 7], ops[i + 8],
                        num_planes);
        i += OP_BLOCK_COMPUTE_N;
        break;
      case OP_SB_START:
        bp.reset_mask(ops[i + 1], ops[i + 2]);
        bp.rec_row(&ops[i], OP_SB_START_N);
        i += OP_SB_START_N;
        break;
      case OP_DELTA_Q: {
        // per-SB adaptive quantization: the block pipeline quantizes and
        // reconstructs with this SB's quantizers; the tile coder emits
        // the delta symbol inside the first block's mode_info
        tc.pending_qindex = ops[i + 1];
        bp.dc_q = ops[i + 2];
        bp.ac_q = ops[i + 3];
        double qstep = bp.ac_q * 0.125;
        bp.lam = 0.8 * qstep * qstep / 16.0;
        bp.rec_row(&ops[i], OP_DELTA_Q_N);
        i += OP_DELTA_Q_N;
        break;
      }
      case OP_LR:
        tc.write_lr_unit(ops[i + 1], ops[i + 2], &ops[i + 3]);
        bp.rec_row(&ops[i], OP_LR_N);
        i += OP_LR_N;
        break;
      case OP_LR_UNIT:
        tc.write_lr_generic(ops[i + 1], ops[i + 2], ops[i + 3], ops[i + 4],
                            ops[i + 5], ops[i + 6], &ops[i + 7]);
        bp.rec_row(&ops[i], OP_LR_UNIT_N);
        i += OP_LR_UNIT_N;
        break;
      default:
        return -2;
    }
  }
  if (rec_sizes) {
    rec_sizes[0] = bp.rec_overflow ? -1 : bp.rops_n;
    rec_sizes[1] = bp.rec_overflow ? -1 : bp.rlvl_n;
  }
#ifdef CAVIF_BP_PROF
  fprintf(stderr,
          "[bp prof] predict %.1fms fwd+quant %.1fms inv+recon %.1fms "
          "ec %.1fms\n",
          g_bpt[0] * 1e3, g_bpt[1] * 1e3, g_bpt[2] * 1e3, g_bpt[3] * 1e3);
  for (int i = 0; i < 4; i++) g_bpt[i] = 0.0;
#endif
  if (recon_out) {
    // copy this tile's pixel region into the caller's (P, Hp, Wp) buffer
    int y0 = mi_r0 * 4, y1 = (mi_r1 < mi_rows ? mi_r1 : mi_rows) * 4;
    int x0 = mi_c0 * 4, x1 = (mi_c1 < mi_cols ? mi_c1 : mi_cols) * 4;
    if (y1 > Hp) y1 = Hp;
    if (x1 > Wp) x1 = Wp;
    for (int pl = 0; pl < num_planes; pl++)
      for (int y = y0; y < y1; y++)
        memcpy(recon_out + ((size_t)pl * Hp + y) * Wp + x0,
               bp.recon + ((size_t)pl * Hp + y) * Wp + x0,
               (size_t)(x1 - x0) * 4);
  }
  if (ec_off) return 0;  // deferred EC: replay produces the bitstream
  return tc.enc.done(out, cap);
}

// Exact inverse transform hook for the python reconstruction path.
int tc_inv_txfm(const int32_t* levels, int ch, int cw, int txw, int txh,
                int dc_q, int ac_q, int bit_depth, int v_adst, int h_adst,
                int32_t* out) {
  if (g_tables.cospi.empty()) return -1;
  inv_txfm_exact(levels, ch, cw, txw, txh, dc_q, ac_q, bit_depth,
                 v_adst, h_adst, out);
  return 0;
}

// Returns bytes written, or -1 on error / insufficient cap.
int tc_encode_tile(int mi_col_start, int mi_col_end, int mi_row_start,
                   int mi_row_end, int base_q, int num_planes,
                   int disable_cdf_update, int reduced_tx_set,
                   const int32_t* ops, int n_ops,
                   const int32_t* levels, uint8_t* out, int cap) {
  TileCoder tc;
  tc.init(mi_col_start, mi_col_end, mi_row_start, mi_row_end, base_q,
          num_planes, disable_cdf_update);
  tc.reduced_tx_set = reduced_tx_set != 0;
  int i = 0;
  while (i < n_ops) {
    switch (ops[i]) {
      case OP_CLEAR_LEFT:
        tc.clear_left();
        i += OP_CLEAR_LEFT_N;
        break;
      case OP_PARTITION:
        tc.write_partition(ops[i + 1], ops[i + 2], ops[i + 3], ops[i + 4]);
        i += OP_PARTITION_N;
        break;
      case OP_SPLIT_BIN:
        tc.write_split_binary(ops[i + 1], ops[i + 2], ops[i + 3], ops[i + 4],
                              ops[i + 5]);
        i += OP_SPLIT_BIN_N;
        break;
      case OP_BLOCK:
        tc.write_block(ops[i + 1], ops[i + 2], ops[i + 3], ops[i + 4],
                       ops[i + 5], ops[i + 6], ops[i + 7], ops[i + 8],
                       ops[i + 9], ops[i + 10], ops[i + 11], ops[i + 12],
                       ops[i + 13]);
        i += OP_BLOCK_N;
        break;
      case OP_SB_START:
        i += OP_SB_START_N;
        break;
      case OP_DELTA_Q:
        tc.pending_qindex = ops[i + 1];
        i += OP_DELTA_Q_N;
        break;
      case OP_COEFFS:
        tc.write_coeffs(ops[i + 1], ops[i + 2], ops[i + 3], ops[i + 4],
                        ops[i + 5], ops[i + 6], ops[i + 7], ops[i + 8],
                        levels + ops[i + 9], ops[i + 10], ops[i + 11],
                        ops[i + 12]);
        i += OP_COEFFS_N;
        break;
      case OP_LR:
        tc.write_lr_unit(ops[i + 1], ops[i + 2], &ops[i + 3]);
        i += OP_LR_N;
        break;
      case OP_LR_UNIT:
        tc.write_lr_generic(ops[i + 1], ops[i + 2], ops[i + 3], ops[i + 4],
                            ops[i + 5], ops[i + 6], &ops[i + 7]);
        i += OP_LR_UNIT_N;
        break;
      default:
        return -1;
    }
  }
  return tc.enc.done(out, cap);
}


// Batched mode search over B same-sized blocks; see search:: above.
// Arrays: src (B*bh*bw), above_ext/left_ext (B*(bw+bh)) pre-synthesized,
// al/have_a/have_l (B). Outputs best mode id, angle delta, rd cost.
namespace {
namespace search {

struct Params {
  int bw, bh, dc_q, ac_q, bit_depth, K, refine, force_skip;
  double lam, gain;
  int n_cand = 13;  // leading CAND_MODES considered (7 drops diagonals)
};

// Production search policies (env overrides are A/B tooling):
// - chroma candidate set: the 7 non-diagonal modes. Dropping the 6
//   delta-0 diagonals from the chroma SAD prefilter measured +0.024 dB
//   at +0.02% bytes on the A/B corpus (they won SAD slots but lost RD)
//   and cuts ~45% of chroma pass-1 prediction work.
// - descent-tier luma RD width 2 (vs the always-tier 5) with a full-K
//   re-search of the leaves the partition DP actually picks: BD-rate
//   -0.53% / +0.016 dB vs full-K everywhere, ~11% faster pass 1.
static int chroma_ncand_policy() {
  static const int v = [] {
    const char* e = getenv("CAVIF_TPU_EXP_CHROMA_NCAND");
    return e ? atoi(e) : 7;
  }();
  return v;
}
static int kdesc_policy() {
  static const int v = [] {
    const char* e = getenv("CAVIF_TPU_EXP_KDESC");
    return e ? atoi(e) : 2;
  }();
  return v;
}

// one block, ns co-decided sources (ns=1: a single plane; ns=2: the joint
// U+V chroma search — one shared uv mode, per-plane predictions/neighbors,
// costs summed; mode-rate proxies counted once since the mode is coded
// once): SAD prefilter (DC kept) -> RD on top-K -> delta refinement
static void search_one_multi(const int32_t* const* s_, const int32_t* const* ae,
                             const int32_t* const* le, const int* alv, int ns,
                             int hav_a, int hav_l, const Params& P,
                             Scratch& sc, int32_t* out_mode,
                             int32_t* out_delta, double* out_cost) {
  int bw = P.bw, bh = P.bh, n = bw * bh;
  double lam = P.lam;
  const int nc = P.n_cand;
  double sad[13];
  sc.pred.resize((size_t)13 * ns * n);
  for (int m = 0; m < nc; m++) {
    int32_t sd = 0;
    for (int s = 0; s < ns; s++) {
      int32_t* p = sc.pred.data() + (size_t)(m * ns + s) * n;
      predict_into(CAND_MODES[m], 0, ae[s], le[s], alv[s], hav_a, hav_l,
                   bw, bh, P.bit_depth, p);
      const int32_t* sp = s_[s];
      for (int i = 0; i < n; i++) {
        int d = sp[i] - p[i];
        sd += d < 0 ? -d : d;
      }
    }
    sad[m] = (double)sd + (m >= 7 ? lam * 0.5 * ns : 0.0);
  }
  if (P.force_skip) {
    int best = 0;
    double bc = 1e300;
    for (int m = 0; m < nc; m++) {
      int64_t ssi = 0;
      for (int s = 0; s < ns; s++) {
        const int32_t* p = sc.pred.data() + (size_t)(m * ns + s) * n;
        const int32_t* sp = s_[s];
        for (int i = 0; i < n; i++) {
          int32_t d = sp[i] - p[i];
          ssi += (int64_t)d * d;
        }
      }
      double ss = (double)ssi;
      if (m >= 7) ss += lam * 2.0 * ns;
      if (ss < bc) { bc = ss; best = m; }
    }
    *out_mode = best; *out_delta = 0; *out_cost = bc;
    return;
  }
  int order[13];
  for (int i = 0; i < nc; i++) order[i] = i;
  std::sort(order, order + nc,
            [&](int a_, int b_) { return sad[a_] < sad[b_]; });
  int keep[13]; int nk = 0;
  keep[nk++] = 0;  // DC always survives
  for (int i = 0; i < nc && nk < P.K; i++)
    if (order[i] != 0) keep[nk++] = order[i];
  int best = keep[0];
  double bc = 1e300;
  for (int ki = 0; ki < nk; ki++) {
    int m = keep[ki];
    double c = 0.0;
    for (int s = 0; s < ns; s++)
      c += rd_cost(s_[s], sc.pred.data() + (size_t)(m * ns + s) * n, bw, bh,
                   P.dc_q, P.ac_q, P.bit_depth, lam, P.gain, sc);
    // diag angle+mode rate proxy (A/B-tuned); x ns keeps the proxy's
    // relative weight vs the summed distortion of the joint search
    if (m >= 7) c += lam * 7.0 * ns;
    if (c < bc) { bc = c; best = m; }
  }
  int bdelta = 0;
  int bmode_id = CAND_MODES[best];
  if (P.refine && bmode_id >= 1 && bmode_id <= 8 && bw >= 8 && bh >= 8) {
    // SAD-prefilter the six angle deltas and full-RD only the best two:
    // SAD ranks deltas of the same mode reliably; vs the full 6-delta RD
    // pass this measured -0.006 dB / +45 B on the A/B corpus for ~3x
    // cheaper refinement.
    static const int DELTAS[6] = {-3, -2, -1, 1, 2, 3};
    double dsad[6];
    for (int di = 0; di < 6; di++) {
      int32_t sd = 0;
      for (int s = 0; s < ns; s++) {
        int32_t* p = sc.pred.data() + (size_t)(di * ns + s) * n;
        predict_into(bmode_id, DELTAS[di], ae[s], le[s], alv[s], hav_a,
                     hav_l, bw, bh, P.bit_depth, p);
        const int32_t* sp = s_[s];
        for (int i = 0; i < n; i++) {
          int d = sp[i] - p[i];
          sd += d < 0 ? -d : d;
        }
      }
      dsad[di] = (double)sd;
    }
    int dorder[6] = {0, 1, 2, 3, 4, 5};
    std::sort(dorder, dorder + 6,
              [&](int a_, int b_) { return dsad[a_] < dsad[b_]; });
    for (int oi = 0; oi < 2; oi++) {
      int di = dorder[oi];
      double c = lam * 6.0 * ns;
      for (int s = 0; s < ns; s++)
        c += rd_cost(s_[s], sc.pred.data() + (size_t)(di * ns + s) * n, bw,
                     bh, P.dc_q, P.ac_q, P.bit_depth, lam, P.gain, sc);
      if (c < bc) { bc = c; bdelta = DELTAS[di]; }
    }
  }
  *out_mode = best;
  *out_delta = bdelta;
  *out_cost = bc;
}

static void search_one(const int32_t* s_, const int32_t* ae,
                       const int32_t* le, int alv, int hav_a, int hav_l,
                       const Params& P, Scratch& sc, int32_t* out_mode,
                       int32_t* out_delta, double* out_cost) {
  const int32_t* ss[1] = {s_};
  const int32_t* aes[1] = {ae};
  const int32_t* les[1] = {le};
  const int alvs[1] = {alv};
  search_one_multi(ss, aes, les, alvs, 1, hav_a, hav_l, P, sc, out_mode,
                   out_delta, out_cost);
}

// Gather source + neighbor rows/cols for one plane block from the padded
// (Hp, Wp) plane (tile-top/left availability; source-synthesis rules for
// missing sides — mirrors the python _batch_search gather exactly).
static void gather_neighbors(const int32_t* sp, int Hp, int Wp, int py,
                             int px, int bw, int bh, int hav_a, int hav_l,
                             int base_px, int32_t* sd, int32_t* aed,
                             int32_t* led, int* alv_out) {
  int ext = bw + bh;
  for (int i = 0; i < bh; i++)
    for (int j = 0; j < bw; j++)
      sd[(size_t)i * bw + j] = sp[(size_t)(py + i) * Wp + px + j];
  int alv = 0;
  if (hav_a) {
    const int32_t* row = sp + (size_t)(py - 1) * Wp;
    for (int i = 0; i < ext; i++) {
      int c = px + i;
      aed[i] = row[c < Wp ? c : Wp - 1];
    }
  }
  if (hav_l) {
    for (int i = 0; i < ext; i++) {
      int r = py + i;
      led[i] = sp[(size_t)(r < Hp ? r : Hp - 1) * Wp + px - 1];
    }
  }
  if (hav_a && hav_l) {
    alv = sp[(size_t)(py - 1) * Wp + px - 1];
  } else if (!hav_a && !hav_l) {
    for (int i = 0; i < ext; i++) aed[i] = base_px - 1;
    for (int i = 0; i < ext; i++) led[i] = base_px + 1;
    alv = base_px;
  } else if (!hav_a) {
    for (int i = 0; i < ext; i++) aed[i] = led[0];
    alv = led[0];
  } else {
    for (int i = 0; i < ext; i++) led[i] = aed[0];
    alv = aed[0];
  }
  *alv_out = alv;
}

// Gather + search one block of plane `pl` (ns=2: joint U+V co-decision).
// bufs must hold 2*n / 2*ext each.
static void search_item(const int32_t* planes, int nP, int Hp, int Wp,
                        int pl, int py, int px, int py0, int px0, int joint,
                        const Params& P, Scratch& sc, int32_t* buf_src,
                        int32_t* buf_ae, int32_t* buf_le, int32_t* out_mode,
                        int32_t* out_delta, double* out_cost) {
  int n = P.bw * P.bh, ext = P.bw + P.bh;
  int base_px = 1 << (P.bit_depth - 1);
  Params Pc = P;
  if (pl > 0 && chroma_ncand_policy() < Pc.n_cand)
    Pc.n_cand = chroma_ncand_policy();
  const int ns = (joint && pl == 1 && nP > 2) ? 2 : 1;
  int hav_a = py > py0, hav_l = px > px0;
  const int32_t* ss[2];
  const int32_t* aes[2];
  const int32_t* les[2];
  int alvs[2];
  for (int s = 0; s < ns; s++) {
    const int32_t* sp = planes + (size_t)(pl + s) * Hp * Wp;
    int32_t* sd = buf_src + (size_t)s * n;
    int32_t* aed = buf_ae + (size_t)s * ext;
    int32_t* led = buf_le + (size_t)s * ext;
    gather_neighbors(sp, Hp, Wp, py, px, P.bw, P.bh, hav_a, hav_l, base_px,
                     sd, aed, led, &alvs[s]);
    ss[s] = sd;
    aes[s] = aed;
    les[s] = led;
  }
  search_one_multi(ss, aes, les, alvs, ns, hav_a, hav_l, Pc, sc, out_mode,
                   out_delta, out_cost);
}

static void run_threaded(int B, int n_threads,
                         const std::function<void(int, int)>& worker) {
  if (n_threads <= 1 || B < 64) {
    worker(0, B);
    return;
  }
  std::vector<std::thread> ths;
  int per = (B + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int b0 = t * per, b1 = b0 + per < B ? b0 + per : B;
    if (b0 >= b1) break;
    ths.emplace_back(worker, b0, b1);
  }
  for (auto& th : ths) th.join();
}

}  // namespace search
}  // namespace

int bs_search(const int32_t* src, const int32_t* above_ext,
              const int32_t* left_ext, const int32_t* al,
              const uint8_t* have_a, const uint8_t* have_l, int B, int bw,
              int bh, int dc_q, int ac_q, int bit_depth, double lam,
              double gain, int K, int refine, int force_skip, int n_threads,
              int32_t* out_mode, int32_t* out_delta, double* out_cost) {
  using namespace search;
  Params P{bw, bh, dc_q, ac_q, bit_depth, K, refine, force_skip, lam, gain};
  int ext = bw + bh;
  int n = bw * bh;
  auto worker = [&](int b0, int b1) {
    Scratch sc;
    sc.pred.resize((size_t)13 * n);
    for (int b = b0; b < b1; b++)
      search_one(src + (size_t)b * n, above_ext + (size_t)b * ext,
                 left_ext + (size_t)b * ext, al[b], have_a[b], have_l[b], P,
                 sc, out_mode + b, out_delta + b, out_cost + b);
  };
  run_threaded(B, n_threads, worker);
  return 0;
}

// Gathering variant: blocks are (plane, py, px) coordinates into a padded
// (P, Hp, Wp) int32 plane stack; neighbors (with the spec's tile-top/left
// availability and the search's source-synthesis rules for missing sides)
// are gathered per worker thread. py0/px0 are the tile origin in pixels.
int bs_search2(const int32_t* planes, int nP, int Hp, int Wp,
               const int32_t* items, int B, int bw, int bh, int py0, int px0,
               int dc_q, int ac_q, int bit_depth, double lam, double gain,
               int K, int refine, int force_skip, int joint_uv,
               int n_threads, int32_t* out_mode, int32_t* out_delta,
               double* out_cost) {
  using namespace search;
  Params P{bw, bh, dc_q, ac_q, bit_depth, K, refine, force_skip, lam, gain};
  int ext = bw + bh;
  int n = bw * bh;
  auto worker = [&](int b0, int b1) {
    Scratch sc;
    std::vector<int32_t> src(2 * (size_t)n), ae(2 * (size_t)ext),
        le(2 * (size_t)ext);
    for (int b = b0; b < b1; b++) {
      int pl = items[3 * b], py = items[3 * b + 1], px = items[3 * b + 2];
      // joint U+V: a plane-1 item co-decides the same block of plane 2
      // (one coded uv mode; per-plane neighbors; summed costs)
      search_item(planes, nP, Hp, Wp, pl, py, px, py0, px0, joint_uv, P, sc,
                  src.data(), ae.data(), le.data(), out_mode + b,
                  out_delta + b, out_cost + b);
    }
  };
  run_threaded(B, n_threads, worker);
  return 0;
}

// ---- whole-tile pass-1: tier cascade + partition DP --------------------
// Native twin of FrameEncoder._rdo_partition + _batch_search_native (the
// python cascade stays as the differential reference and the device-search
// path). One call per tile replaces ~12 marshaled bs_search2 calls plus
// the python grid/dict bookkeeping. Decision-identical to the python
// orchestration: same candidate sets, same double-precision cost algebra,
// same first-wins argmin tie-breaks.
//
// outputs: blocks rows (r, c, w4, h4, ym_idx, yd, uvm_idx, uvd) +
// per-row (cost, lcost) doubles; parts rows (r, c, s4, code) with code
// 0=NONE 1=SPLIT 2=HORZ 3=VERT (the python caller maps to spec codes).
int bs_partition_tile(
    const int32_t* planes, int nP, int Hp, int Wp, int mi_rows, int mi_cols,
    int mi_r0, int mi_r1, int mi_c0, int mi_c1, int min_leaf_mi,
    int max_leaf_mi, const int32_t* partials, int n_partials, int dc_q,
    int ac_q, int bit_depth, double lam, const double* gain_tab, int K_luma,
    int K_chroma, int fine_dir, int chroma_refine, int num_planes,
    int joint_uv, int exhaustive, double ovh_block, double ovh_split,
    double kappa, double rect_ovh_blocks, const int32_t* qmap,
    const double* lammap, int sb_cols,
    int n_threads, int32_t* out_blocks,
    double* out_costs, int blocks_cap, int32_t* n_blocks_out,
    int32_t* out_parts, int parts_cap, int32_t* n_parts_out) {
  using namespace search;
  const double INF = std::numeric_limits<double>::infinity();
  int sizes[8];
  int nsz = 0;
  for (int s4 = min_leaf_mi; s4 <= max_leaf_mi; s4 *= 2) sizes[nsz++] = s4;
  if (nsz == 0) return 1;
  const int py0 = mi_r0 * 4, px0 = mi_c0 * 4;
  // adaptive quantization (psychovisual tune): quantizers and lambda vary
  // per superblock (qmap rows = (dc_q, ac_q); lammap = python _lambda of
  // the SB's ac_q). Every cell of the partition tree sits inside one SB
  // (tiers <= 8 mi), so each comparison sees one consistent lambda.
  auto lam_at = [&](int r, int c) -> double {
    return lammap ? lammap[(size_t)(r / 16) * sb_cols + (c / 16)] : lam;
  };
  auto q_at = [&](int r, int c, int* dq_, int* aq_) {
    if (qmap) {
      const int32_t* qr = qmap + 2 * ((size_t)(r / 16) * sb_cols + (c / 16));
      *dq_ = qr[0];
      *aq_ = qr[1];
    } else {
      *dq_ = dc_q;
      *aq_ = ac_q;
    }
  };
  const double floor_c = kappa * lam * (ovh_split + 3.0 * ovh_block);
  const double rect_ovh = lam * (ovh_split + rect_ovh_blocks * ovh_block);
  const int kdesc = kdesc_policy();  // descent-tier luma RD width

  struct Item { int32_t r, c, w4, h4; };
  int n_rows = 0;  // rows appended to out_blocks/out_costs so far

  // one threaded batch: search items (luma + optional chroma), append rows
  auto search_batch = [&](const std::vector<Item>& its, bool luma_only,
                          int row_base, int k_luma_b) {
    int B = (int)its.size();
    auto worker = [&](int b0, int b1) {
      Scratch sc;
      std::vector<int32_t> src, ae, le;
      for (int b = b0; b < b1; b++) {
        const Item& it = its[b];
        int bw = it.w4 * 4, bh = it.h4 * 4;
        int n = bw * bh, ext = bw + bh;
        if ((int)src.size() < 2 * n) src.resize(2 * (size_t)n);
        if ((int)ae.size() < 2 * ext) ae.resize(2 * (size_t)ext);
        if ((int)le.size() < 2 * ext) le.resize(2 * (size_t)ext);
        int lgw = 0, lgh = 0;
        while ((4 << lgw) < bw) lgw++;
        while ((4 << lgh) < bh) lgh++;
        // all TX_64-family gains equal the 32 entry (1/8 for every size)
        if (lgw > 3) lgw = 3;
        if (lgh > 3) lgh = 3;
        double gain = gain_tab[lgw * 4 + lgh];
        // 64px squares search TX_64X64 residuals (coded-area + tail rd);
        // angle-delta refinement stays off at 64 like the numpy search
        int big = (bw > bh ? bw : bh) >= 64;
        int force_skip = 0;
        int small = (bw < bh ? bw : bh) < 8;
        int py = it.r * 4, px = it.c * 4;
        double lam_b = lam_at(it.r, it.c);
        int dq_b, aq_b;
        q_at(it.r, it.c, &dq_b, &aq_b);
        int32_t* row = out_blocks + (size_t)8 * (row_base + b);
        double* cst = out_costs + (size_t)2 * (row_base + b);
        row[0] = it.r; row[1] = it.c; row[2] = it.w4; row[3] = it.h4;
        int32_t ym, yd, uvm = 0, uvd = 0;
        double lcost;
        {
          Params P{bw, bh, dq_b, aq_b, bit_depth, k_luma_b,
                   fine_dir && !force_skip && !small && !big, force_skip,
                   lam_b, gain};
          search_item(planes, nP, Hp, Wp, 0, py, px, py0, px0, 0, P, sc,
                      src.data(), ae.data(), le.data(), &ym, &yd, &lcost);
        }
        double cost = lcost;
        if (!luma_only && num_planes > 1) {
          Params P{bw, bh, dq_b, aq_b, bit_depth, K_chroma,
                   fine_dir && !force_skip && !small && !big
                       && chroma_refine,
                   force_skip, lam_b, gain};
          int joint = joint_uv && num_planes > 2;
          double ccost;
          search_item(planes, nP, Hp, Wp, 1, py, px, py0, px0, joint, P, sc,
                      src.data(), ae.data(), le.data(), &uvm, &uvd, &ccost);
          cost += joint ? ccost : 2.0 * ccost;
        }
        row[4] = ym; row[5] = yd; row[6] = uvm; row[7] = uvd;
        cst[0] = cost; cst[1] = lcost;
      }
    };
    run_threaded(B, n_threads, worker);
  };

  // tier grids: row id per full-square cell (-1 absent)
  auto nr_of = [&](int s4) { return (mi_r1 - mi_r0 + s4 - 1) / s4; };
  auto nc_of = [&](int s4) { return (mi_c1 - mi_c0 + s4 - 1) / s4; };
  std::vector<std::vector<int>> grid(nsz);
  for (int t = 0; t < nsz; t++)
    grid[t].assign((size_t)nr_of(sizes[t]) * nc_of(sizes[t]), -1);
  auto tier_of = [&](int s4) {
    for (int t = 0; t < nsz; t++)
      if (sizes[t] == s4) return t;
    return -1;
  };
  auto cost_at = [&](int t, int i, int j) -> double {
    // out-of-grid reads are "absent" (python quad_sum pads with inf)
    if (i >= nr_of(sizes[t]) || j >= nc_of(sizes[t])) return INF;
    int id = grid[t][(size_t)i * nc_of(sizes[t]) + j];
    return id < 0 ? INF : out_costs[2 * (size_t)id];
  };
  // register a batch's square rows into their tier grids (later writes
  // overwrite, matching dict.update)
  auto register_rows = [&](int row_base, int count) {
    for (int b = 0; b < count; b++) {
      const int32_t* row = out_blocks + (size_t)8 * (row_base + b);
      if (row[2] != row[3]) continue;
      int t = tier_of(row[2]);
      if (t < 0) continue;
      int i = (row[0] - mi_r0) / row[2], j = (row[1] - mi_c0) / row[2];
      grid[t][(size_t)i * nc_of(sizes[t]) + j] = row_base + b;
    }
  };

  // -- always-searched tiers + edge partials --------------------------
  std::vector<Item> cands;
  for (int p = 0; p < n_partials; p++)
    cands.push_back({partials[4 * p], partials[4 * p + 1],
                     partials[4 * p + 2], partials[4 * p + 3]});
  int n_always = nsz > 1 ? 2 : 1;
  for (int a = nsz - n_always; a < nsz; a++) {
    int s4 = sizes[a];
    for (int r = mi_r0; r < mi_r1; r += s4) {
      if (r + s4 > mi_rows) continue;
      for (int c = mi_c0; c < mi_c1; c += s4) {
        if (c + s4 > mi_cols) continue;
        cands.push_back({r, c, s4, s4});
      }
    }
  }
  if (n_rows + (int)cands.size() > blocks_cap) return 2;
  search_batch(cands, false, n_rows, K_luma);
  register_rows(n_rows, (int)cands.size());
  n_rows += (int)cands.size();

  // -- descent cascade -------------------------------------------------
  for (int ti = nsz - 3; ti >= 0; ti--) {
    int s4 = sizes[ti], ps4 = 2 * s4;
    bool luma_only = s4 <= 2;
    bool deep = ps4 < sizes[nsz - 2] && !exhaustive;
    int pt = ti + 1;
    // gate: grandparent must already prefer SPLIT given sibling costs
    std::vector<uint8_t> gate;
    int gnr = 0, gnc = 0;
    if (deep) {
      int gs4 = ps4 * 2, gt = ti + 2;
      gnr = nr_of(gs4); gnc = nc_of(gs4);
      gate.assign((size_t)gnr * gnc, 0);
      int gi = 0;
      for (int r = mi_r0; r < mi_r1; r += gs4, gi++) {
        if (r + gs4 > mi_rows) continue;
        int gj = 0;
        for (int c = mi_c0; c < mi_c1; c += gs4, gj++) {
          if (c + gs4 > mi_cols) continue;
          double g = cost_at(gt, gi, gj);
          if (g == INF) continue;
          double lam_g = lam_at(r, c);
          double ob = lam_g * ovh_block;
          double split_c = lam_g * ovh_split;
          bool all = true;
          for (int dr = 0; dr < 2 && all; dr++)
            for (int dc_ = 0; dc_ < 2; dc_++) {
              double k = cost_at(pt, 2 * gi + dr, 2 * gj + dc_);
              if (k == INF) { all = false; break; }
              split_c += k + ob;
            }
          if (all && split_c < g + ob) gate[(size_t)gi * gnc + gj] = 1;
        }
      }
    }
    std::vector<Item> small;
    std::vector<int> parents;  // row ids
    int pi = 0;
    for (int r = mi_r0; r < mi_r1; r += ps4, pi++) {
      if (r + ps4 > mi_rows) continue;
      int pj = 0;
      for (int c = mi_c0; c < mi_c1; c += ps4, pj++) {
        if (c + ps4 > mi_cols) continue;
        int pid = grid[pt][(size_t)pi * nc_of(ps4) + pj];
        if (pid < 0) continue;
        double pc = out_costs[2 * (size_t)pid];
        double fl = lammap ? kappa * lam_at(r, c)
                                 * (ovh_split + 3.0 * ovh_block)
                           : floor_c;
        if (!exhaustive && pc <= fl) continue;
        if (deep) {
          int gi = (r - (r % (ps4 * 2)) - mi_r0) / (ps4 * 2);
          int gj = (c - (c % (ps4 * 2)) - mi_c0) / (ps4 * 2);
          if (!gate[(size_t)gi * gnc + gj]) continue;
        }
        parents.push_back(pid);
        for (int dr = 0; dr < 2; dr++)
          for (int dc_ = 0; dc_ < 2; dc_++)
            small.push_back({r + dr * s4, c + dc_ * s4, s4, s4});
      }
    }
    if (small.empty()) break;
    if (n_rows + (int)small.size() > blocks_cap) return 2;
    int base = n_rows;
    // exhaustive (encode_bottomup) keeps full-width searches; the
    // narrowed-K descent is the fast-preset trade only (mirrors python)
    search_batch(small, luma_only, base,
                 luma_only && !exhaustive && kdesc > 0 && kdesc < K_luma
                     ? kdesc
                     : K_luma);
    register_rows(base, (int)small.size());
    n_rows += (int)small.size();
    if (luma_only) {
      // spread the parent's chroma cost over the children; children
      // inherit the parent's uv choice (angle delta dropped <8x8 later)
      for (size_t p = 0; p < parents.size(); p++) {
        const int32_t* prow = out_blocks + (size_t)8 * parents[p];
        const double* pcst = out_costs + (size_t)2 * parents[p];
        double uv_share = (pcst[0] - pcst[1]) / 4.0;
        for (int k = 0; k < 4; k++) {
          int id = base + 4 * (int)p + k;
          out_blocks[8 * (size_t)id + 6] = prow[6];
          out_blocks[8 * (size_t)id + 7] = prow[7];
          out_costs[2 * (size_t)id] += uv_share;
        }
      }
    }
  }

  // -- HORZ/VERT halves where SPLIT already beats NONE ------------------
  // per tier, 4 rect grids (horz-top, horz-bottom, vert-left, vert-right)
  std::vector<std::array<std::vector<int>, 4>> rgrid(nsz);
  {
    std::vector<Item> rects;
    std::vector<int> rparent;  // row id of the square parent per quad
    for (int t = 0; t < nsz; t++) {
      int s4 = sizes[t], half = s4 / 2;
      // half must be a searched tier; no 64px rect halves (the 64 tier is
      // square NONE leaves only, matching the numpy cascade)
      if (s4 < 2 || s4 > 8 || t == 0) continue;
      int nr = nr_of(s4), nc = nc_of(s4);
      for (int i = 0; i < nr; i++)
        for (int j = 0; j < nc; j++) {
          int pid = grid[t][(size_t)i * nc + j];
          if (pid < 0) continue;
          double pa = out_costs[2 * (size_t)pid];
          double q = 0.0;
          bool fin = true;
          for (int dr = 0; dr < 2 && fin; dr++)
            for (int dc_ = 0; dc_ < 2; dc_++) {
              double k = cost_at(t - 1, 2 * i + dr, 2 * j + dc_);
              if (k == INF) { fin = false; break; }
              q += k;
            }
          int r = mi_r0 + i * s4, c = mi_c0 + j * s4;
          double lam_p = lam_at(r, c);
          double ob = lam_p * ovh_block, os = lam_p * ovh_split;
          if (!fin || !(os + 4.0 * ob + q < pa + ob)) continue;
          rects.push_back({r, c, s4, half});
          rects.push_back({r + half, c, s4, half});
          rects.push_back({r, c, half, s4});
          rects.push_back({r, c + half, half, s4});
          rparent.push_back(pid);
        }
    }
    if (!rects.empty()) {
      if (n_rows + (int)rects.size() > blocks_cap) return 2;
      int base = n_rows;
      search_batch(rects, true, base, K_luma);
      n_rows += (int)rects.size();
      for (size_t p = 0; p < rparent.size(); p++) {
        const int32_t* prow = out_blocks + (size_t)8 * rparent[p];
        const double* pcst = out_costs + (size_t)2 * rparent[p];
        double uv_share = (pcst[0] - pcst[1]) / 2.0;
        int t = tier_of(prow[2]);
        int i = (prow[0] - mi_r0) / prow[2], j = (prow[1] - mi_c0) / prow[2];
        int nc = nc_of(sizes[t]);
        if (rgrid[t][0].empty())
          for (int k = 0; k < 4; k++)
            rgrid[t][k].assign((size_t)nr_of(sizes[t]) * nc, -1);
        for (int k = 0; k < 4; k++) {
          int id = base + 4 * (int)p + k;
          out_blocks[8 * (size_t)id + 6] = prow[6];
          out_blocks[8 * (size_t)id + 7] = prow[7];
          out_costs[2 * (size_t)id] += uv_share;
          rgrid[t][k][(size_t)i * nc + j] = id;
        }
      }
    }
  }

  // -- bottom-up NONE/SPLIT/HORZ/VERT argmin (first-wins ties) ----------
  int n_parts = 0;
  // per-tier decision grids kept for the narrowed-K refine walk below
  std::vector<std::vector<int8_t>> codes(nsz);
  std::vector<double> bc;  // best-cost grid of the tier below
  for (int t = 0; t < nsz; t++) {
    int s4 = sizes[t];
    int nr = nr_of(s4), nc = nc_of(s4);
    codes[t].assign((size_t)nr * nc, 0);
    std::vector<double> cur((size_t)nr * nc, INF);
    if (t == 0) {
      for (int i = 0; i < nr; i++)
        for (int j = 0; j < nc; j++) {
          double cc = cost_at(t, i, j);
          if (cc != INF)
            cur[(size_t)i * nc + j] =
                cc + lam_at(mi_r0 + i * s4, mi_c0 + j * s4) * ovh_block;
        }
      bc.swap(cur);
      continue;
    }
    int cnr = nr_of(s4 / 2), cnc = nc_of(s4 / 2);
    for (int i = 0; i < nr; i++)
      for (int j = 0; j < nc; j++) {
        double lam_c = lam_at(mi_r0 + i * s4, mi_c0 + j * s4);
        double ob = lam_c * ovh_block;
        double none_c = cost_at(t, i, j);
        bool have_none = none_c != INF;
        if (have_none) none_c += ob;
        else none_c = INF;
        double split_c = lam_c * ovh_split;
        for (int dr = 0; dr < 2; dr++)
          for (int dc_ = 0; dc_ < 2; dc_++) {
            int ci = 2 * i + dr, cj = 2 * j + dc_;
            split_c += (ci < cnr && cj < cnc)
                           ? bc[(size_t)ci * cnc + cj]
                           : INF;
          }
        double horz_c = INF, vert_c = INF;
        if (split_c < INF && !rgrid[t][0].empty()) {
          auto rcost = [&](int k) {
            int id = rgrid[t][k][(size_t)i * nc + j];
            return id < 0 ? INF : out_costs[2 * (size_t)id];
          };
          double ro = lammap ? lam_c * (ovh_split
                                        + rect_ovh_blocks * ovh_block)
                             : rect_ovh;
          horz_c = ro + rcost(0) + rcost(1);
          vert_c = ro + rcost(2) + rcost(3);
        }
        double cand[4] = {none_c, split_c, horz_c, vert_c};
        int code = 0;
        double best = cand[0];
        for (int k = 1; k < 4; k++)
          if (cand[k] < best) { best = cand[k]; code = k; }
        cur[(size_t)i * nc + j] = best;
        codes[t][(size_t)i * nc + j] = (int8_t)code;
        if (have_none) {
          if (n_parts >= parts_cap) return 3;
          int32_t* pr = out_parts + (size_t)4 * n_parts++;
          pr[0] = mi_r0 + i * s4;
          pr[1] = mi_c0 + j * s4;
          pr[2] = s4;
          pr[3] = code;
        }
      }
    bc.swap(cur);
  }
  // -- narrowed-K refine: descent-tier leaves the DP actually chose get a
  // full-K luma re-search (later rows overwrite earlier modes on the
  // python side; DP costs are final so only the coded mode improves) ----
  if (!exhaustive && kdesc > 0 && kdesc < K_luma && nsz >= 3) {
    std::vector<Item> ref;
    std::vector<int> oldid;
    std::function<void(int, int, int)> walk = [&](int t, int i, int j) {
      const int s4 = sizes[t];
      const int nc = nc_of(s4);
      if (i >= nr_of(s4) || j >= nc) return;
      const int code = codes[t][(size_t)i * nc + j];
      if (code == 1 && t > 0) {
        for (int dr = 0; dr < 2; dr++)
          for (int dc_ = 0; dc_ < 2; dc_++)
            walk(t - 1, 2 * i + dr, 2 * j + dc_);
        return;
      }
      if (code == 0 && t <= nsz - 3 && sizes[t] <= 2) {
        const int id = grid[t][(size_t)i * nc + j];
        if (id >= 0) {
          ref.push_back({mi_r0 + i * s4, mi_c0 + j * s4, s4, s4});
          oldid.push_back(id);
        }
      }
      // rect halves (codes 2/3) were searched at full K already
    };
    const int ts4 = sizes[nsz - 1];
    for (int i = 0; i < nr_of(ts4); i++)
      for (int j = 0; j < nc_of(ts4); j++) walk(nsz - 1, i, j);
    if (!ref.empty()) {
      if (n_rows + (int)ref.size() > blocks_cap) return 2;
      const int base = n_rows;
      search_batch(ref, true, base, K_luma);
      for (size_t p = 0; p < ref.size(); p++) {
        int32_t* nrow = out_blocks + (size_t)8 * (base + (int)p);
        double* ncst = out_costs + (size_t)2 * (base + (int)p);
        const int32_t* orow = out_blocks + (size_t)8 * oldid[p];
        const double* ocst = out_costs + (size_t)2 * oldid[p];
        nrow[6] = orow[6];  // inherit the spread uv choice
        nrow[7] = orow[7];
        ncst[0] = ncst[1] + (ocst[0] - ocst[1]);  // re-add the uv share
      }
      n_rows += (int)ref.size();
    }
  }
  *n_blocks_out = n_rows;
  *n_parts_out = n_parts;
  return 0;
}

// ---- loop-restoration Wiener solve (decision-only float model) ----
// Mirror of the python _wiener_unit: per-axis least squares on the three
// free symmetric taps of the 7-tap filter (ntaps=2 zeroes t0 for the
// chroma 5-tap variant), horizontal pass first, then vertical on the
// filtered intermediate. The serialized filter is applied decoder-exact
// elsewhere; this only picks taps, so double-precision dots replacing the
// python f32 BLAS dots shift decisions at most at exact ties.

static const int WIENER_TAP_MIN[3] = {-5, -23, -17};
static const int WIENER_TAP_MAX[3] = {10, 8, 46};

static void wiener_axis_solve(const double* M, const double* srcf, int uh,
                              int uw, int axis, int ntaps, double* gbuf,
                              int* taps3, double* out) {
  int lo = 3 - ntaps, n = uh * uw;
  for (int t = 0; t < 3; t++) taps3[t] = 0;
  for (int ti = 0; ti < ntaps; ti++) {
    int k = 3 - lo - ti;  // offsets (3,2,1)[lo:]
    double* g = gbuf + (size_t)ti * n;
    if (axis == 1) {
      for (int r = 0; r < uh; r++) {
        const double* mr = &M[(size_t)r * uw];
        double* gr = &g[(size_t)r * uw];
        for (int c = 0; c < uw; c++) {
          int cm = c - k < 0 ? 0 : c - k;
          int cp = c + k >= uw ? uw - 1 : c + k;
          gr[c] = mr[cm] + mr[cp] - 2.0 * mr[c];
        }
      }
    } else {
      for (int r = 0; r < uh; r++) {
        int rm = r - k < 0 ? 0 : r - k;
        int rp = r + k >= uh ? uh - 1 : r + k;
        const double* ma = &M[(size_t)rm * uw];
        const double* mb = &M[(size_t)rp * uw];
        const double* mr = &M[(size_t)r * uw];
        double* gr = &g[(size_t)r * uw];
        for (int c = 0; c < uw; c++) gr[c] = ma[c] + mb[c] - 2.0 * mr[c];
      }
    }
  }
  // all 9 normal-equation moments in ONE fused pass (each stream read
  // once; 9 independent accumulation chains keep the FP adders busy) —
  // the 9 separate dot loops this replaces were memory-bound.
  // DOUBLE pipeline throughout (r05): with integer-valued rec/src the
  // gradients, mid-stage image (1/128 granularity) and every moment are
  // exactly representable, so the whole solve is deterministic exact
  // arithmetic — the device Gram-matrix path (ops/device_filters.py)
  // reconstructs identical values from integer moments. float buffers
  // could round the stage-2 apply (tap*g products need up to 26
  // significand bits) on overshooting units.
  double A[3][3], b[3];
  {
    const double* g0 = gbuf;
    const double* g1 = gbuf + (ntaps > 1 ? (size_t)n : 0);
    const double* g2 = gbuf + (ntaps > 2 ? 2 * (size_t)n : 0);
    double A00 = 0, A01 = 0, A02 = 0, A11 = 0, A12 = 0, A22 = 0;
    double b0 = 0, b1 = 0, b2 = 0;
    if (ntaps == 3) {
      for (int x = 0; x < n; x++) {
        const double t = srcf[x] - M[x];
        const double a = g0[x], bb = g1[x], c = g2[x];
        b0 += a * t; b1 += bb * t; b2 += c * t;
        A00 += a * a; A01 += a * bb; A02 += a * c;
        A11 += bb * bb; A12 += bb * c; A22 += c * c;
      }
    } else if (ntaps == 2) {
      for (int x = 0; x < n; x++) {
        const double t = srcf[x] - M[x];
        const double a = g0[x], bb = g1[x];
        b0 += a * t; b1 += bb * t;
        A00 += a * a; A01 += a * bb; A11 += bb * bb;
      }
    } else {
      for (int x = 0; x < n; x++) {
        const double t = srcf[x] - M[x];
        const double a = g0[x];
        b0 += a * t;
        A00 += a * a;
      }
    }
    b[0] = 128.0 * b0; b[1] = 128.0 * b1; b[2] = 128.0 * b2;
    A[0][0] = A00; A[0][1] = A[1][0] = A01; A[0][2] = A[2][0] = A02;
    A[1][1] = A11; A[1][2] = A[2][1] = A12; A[2][2] = A22;
  }
  double reg = 1e-4 * (A[0][0] > 1.0 ? A[0][0] : 1.0);
  for (int i = 0; i < ntaps; i++) A[i][i] += reg;
  // gaussian elimination with partial pivoting
  double t[3] = {0, 0, 0};
  {
    double m[3][4];
    for (int i = 0; i < ntaps; i++) {
      for (int j = 0; j < ntaps; j++) m[i][j] = A[i][j];
      m[i][ntaps] = b[i];
    }
    bool ok = true;
    for (int col = 0; col < ntaps && ok; col++) {
      int piv = col;
      for (int r = col + 1; r < ntaps; r++)
        if (std::fabs(m[r][col]) > std::fabs(m[piv][col])) piv = r;
      if (std::fabs(m[piv][col]) < 1e-30) { ok = false; break; }
      if (piv != col)
        for (int j = 0; j <= ntaps; j++) std::swap(m[piv][j], m[col][j]);
      for (int r = 0; r < ntaps; r++) {
        if (r == col) continue;
        double f = m[r][col] / m[col][col];
        for (int j = col; j <= ntaps; j++) m[r][j] -= f * m[col][j];
      }
    }
    if (ok)
      for (int i = 0; i < ntaps; i++) t[i] = m[i][ntaps] / m[i][i];
  }
  bool any = false;
  for (int i = 0; i < ntaps; i++) {
    int v = (int)std::nearbyint(t[i]);
    if (v < WIENER_TAP_MIN[lo + i]) v = WIENER_TAP_MIN[lo + i];
    if (v > WIENER_TAP_MAX[lo + i]) v = WIENER_TAP_MAX[lo + i];
    taps3[lo + i] = v;
    any |= v != 0;
  }
  if (!any) {
    for (int x = 0; x < n; x++) out[x] = M[x];
    return;
  }
  const double inv128 = 1.0 / 128.0;
  for (int x = 0; x < n; x++) {
    double acc = 0.0;
    for (int i = 0; i < ntaps; i++)
      acc += (double)taps3[lo + i] * gbuf[(size_t)i * n + x];
    out[x] = M[x] + acc * inv128;
  }
}

// Apply-only twin of wiener_axis_solve: filter M with GIVEN taps (the
// psy-scaled integer taps), rebuilding the gradient streams.
static void wiener_axis_apply(const double* M, int uh, int uw, int axis,
                              int ntaps, const int* taps3, double* gbuf,
                              double* out) {
  int lo = 3 - ntaps, n = uh * uw;
  for (int ti = 0; ti < ntaps; ti++) {
    int k = 3 - lo - ti;
    double* g = gbuf + (size_t)ti * n;
    if (axis == 1) {
      for (int r = 0; r < uh; r++) {
        const double* mr = &M[(size_t)r * uw];
        double* gr = &g[(size_t)r * uw];
        for (int c = 0; c < uw; c++) {
          int cm = c - k < 0 ? 0 : c - k;
          int cp = c + k >= uw ? uw - 1 : c + k;
          gr[c] = mr[cm] + mr[cp] - 2.0 * mr[c];
        }
      }
    } else {
      for (int r = 0; r < uh; r++) {
        int rm = r - k < 0 ? 0 : r - k;
        int rp = r + k >= uh ? uh - 1 : r + k;
        const double* ma = &M[(size_t)rm * uw];
        const double* mb = &M[(size_t)rp * uw];
        const double* mr = &M[(size_t)r * uw];
        double* gr = &g[(size_t)r * uw];
        for (int c = 0; c < uw; c++) gr[c] = ma[c] + mb[c] - 2.0 * mr[c];
      }
    }
  }
  const double inv128 = 1.0 / 128.0;
  for (int x = 0; x < n; x++) {
    double acc = 0.0;
    for (int i = 0; i < ntaps; i++)
      acc += (double)taps3[lo + i] * gbuf[(size_t)i * n + x];
    out[x] = M[x] + acc * inv128;
  }
}

// All restoration units of one plane: unit x unit grid, last row/col
// absorbing the remainder. out_taps (rows*cols, 6) = (t0v,t1v,t2v,
// t0h,t1h,t2h); out_use/out_sse/out_base (rows*cols).
int lr_wiener_plane(const int32_t* src, const int32_t* rec, int h, int w,
                    int sstride, int rstride, int unit, int rows, int cols,
                    int ntaps, double margin, int n_threads,
                    int32_t* out_use, int32_t* out_taps, double* out_sse,
                    double* out_base, double* out_var, double mu) {
  using namespace search;
  auto worker = [&](int u0, int u1) {
    std::vector<double> srcf, recf, mid, fin, gbuf;
    for (int ui = u0; ui < u1; ui++) {
      int ur = ui / cols, uc = ui % cols;
      int y0 = ur * unit, y1 = ur == rows - 1 ? h : (ur + 1) * unit;
      int x0 = uc * unit, x1 = uc == cols - 1 ? w : (uc + 1) * unit;
      int uh = y1 - y0, uw = x1 - x0, n = uh * uw;
      srcf.resize(n); recf.resize(n); mid.resize(n); fin.resize(n);
      gbuf.resize((size_t)3 * n);
      int64_t base = 0;
      double ssum = 0, ssq = 0, rsum = 0, rsq = 0;
      for (int r = 0; r < uh; r++) {
        const int32_t* sr = &src[(size_t)(y0 + r) * sstride + x0];
        const int32_t* rr_ = &rec[(size_t)(y0 + r) * rstride + x0];
        double* sf = &srcf[(size_t)r * uw];
        double* rf = &recf[(size_t)r * uw];
        for (int c = 0; c < uw; c++) {
          int64_t d = (int64_t)sr[c] - rr_[c];
          base += d * d;
          sf[c] = (double)sr[c];
          rf[c] = (double)rr_[c];
          ssum += sr[c]; ssq += (double)sr[c] * sr[c];
          rsum += rr_[c]; rsq += (double)rr_[c] * rr_[c];
        }
      }
      int th[3], tv[3];
      wiener_axis_solve(recf.data(), srcf.data(), uh, uw, 1, ntaps,
                        gbuf.data(), th, mid.data());
      wiener_axis_solve(mid.data(), srcf.data(), uh, uw, 0, ntaps,
                        gbuf.data(), tv, fin.data());
      if (mu > 0.0 && (th[0] | th[1] | th[2] | tv[0] | tv[1] | tv[2])) {
        // Variance-penalized partial-strength solve (psy restoration):
        // the SSE-optimal Wiener filter is a denoiser whose variance
        // shrinkage costs SSIM contrast. With d = F(rec) - rec, both
        // SSE(γ) and var(rec + γd) are quadratic in the strength γ, so
        // minimizing J(γ) = SSE - mu * n * var_px gives
        //   γ* = (e·d + mu·cov(rec, d)) / (d·d - mu·var(d)),
        // and the integer taps are scaled by γ and re-evaluated exactly.
        double ed = 0, dd = 0, sd = 0, srd = 0, rsum2 = 0;
        for (int x = 0; x < n; x++) {
          double d = fin[x] - recf[x];
          ed += (srcf[x] - recf[x]) * d;
          dd += d * d;
          sd += d;
          srd += recf[x] * d;
          rsum2 += recf[x];
        }
        double crd = srd - rsum2 * sd / n;
        double vd = dd - sd * sd / n;
        double den = dd - mu * vd;
        double gam = den > 1e-9 ? (ed + mu * crd) / den : 1.0;
        if (gam < 0.0) gam = 0.0;
        if (gam > 1.0) gam = 1.0;
        if (gam < 0.97) {
          int lo = 3 - ntaps;
          for (int i = 0; i < ntaps; i++) {
            int vH = (int)std::nearbyint(gam * th[lo + i]);
            int vV = (int)std::nearbyint(gam * tv[lo + i]);
            if (vH < WIENER_TAP_MIN[lo + i]) vH = WIENER_TAP_MIN[lo + i];
            if (vH > WIENER_TAP_MAX[lo + i]) vH = WIENER_TAP_MAX[lo + i];
            if (vV < WIENER_TAP_MIN[lo + i]) vV = WIENER_TAP_MIN[lo + i];
            if (vV > WIENER_TAP_MAX[lo + i]) vV = WIENER_TAP_MAX[lo + i];
            th[lo + i] = vH;
            tv[lo + i] = vV;
          }
          wiener_axis_apply(recf.data(), uh, uw, 1, ntaps, th,
                            gbuf.data(), mid.data());
          wiener_axis_apply(mid.data(), uh, uw, 0, ntaps, tv,
                            gbuf.data(), fin.data());
        }
      }
      // output moments accumulate over dv = fin - rec (small, exact
      // in double) and compose with the integer rec moments: a direct
      // sum of fin^2 (1/2^28 granularity at ~2^20 magnitude) rounds,
      // which would break device-Gram equality (ops/device_filters.py)
      double sse = 0.0, dsum = 0.0, dsq = 0.0, drd = 0.0;
      for (int x = 0; x < n; x++) {
        double d = srcf[x] - fin[x];
        sse += d * d;
        double dv = fin[x] - recf[x];
        dsum += dv; dsq += dv * dv; drd += recf[x] * dv;
      }
      double fsum = rsum + dsum;
      double fsq = rsq + 2.0 * drd + dsq;
      bool zero = !(th[0] | th[1] | th[2] | tv[0] | tv[1] | tv[2]);
      int use;
      if (mu > 0.0) {
        // accept on the penalized objective: J = SSE - mu * variance
        double var_f = fsq - fsum * fsum / n;
        double var_r = rsq - rsum * rsum / n;
        use = (sse - mu * var_f) < ((double)base - mu * var_r) - margin
              && !zero;
      } else {
        use = sse < (double)base - margin && !zero;
      }
      out_use[ui] = use;
      out_base[ui] = (double)base;
      if (out_var) {
        // unnormalized central second moments (sum of squared deviation
        // from the unit mean): source, pre-filter recon, filtered output
        // — the SSIM-contrast variance-guard inputs (encoder.py _lr_solve)
        double* vp = &out_var[(size_t)ui * 3];
        vp[0] = ssq - ssum * ssum / n;
        vp[1] = rsq - rsum * rsum / n;
        vp[2] = use ? fsq - fsum * fsum / n : vp[1];
      }
      int32_t* tp = &out_taps[(size_t)ui * 6];
      if (use) {
        out_sse[ui] = sse;
        tp[0] = tv[0]; tp[1] = tv[1]; tp[2] = tv[2];
        tp[3] = th[0]; tp[4] = th[1]; tp[5] = th[2];
      } else {
        out_sse[ui] = (double)base;
        for (int i = 0; i < 6; i++) tp[i] = 0;
      }
    }
  };
  // restoration units are few (256x256 px each) but heavy: thread even at
  // small unit counts (run_threaded's B<64 guard targets per-block search
  // batches, not whole-unit solves)
  {
    const int B = rows * cols;
    int nth = n_threads < B ? n_threads : B;
    if (nth <= 1) {
      worker(0, B);
    } else {
      std::vector<std::thread> ths;
      const int per = (B + nth - 1) / nth;
      for (int t = 0; t < nth; t++) {
        const int b0 = t * per, b1 = b0 + per < B ? b0 + per : B;
        if (b0 >= b1) break;
        ths.emplace_back(worker, b0, b1);
      }
      for (auto& th : ths) th.join();
    }
  }
  return 0;
}

// -- self-guided (SGRPROJ) loop-restoration search --------------------------
// C++ mirror of av1/sgr.py: decoder-exact integer filter (spec 7.17.3),
// double-precision least-squares projection solve, exact-integer-SSE best-set
// search per restoration unit. Parameter tables match libaom av1_sgr_params /
// one_by_x / x_by_xplus1 (validated bit-exact vs dav1d by tests/test_sgr.py).
// Reference behavior: rav1e's SGR search under the `lrf`/`sgr_complexity`
// preset toggles (/root/reference/ravif/src/av1encoder.rs:573,589,623).
// `tier`: 1 = full 16-set, 0 = reduced 6-set (the reference's
// sgr_complexity policy), 2 = fast 3-set {6, 9, 14} for speed >= 4 —
// the sets chosen in 95% of units across the BD corpus x Q60/80/92
// (set-usage audit, round 4); halves the guided-filter pass count.
int lr_sgr_plane(const int32_t* src, const int32_t* rec, int h, int w,
                 int sstride, int rstride, int unit, int rows, int cols,
                 int bit_depth, int tier, int n_threads, int32_t* out_set,
                 int32_t* out_xqd, double* out_sse, double* out_var,
                 double mu) {
  struct SgrParams { int r0, r1, s0, s1; };
  static const SgrParams kSets[16] = {
      {2, 1, 140, 3236}, {2, 1, 112, 2158}, {2, 1, 93, 1618},
      {2, 1, 80, 1438},  {2, 1, 70, 1295},  {2, 1, 58, 1177},
      {2, 1, 47, 1079},  {2, 1, 37, 996},   {2, 1, 30, 925},
      {2, 1, 25, 863},   {0, 1, -1, 2589},  {0, 1, -1, 1618},
      {0, 1, -1, 1177},  {0, 1, -1, 925},   {2, 0, 56, -1},
      {2, 0, 22, -1}};
  static const int kReduced[6] = {0, 3, 6, 9, 11, 14};
  static const int kFast[3] = {6, 9, 14};
  // x_by_xplus1[z] = ((z<<8) + z/2) / (z+1), [0] = 1, [255] = 256
  static int32_t xby[256];
  static int32_t oneby[25];
  static std::once_flag once;
  std::call_once(once, [] {
    xby[0] = 1;
    for (int z = 1; z < 255; z++)
      xby[z] = (int32_t)((((int64_t)z << 8) + z / 2) / (z + 1));
    xby[255] = 256;
    for (int n = 1; n <= 25; n++) oneby[n - 1] = (4096 + n / 2) / n;
  });
  const int maxv = (1 << bit_depth) - 1;
  const int d = bit_depth - 8;
  auto rpot = [](int64_t x, int n) {  // x >= 0
    return n == 0 ? x : (x + ((int64_t)1 << (n - 1))) >> n;
  };
  const int nsets = tier == 1 ? 16 : (tier == 2 ? 3 : 6);

  auto worker = [&](int u0, int u1) {
    std::vector<int64_t> ii1, ii2;
    std::vector<int32_t> a2g, b2g, ext;
    std::vector<int32_t> fltbuf;  // cached filter passes, keyed below
    for (int ui = u0; ui < u1; ui++) {
      const int ur = ui / cols, uc = ui % cols;
      const int y0 = ur * unit, y1 = ur == rows - 1 ? h : (ur + 1) * unit;
      const int x0 = uc * unit, x1 = uc == cols - 1 ? w : (uc + 1) * unit;
      const int uh = y1 - y0, uw = x1 - x0;
      const size_t n = (size_t)uh * uw;
      const int eh = uh + 6, ew = uw + 6;
      const int gw = uw + 2;  // A/B grid covers unit rows/cols -1..uh
      ext.resize((size_t)eh * ew);
      for (int er = 0; er < eh; er++) {
        int sr = y0 - 3 + er;
        sr = sr < 0 ? 0 : (sr >= h ? h - 1 : sr);
        const int32_t* rr_ = &rec[(size_t)sr * rstride];
        int32_t* xr = &ext[(size_t)er * ew];
        for (int ec = 0; ec < ew; ec++) {
          int sc = x0 - 3 + ec;
          sc = sc < 0 ? 0 : (sc >= w ? w - 1 : sc);
          xr[ec] = rr_[sc];
        }
      }
      // integral images over ext (shared by every radius/strength pass)
      ii1.assign((size_t)(eh + 1) * (ew + 1), 0);
      ii2.assign((size_t)(eh + 1) * (ew + 1), 0);
      for (int r = 0; r < eh; r++) {
        int64_t run1 = 0, run2 = 0;
        const int32_t* xr = &ext[(size_t)r * ew];
        int64_t* i1 = &ii1[(size_t)(r + 1) * (ew + 1)];
        int64_t* i2 = &ii2[(size_t)(r + 1) * (ew + 1)];
        const int64_t* p1 = &ii1[(size_t)r * (ew + 1)];
        const int64_t* p2 = &ii2[(size_t)r * (ew + 1)];
        for (int c = 0; c < ew; c++) {
          run1 += xr[c];
          run2 += (int64_t)xr[c] * xr[c];
          i1[c + 1] = run1 + p1[c + 1];
          i2[c + 1] = run2 + p2[c + 1];
        }
      }
      // one filter pass (radius r, strength s) -> flt (uh*uw, x16 domain)
      auto pass = [&](int r, int s, int32_t* flt) {
        const int k = 2 * r + 1, nn = k * k, off = 2 - r;
        const int gh = uh + 2;
        a2g.resize((size_t)gh * gw);
        b2g.resize((size_t)gh * gw);
        // r == 2 subsampled fast path: only the odd unit positions
        // (-1, 1, 3, ...) = even grid rows are ever read below
        const int gstep = r == 2 ? 2 : 1;
        for (int gi = 0; gi < gh; gi += gstep) {
          const int64_t* iA = &ii1[(size_t)(gi + off) * (ew + 1)];
          const int64_t* iB = &ii1[(size_t)(gi + off + k) * (ew + 1)];
          const int64_t* jA = &ii2[(size_t)(gi + off) * (ew + 1)];
          const int64_t* jB = &ii2[(size_t)(gi + off + k) * (ew + 1)];
          int32_t* ar = &a2g[(size_t)gi * gw];
          int32_t* br = &b2g[(size_t)gi * gw];
          for (int gj = 0; gj < gw; gj++) {
            const int c0 = gj + off, c1 = gj + off + k;
            const int64_t bsum = iB[c1] - iA[c1] - iB[c0] + iA[c0];
            const int64_t asum = jB[c1] - jA[c1] - jB[c0] + jA[c0];
            const int64_t a = rpot(asum, 2 * d);
            const int64_t bd = rpot(bsum, d);
            int64_t p = a * nn - bd * bd;
            if (p < 0) p = 0;
            int64_t z = rpot(p * s, 20);
            if (z > 255) z = 255;
            const int32_t a2 = xby[z];
            ar[gj] = a2;
            br[gj] = (int32_t)rpot((int64_t)(256 - a2) * bsum * oneby[nn - 1],
                                   12);
          }
        }
        for (int rr_ = 0; rr_ < uh; rr_++) {
          const int32_t* gU = &a2g[(size_t)rr_ * gw];        // row rr_-1
          const int32_t* gC = &a2g[(size_t)(rr_ + 1) * gw];  // row rr_
          const int32_t* gD = &a2g[(size_t)(rr_ + 2) * gw];  // row rr_+1
          const int32_t* bU = &b2g[(size_t)rr_ * gw];
          const int32_t* bC = &b2g[(size_t)(rr_ + 1) * gw];
          const int32_t* bD = &b2g[(size_t)(rr_ + 2) * gw];
          const int32_t* dg = &ext[(size_t)(rr_ + 3) * ew + 3];
          int32_t* fr = &flt[(size_t)rr_ * uw];
          if (r == 2) {
            if ((rr_ & 1) == 0) {  // even rows: U/D rows + corners, nb=5
              for (int cc = 0; cc < uw; cc++) {
                const int64_t a = 6 * ((int64_t)gU[cc + 1] + gD[cc + 1]) +
                                  5 * ((int64_t)gU[cc] + gU[cc + 2] +
                                       gD[cc] + gD[cc + 2]);
                const int64_t b = 6 * ((int64_t)bU[cc + 1] + bD[cc + 1]) +
                                  5 * ((int64_t)bU[cc] + bU[cc + 2] +
                                       bD[cc] + bD[cc + 2]);
                fr[cc] = (int32_t)rpot(a * dg[cc] + b, 9);
              }
            } else {  // odd rows: own row, nb=4
              for (int cc = 0; cc < uw; cc++) {
                const int64_t a =
                    6 * (int64_t)gC[cc + 1] + 5 * ((int64_t)gC[cc] + gC[cc + 2]);
                const int64_t b =
                    6 * (int64_t)bC[cc + 1] + 5 * ((int64_t)bC[cc] + bC[cc + 2]);
                fr[cc] = (int32_t)rpot(a * dg[cc] + b, 8);
              }
            }
          } else {
            for (int cc = 0; cc < uw; cc++) {
              const int64_t a =
                  4 * ((int64_t)gC[cc + 1] + gC[cc] + gC[cc + 2] +
                       gU[cc + 1] + gD[cc + 1]) +
                  3 * ((int64_t)gU[cc] + gU[cc + 2] + gD[cc] + gD[cc + 2]);
              const int64_t b =
                  4 * ((int64_t)bC[cc + 1] + bC[cc] + bC[cc + 2] +
                       bU[cc + 1] + bD[cc + 1]) +
                  3 * ((int64_t)bU[cc] + bU[cc + 2] + bD[cc] + bD[cc + 2]);
              fr[cc] = (int32_t)rpot(a * dg[cc] + b, 9);
            }
          }
        }
      };
      // lazily-computed pass cache: (r, s) -> slot in fltbuf. Slots are
      // INDICES, not pointers: fltbuf.resize below relocates the buffer,
      // so pointers must be re-derived at each use
      int cache_r[24], cache_s[24], ncache = 0;
      auto get_pass = [&](int r, int s) -> int {
        for (int i = 0; i < ncache; i++)
          if (cache_r[i] == r && cache_s[i] == s) return i;
        if ((size_t)(ncache + 1) * n > fltbuf.size())
          fltbuf.resize((size_t)(ncache + 1) * n);
        pass(r, s, fltbuf.data() + (size_t)ncache * n);
        cache_r[ncache] = r;
        cache_s[ncache] = s;
        return ncache++;
      };
      auto slot_ptr = [&](int i) -> const int32_t* {
        return i < 0 ? nullptr : fltbuf.data() + (size_t)i * n;
      };
      int best_set = -1, best_x0 = 0, best_x1 = 0;
      double best_sse = 0.0;
      // predicted-SSE search: the LS moments already determine the float
      // residual of each candidate set at its quantized weights, so the
      // exact integer SSE pass (the priciest per-set loop) runs only for
      // the two best-predicted sets below
      struct Cand {
        int set, x0, x1, dq0, dq1, i0, i1;
        double pred;
      };
      Cand cl[16];
      double tt = -1.0;  // sum t^2 (set-independent), computed once
      for (int si = 0; si < nsets; si++) {
        const int set = tier == 1 ? si
                        : (tier == 2 ? kFast[si] : kReduced[si]);
        const SgrParams& P = kSets[set];
        const int i0 = P.r0 > 0 ? get_pass(2, P.s0) : -1;
        const int i1 = P.r1 > 0 ? get_pass(1, P.s1) : -1;
        const int32_t* flt0 = slot_ptr(i0);
        const int32_t* flt1 = slot_ptr(i1);
        // least squares on (flt - u) vs (src<<4 - u), double accumulation.
        // With mu > 0 the solve is variance-penalized (psy restoration):
        // minimize J(w) = SSE(w) - mu * var(u + w·g), both quadratic in
        // the projection weights, giving the modified normal equations
        //   (H - mu*C) w = c + mu*cov(u, g)
        // with C the CENTERED covariance of the guided corrections g and
        // H/c the raw SSE moments (u = rec<<4, g_i = flt_i - u).
        double h00 = 0, h11 = 0, h01 = 0, c0_ = 0, c1_ = 0, tt_ = 0;
        double sg0 = 0, sg1 = 0, su_ = 0, ug0 = 0, ug1 = 0;
        const bool need_tt = tt < 0.0;
        for (int rr_ = 0; rr_ < uh; rr_++) {
          const int32_t* sr = &src[(size_t)(y0 + rr_) * sstride + x0];
          const int32_t* dr_ = &rec[(size_t)(y0 + rr_) * rstride + x0];
          const size_t o = (size_t)rr_ * uw;
          for (int cc = 0; cc < uw; cc++) {
            const int32_t u = dr_[cc] << 4;
            const double t = (double)((sr[cc] << 4) - u);
            if (need_tt) tt_ += t * t;
            if (mu > 0.0) su_ += (double)u;
            if (flt0) {
              const double f0 = (double)(flt0[o + cc] - u);
              h00 += f0 * f0;
              c0_ += f0 * t;
              if (mu > 0.0) { sg0 += f0; ug0 += (double)u * f0; }
              if (flt1) {
                const double f1 = (double)(flt1[o + cc] - u);
                h01 += f0 * f1;
              }
            }
            if (flt1) {
              const double f1 = (double)(flt1[o + cc] - u);
              h11 += f1 * f1;
              c1_ += f1 * t;
              if (mu > 0.0) { sg1 += f1; ug1 += (double)u * f1; }
            }
          }
        }
        if (need_tt) tt = tt_;
        const double scale = 128.0;  // 1 << SGRPROJ_PRJ_BITS
        double b0 = 0.0, b1 = 0.0;
        double e00 = h00, e11 = h11, e01 = h01, d0 = c0_, d1 = c1_;
        if (mu > 0.0) {
          const double nn_ = (double)n;
          e00 = h00 - mu * (h00 - sg0 * sg0 / nn_);
          e11 = h11 - mu * (h11 - sg1 * sg1 / nn_);
          e01 = h01 - mu * (h01 - sg0 * sg1 / nn_);
          d0 = c0_ + mu * (ug0 - su_ * sg0 / nn_);
          d1 = c1_ + mu * (ug1 - su_ * sg1 / nn_);
        }
        if (flt0 && flt1) {
          const double det = e00 * e11 - e01 * e01;
          if (det > 0) {
            b0 = scale * (e11 * d0 - e01 * d1) / det;
            b1 = scale * (e00 * d1 - e01 * d0) / det;
          }
        } else if (flt0) {
          b0 = e00 > 0 ? scale * d0 / e00 : 0.0;
        } else {
          b1 = e11 > 0 ? scale * d1 / e11 : 0.0;
        }
        auto clipi = [](double v, int lo, int hi) {
          const double r_ = std::nearbyint(v);
          return (int)(r_ < lo ? lo : (r_ > hi ? hi : r_));
        };
        const int xq0 = P.r0 ? clipi(b0, -96, 31) : 0;
        const int xqd1 =
            P.r1 ? clipi(128.0 - xq0 - std::nearbyint(b1), -32, 95)
                 : clipi(128.0 - xq0, -32, 95);
        // decode_xq (libaom av1_decode_xq)
        int dq0, dq1;
        if (P.r0 == 0) {
          dq0 = 0;
          dq1 = 128 - dq0 - xqd1;
        } else if (P.r1 == 0) {
          dq0 = xq0;
          dq1 = 0;
        } else {
          dq0 = xq0;
          dq1 = 128 - dq0 - xqd1;
        }
        // predicted residual (x16 domain) at the quantized weights:
        // sum (t - (dq0 f0 + dq1 f1)/128)^2, ignoring the final integer
        // rounding/clipping (bounded by +-0.5px per sample)
        const double w0 = dq0 / 128.0, w1 = dq1 / 128.0;
        double pred = tt;
        if (flt0) pred += w0 * w0 * h00 - 2.0 * w0 * c0_;
        if (flt1) pred += w1 * w1 * h11 - 2.0 * w1 * c1_;
        if (flt0 && flt1) pred += 2.0 * w0 * w1 * h01;
        if (mu > 0.0) {
          // rank by the penalized objective: subtract mu x the output-
          // variance DELTA (the set-independent var(u) term cancels)
          const double nn_ = (double)n;
          double dvar = 0.0;
          if (flt0)
            dvar += 2.0 * w0 * (ug0 - su_ * sg0 / nn_)
                    + w0 * w0 * (h00 - sg0 * sg0 / nn_);
          if (flt1)
            dvar += 2.0 * w1 * (ug1 - su_ * sg1 / nn_)
                    + w1 * w1 * (h11 - sg1 * sg1 / nn_);
          if (flt0 && flt1)
            dvar += 2.0 * w0 * w1 * (h01 - sg0 * sg1 / nn_);
          pred -= mu * dvar;
        }
        cl[si] = {set, xq0, xqd1, dq0, dq1, i0, i1, pred};
      }
      // exact integer SSE for the two best-predicted sets only
      int o1 = 0, o2 = -1;
      for (int si = 1; si < nsets; si++) {
        if (cl[si].pred < cl[o1].pred) { o2 = o1; o1 = si; }
        else if (o2 < 0 || cl[si].pred < cl[o2].pred) o2 = si;
      }
      double best_fsum = 0.0, best_fsq = 0.0;
      double ssum = 0.0, ssq = 0.0, rsum = 0.0, rsq = 0.0;
      for (int pass_i = 0; pass_i < 2; pass_i++) {
        const int si = pass_i == 0 ? o1 : o2;
        if (si < 0) continue;
        const Cand& C = cl[si];
        const int32_t* cf0 = slot_ptr(C.i0);
        const int32_t* cf1 = slot_ptr(C.i1);
        int64_t sse = 0;
        double fsum = 0.0, fsq = 0.0;
        for (int rr_ = 0; rr_ < uh; rr_++) {
          const int32_t* sr = &src[(size_t)(y0 + rr_) * sstride + x0];
          const int32_t* dr_ = &rec[(size_t)(y0 + rr_) * rstride + x0];
          const size_t o = (size_t)rr_ * uw;
          for (int cc = 0; cc < uw; cc++) {
            const int64_t u = (int64_t)(dr_[cc] << 4);
            int64_t v = u << 7;
            if (cf0) v += (int64_t)C.dq0 * (cf0[o + cc] - u);
            if (cf1) v += (int64_t)C.dq1 * (cf1[o + cc] - u);
            int64_t wv = (v + (1 << 10)) >> 11;  // PRJ+RST rounding shift
            if (wv < 0) wv = 0;
            if (wv > maxv) wv = maxv;
            const int64_t dd = wv - sr[cc];
            sse += dd * dd;
            fsum += (double)wv; fsq += (double)wv * wv;
            if (pass_i == 0 && out_var) {
              ssum += sr[cc]; ssq += (double)sr[cc] * sr[cc];
              rsum += dr_[cc]; rsq += (double)dr_[cc] * dr_[cc];
            }
          }
        }
        // selection metric: raw SSE, or the variance-penalized J when
        // mu > 0 (out_sse always reports the winner's RAW SSE)
        double met = (double)sse;
        if (mu > 0.0) met -= mu * (fsq - fsum * fsum / (double)n);
        double best_met = best_sse;
        if (mu > 0.0 && best_set >= 0)
          best_met = best_sse
                     - mu * (best_fsq - best_fsum * best_fsum / (double)n);
        if (best_set < 0 || met < best_met) {
          best_set = C.set;
          best_x0 = C.x0;
          best_x1 = C.x1;
          best_sse = (double)sse;
          best_fsum = fsum; best_fsq = fsq;
        }
      }
      out_set[ui] = best_set;
      out_xqd[(size_t)ui * 2] = best_x0;
      out_xqd[(size_t)ui * 2 + 1] = best_x1;
      out_sse[ui] = best_sse;
      if (out_var) {
        // central second moments: source, pre-filter recon, best-set
        // filtered output (decoded-pixel domain) — variance-guard inputs
        double* vp = &out_var[(size_t)ui * 3];
        vp[0] = ssq - ssum * ssum / (double)n;
        vp[1] = rsq - rsum * rsum / (double)n;
        vp[2] = best_fsq - best_fsum * best_fsum / (double)n;
      }
    }
  };
  const int B = rows * cols;
  int nth = n_threads < B ? n_threads : B;
  if (nth <= 1) {
    worker(0, B);
  } else {
    std::vector<std::thread> ths;
    const int per = (B + nth - 1) / nth;
    for (int t = 0; t < nth; t++) {
      const int b0 = t * per, b1 = b0 + per < B ? b0 + per : B;
      if (b0 >= b1) break;
      ths.emplace_back(worker, b0, b1);
    }
    for (auto& th : ths) th.join();
  }
  return 0;
}

// Build per-mi filter maps from a tile's concrete replay op stream:
// skip flag, tx dims log2(px) and txb start-edge flags per {luma, chroma}
// grid. Arrays are full-frame (mi_rows x mi_cols); (r0, c0) is the tile
// origin (OP_BLOCK rows are tile-relative).
int of_build_maps(const int32_t* ops, int n_ops, int r0, int c0, int mi_rows,
                  int mi_cols, int nt, uint8_t* skip, uint8_t* txw_l2,
                  uint8_t* txh_l2, uint8_t* edge_v, uint8_t* edge_h) {
  const size_t grid = (size_t)mi_rows * mi_cols;
  int i = 0;
  while (i < n_ops) {
    switch (ops[i]) {
      case OP_CLEAR_LEFT: i += OP_CLEAR_LEFT_N; break;
      case OP_PARTITION: i += OP_PARTITION_N; break;
      case OP_SPLIT_BIN: i += OP_SPLIT_BIN_N; break;
      case OP_SB_START: i += OP_SB_START_N; break;
      case OP_DELTA_Q: i += OP_DELTA_Q_N; break;
      case OP_LR: i += OP_LR_N; break;
      case OP_LR_UNIT: i += OP_LR_UNIT_N; break;
      case OP_COEFFS: i += OP_COEFFS_N; break;
      case OP_BLOCK: {
        const int r = ops[i + 1] + r0, c = ops[i + 2] + c0;
        const int w4 = ops[i + 3], h4 = ops[i + 4];
        const int sk = ops[i + 7];
        const int r1 = r + h4 < mi_rows ? r + h4 : mi_rows;
        const int c1 = c + w4 < mi_cols ? c + w4 : mi_cols;
        for (int t = 0; t < nt; t++) {
          const int cap = t == 0 ? 16 : 8;  // 64px / 32px in mi units
          const int tw4 = w4 < cap ? w4 : cap;
          const int th4 = h4 < cap ? h4 : cap;
          int wl2 = 0, hl2 = 0;
          while ((1 << wl2) < tw4 * 4) wl2++;
          while ((1 << hl2) < th4 * 4) hl2++;
          uint8_t* tw = txw_l2 + t * grid;
          uint8_t* th = txh_l2 + t * grid;
          uint8_t* ev = edge_v + t * grid;
          uint8_t* eh = edge_h + t * grid;
          for (int rr = r; rr < r1; rr++)
            for (int cc = c; cc < c1; cc++) {
              const size_t mi = (size_t)rr * mi_cols + cc;
              tw[mi] = (uint8_t)wl2;
              th[mi] = (uint8_t)hl2;
              if ((cc - c) % tw4 == 0) ev[mi] = 1;
              if ((rr - r) % th4 == 0) eh[mi] = 1;
              if (t == 0) skip[mi] = (uint8_t)sk;
            }
        }
        i += OP_BLOCK_N;
        break;
      }
      default:
        return -1;
    }
  }
  return 0;
}

// Deblock the (padded) reconstruction in place over the full coded area
// (4*mi_cols x 4*mi_rows; the decoder filters before cropping). Per plane:
// all vertical edges, then all horizontal (spec pass order). levels:
// [y_vert, y_horz, u, v]. Maps are (2, mi_rows, mi_cols) uint8 over
// {luma, chroma} grids: tx dims log2(px) and txb start-edge flags
// (block edges are txb edges by construction). 4:4:4 / monochrome only.
// With src != null, accumulates the per-plane SSE *delta* (filtered vs
// unfiltered, against src, over the visible vis_w x vis_h crop) into
// sse_out[P] — the filter-level search metric, computed for free here.
// Threading: the vertical-edge pass only reads/writes within each pixel
// row (edges are filtered left-to-right per row), the horizontal pass
// only within each pixel column (top-to-bottom) — so row bands / column
// bands run concurrently with the per-row/column edge order preserved
// exactly; a join between the passes keeps the spec's v-then-h order.
int of_deblock(int32_t* planes, int P, int Hp, int Wp, int mi_rows,
               int mi_cols, int bit_depth, const int32_t* levels,
               const uint8_t* txw_l2, const uint8_t* txh_l2,
               const uint8_t* edge_v, const uint8_t* edge_h,
               const int32_t* src, int vis_w, int vis_h, double* sse_out,
               int n_threads, int row_sub) {
  using namespace deblock;
  using search::run_threaded;
  // row_sub > 1 (search mode only): filter + score every row_sub'th 64px
  // superblock row. The level argmin over thousands of edges is
  // insensitive to the spatial subsample (same trade the CDEF search
  // makes); the final apply passes row_sub = 1 for the decoder-exact
  // full pass.
  if (row_sub < 1) row_sub = 1;
  auto sampled = [row_sub](int mr) {
    return row_sub == 1 || ((mr >> 4) % row_sub) == 0;
  };
  const size_t grid = (size_t)mi_rows * mi_cols;
  std::mutex acc_mu;
  for (int pl = 0; pl < P; pl++) {
    const int t = pl == 0 ? 0 : 1;
    const uint8_t* tw = txw_l2 + t * grid;
    const uint8_t* th = txh_l2 + t * grid;
    const uint8_t* ev = edge_v + t * grid;
    const uint8_t* eh = edge_h + t * grid;
    int32_t* base = planes + (size_t)pl * Hp * Wp;
    const int32_t* sp = src ? src + (size_t)pl * Hp * Wp : nullptr;
    double acc = 0.0;
    const int lvl_v = pl == 0 ? levels[0] : levels[pl + 1];
    const int lvl_h = pl == 0 ? levels[1] : levels[pl + 1];
    if (lvl_v > 0) {
      LineCtx c;
      make_ctx(c, lvl_v, bit_depth);
      auto vworker = [&](int r0, int r1) {
        int32_t keep[14];
        double lacc = 0.0;
        for (int mr = r0; mr < r1; mr++) {
          if (!sampled(mr)) continue;
          for (int mc = 1; mc < mi_cols; mc++) {
            const int x = mc * 4;
            const size_t mi = (size_t)mr * mi_cols + mc;
            if (!ev[mi]) continue;
            const int mw = 1 << (tw[mi - 1] < tw[mi] ? tw[mi - 1] : tw[mi]);
            const int size =
                pl == 0 ? (mw >= 16 ? 14 : mw >= 8 ? 8 : 4)
                        : (mw >= 8 ? 6 : 4);
            const int reach = size / 2;
            for (int dy = 0; dy < 4; dy++) {
              const int y = mr * 4 + dy;
              int32_t* px = base + (size_t)y * Wp + x;
              if (sp && y < vis_h) {
                for (int k = -reach; k < reach; k++) keep[k + reach] = px[k];
                filter_line(px, 1, size, c);
                const int32_t* srow = sp + (size_t)y * Wp;
                for (int k = -reach; k < reach; k++) {
                  if ((unsigned)(x + k) >= (unsigned)vis_w) continue;
                  if (px[k] == keep[k + reach]) continue;
                  const double dn = px[k] - srow[x + k];
                  const double od = keep[k + reach] - srow[x + k];
                  lacc += dn * dn - od * od;
                }
              } else {
                filter_line(px, 1, size, c);
              }
            }
          }
        }
        std::lock_guard<std::mutex> g(acc_mu);
        acc += lacc;
      };
      run_threaded(mi_rows, n_threads, vworker);
    }
    if (lvl_h > 0) {
      LineCtx c;
      make_ctx(c, lvl_h, bit_depth);
      auto hworker = [&](int c0, int c1) {
        int32_t keep[14];
        double lacc = 0.0;
        for (int mc = c0; mc < c1; mc++) {
          for (int mr = 1; mr < mi_rows; mr++) {
            if (!sampled(mr)) continue;
            const int y = mr * 4;
            const size_t mi = (size_t)mr * mi_cols + mc;
            if (!eh[mi]) continue;
            const size_t up = mi - mi_cols;
            const int mh = 1 << (th[up] < th[mi] ? th[up] : th[mi]);
            const int size =
                pl == 0 ? (mh >= 16 ? 14 : mh >= 8 ? 8 : 4)
                        : (mh >= 8 ? 6 : 4);
            const int reach = size / 2;
            for (int dx = 0; dx < 4; dx++) {
              const int x = mc * 4 + dx;
              int32_t* px = base + (size_t)y * Wp + x;
              if (sp && x < vis_w) {
                for (int k = -reach; k < reach; k++)
                  keep[k + reach] = px[(ptrdiff_t)k * Wp];
                filter_line(px, Wp, size, c);
                for (int k = -reach; k < reach; k++) {
                  if ((unsigned)(y + k) >= (unsigned)vis_h) continue;
                  const int32_t nv = px[(ptrdiff_t)k * Wp];
                  if (nv == keep[k + reach]) continue;
                  const double dn = nv - sp[(size_t)(y + k) * Wp + x];
                  const double od =
                      keep[k + reach] - sp[(size_t)(y + k) * Wp + x];
                  lacc += dn * dn - od * od;
                }
              } else {
                filter_line(px, Wp, size, c);
              }
            }
          }
        }
        std::lock_guard<std::mutex> g(acc_mu);
        acc += lacc;
      };
      run_threaded(mi_cols, n_threads, hworker);
    }
    if (sse_out) sse_out[pl] = acc;
  }
  return 0;
}

// CDEF direction + variance per 8x8 block from the deblocked luma plane.
// dirs/vars: (sb8r, sb8c) with sb8r = ceil(mi_rows/2), sb8c = ceil(mi_cols/2).
int of_cdef_dirs(const int32_t* luma, int Hp, int Wp, int mi_rows,
                 int mi_cols, int bit_depth, uint8_t* dirs, int32_t* vars,
                 int n_threads) {
  (void)Hp;
  const int sb8r = (mi_rows + 1) >> 1, sb8c = (mi_cols + 1) >> 1;
  auto worker = [&](int r0, int r1) {
    for (int br = r0; br < r1; br++)
      for (int bc = 0; bc < sb8c; bc++) {
        int d;
        int32_t v;
        cdefns::direction(luma + (size_t)br * 8 * Wp + bc * 8, Wp,
                          bit_depth, &d, &v);
        dirs[br * sb8c + bc] = (uint8_t)d;
        vars[br * sb8c + bc] = v;
      }
  };
  search::run_threaded(sb8r, n_threads, worker);
  return 0;
}

// Batched CDEF strength search: SSE delta (filter vs passthrough, over
// the visible crop) for every (pri_cands[i], SEC_ACT[j]) combo, in one
// threaded pass. out_y: n_pri*4 luma deltas; out_uv (nullable, P==3):
// same for the chroma pair (planes 1+2, shared strengths).
int of_cdef_search(const int32_t* in, const int32_t* src, int P, int Hp,
                   int Wp, int mi_rows, int mi_cols, int bit_depth,
                   int damping, const int32_t* pri_cands, int n_pri,
                   const uint8_t* skip, const uint8_t* dirs,
                   const int32_t* vars, int vis_w, int vis_h, int n_threads,
                   int sub, int fast_sec, int per_sb, double* out_y,
                   double* out_uv) {
  if (n_pri < 1 || n_pri > 16) return 1;
  const int sb8r = (mi_rows + 1) >> 1;
  const int n_sb64 = ((mi_rows + 15) >> 4) * ((mi_cols + 15) >> 4);
  const size_t NC = (size_t)n_pri * 4 * (per_sb ? n_sb64 : 1);
  std::memset(out_y, 0, NC * sizeof(double));
  if (out_uv) std::memset(out_uv, 0, NC * sizeof(double));
  // work items: (plane, block-row slab)
  struct Item { int pl, br0, br1; };
  std::vector<Item> items;
  const int slab = 8;  // 64 pixel rows per item
  for (int pl = 0; pl < P; pl++) {
    if (pl > 0 && !out_uv) break;
    for (int br = 0; br < sb8r; br += slab)
      items.push_back({pl, br, br + slab < sb8r ? br + slab : sb8r});
  }
  if (n_threads < 1) n_threads = 1;
  if ((size_t)n_threads > items.size()) n_threads = (int)items.size();
  std::vector<std::vector<double>> accs(
      n_threads, std::vector<double>(2 * NC, 0.0));
  std::atomic<int> next(0);
  auto worker = [&](int tid) {
    cdefns::SearchPlaneArgs a;
    a.Hp = Hp;
    a.Wp = Wp;
    a.mi_rows = mi_rows;
    a.mi_cols = mi_cols;
    a.bit_depth = bit_depth;
    a.damping = damping;
    a.pri_cands = pri_cands;
    a.n_pri = n_pri;
    a.skip = skip;
    a.dirs = dirs;
    a.vars = vars;
    a.vis_w = vis_w;
    a.vis_h = vis_h;
    a.sub = sub < 1 ? 1 : sub;
    a.fast_sec = fast_sec;
    a.per_sb = per_sb;
    for (;;) {
      const int it = next.fetch_add(1);
      if (it >= (int)items.size()) break;
      const Item& item = items[it];
      a.in = in + (size_t)item.pl * Hp * Wp;
      a.src = src + (size_t)item.pl * Hp * Wp;
      double* acc = accs[tid].data() + (item.pl == 0 ? 0 : NC);
      cdefns::search_plane_rows(a, item.pl == 0, item.br0, item.br1, acc);
    }
  };
  if (n_threads <= 1) {
    worker(0);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < n_threads; t++) ths.emplace_back(worker, t);
    for (auto& th : ths) th.join();
  }
  for (int t = 0; t < n_threads; t++) {
    for (size_t c = 0; c < NC; c++) out_y[c] += accs[t][c];
    if (out_uv)
      for (size_t c = 0; c < NC; c++) out_uv[c] += accs[t][NC + c];
  }
  return 0;
}

// Apply CDEF: read the deblocked frame `in` (P, Hp, Wp), write `out`
// (nullable: skip writes — strength-search mode). strengths: [y_pri,
// y_sec, uv_pri, uv_sec] (sec is the actual value, i.e. coded 3 means 4).
// skip: (mi_rows, mi_cols) per-4x4 skip flags; an 8x8 is filtered iff any
// covered 4x4 is non-skip. With src != null accumulates the per-plane
// visible-crop SSE delta into sse_out[P] (filter vs passthrough).
int of_cdef_apply(const int32_t* in, int32_t* out, int P, int Hp, int Wp,
                  int mi_rows, int mi_cols, int bit_depth, int damping,
                  const int32_t* strengths, const uint8_t* skip,
                  const uint8_t* dirs, const int32_t* vars,
                  const int32_t* src, int vis_w, int vis_h, int n_threads,
                  double* sse_out) {
  using cdefns::FilterParams;
  const int sb8r = (mi_rows + 1) >> 1, sb8c = (mi_cols + 1) >> 1;
  const int cw = mi_cols * 4, ch = mi_rows * 4;
  // (plane, block-row slab) work items; 8x8 blocks write disjoint pixels.
  // The in->out plane copy runs INSIDE the slabs (copy_only for planes
  // with zero strengths): a single-threaded up-front memcpy of the padded
  // stack (~400 MB at 8K) dominated the whole apply.
  struct Item { int pl, br0, br1; bool copy_only; };
  std::vector<Item> items;
  const int slab = 8;
  const bool need_copy = out && out != in;
  for (int pl = 0; pl < P; pl++) {
    const bool luma = pl == 0;
    const int pri = luma ? strengths[0] : strengths[2];
    const int sec = luma ? strengths[1] : strengths[3];
    if (sse_out) sse_out[pl] = 0.0;
    const bool copy_only = pri == 0 && sec == 0;
    if (copy_only && !need_copy) continue;
    for (int br = 0; br < sb8r; br += slab)
      items.push_back({pl, br, br + slab < sb8r ? br + slab : sb8r,
                       copy_only});
  }
  if (n_threads < 1) n_threads = 1;
  if ((size_t)n_threads > items.size()) n_threads = (int)items.size();
  std::vector<std::vector<double>> accs(
      n_threads < 1 ? 1 : n_threads, std::vector<double>(P, 0.0));
  std::atomic<int> next(0);
  auto worker = [&](int tid) {
    int32_t out8[64];
    for (;;) {
      const int it = next.fetch_add(1);
      if (it >= (int)items.size()) break;
      const Item& item = items[it];
      const int pl = item.pl;
      const int32_t* ip = in + (size_t)pl * Hp * Wp;
      int32_t* op = out ? out + (size_t)pl * Hp * Wp : nullptr;
      const int32_t* sp = src ? src + (size_t)pl * Hp * Wp : nullptr;
      if (need_copy) {
        // slab rows in pixels; the last slab also covers the padded tail
        const int y0 = item.br0 * 8;
        int y1 = item.br1 * 8;
        if (item.br1 >= sb8r) y1 = Hp;
        if (y1 > Hp) y1 = Hp;
        std::memcpy(op + (size_t)y0 * Wp, ip + (size_t)y0 * Wp,
                    (size_t)(y1 - y0) * Wp * sizeof(int32_t));
      }
      if (item.copy_only) continue;
      const bool luma = pl == 0;
      FilterParams fp;
      fp.pri = luma ? strengths[0] : strengths[2];
      fp.sec = luma ? strengths[1] : strengths[3];
      fp.damping = damping;
      fp.bd = bit_depth;
      fp.coeff_shift = bit_depth - 8;
      double acc = 0.0;
      for (int br = item.br0; br < item.br1; br++) {
        const int y0 = br * 8;
        const int fh = (ch - y0) < 8 ? (ch - y0) : 8;
        for (int bc = 0; bc < sb8c; bc++) {
          // all-skip 8x8 blocks are not filtered
          const int r1 = (br * 2 + 2) < mi_rows ? br * 2 + 2 : mi_rows;
          const int c1 = (bc * 2 + 2) < mi_cols ? bc * 2 + 2 : mi_cols;
          bool all_skip = true;
          for (int r = br * 2; r < r1 && all_skip; r++)
            for (int c = bc * 2; c < c1; c++)
              if (!skip[(size_t)r * mi_cols + c]) {
                all_skip = false;
                break;
              }
          if (all_skip) continue;
          const int x0 = bc * 8;
          const int fw = (cw - x0) < 8 ? (cw - x0) : 8;
          cdefns::filter8(ip, Wp, y0, x0, fw, fh, cw, ch,
                          dirs[br * sb8c + bc], vars[br * sb8c + bc], luma,
                          fp, out8);
          if (sp) {
            const int ih = fh < vis_h - y0 ? fh : vis_h - y0;
            const int iw = fw < vis_w - x0 ? fw : vis_w - x0;
            for (int i = 0; i < ih; i++)
              for (int j = 0; j < iw; j++) {
                const double s = sp[(size_t)(y0 + i) * Wp + x0 + j];
                const double dn = out8[i * 8 + j] - s;
                const double od = ip[(size_t)(y0 + i) * Wp + x0 + j] - s;
                acc += dn * dn - od * od;
              }
          }
          if (op)
            for (int i = 0; i < fh; i++)
              for (int j = 0; j < fw; j++)
                op[(size_t)(y0 + i) * Wp + x0 + j] = out8[i * 8 + j];
        }
        if (sse_out) accs[tid][pl] += acc;
        acc = 0.0;
      }
    }
  };
  if (n_threads <= 1) {
    worker(0);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < n_threads; t++) ths.emplace_back(worker, t);
    for (auto& th : ths) th.join();
  }
  if (sse_out)
    for (int t = 0; t < (int)accs.size(); t++)
      for (int pl = 0; pl < P; pl++) sse_out[pl] += accs[t][pl];
  return 0;
}

// Contract introspection: lets the Python side verify that the compiled
// library and op_contract.h agree (tests/test_contract.py).
int tc_op_arity(int op) {
#define CAVIF_X(NAME, CODE, ARITY) \
  if (op == CODE) return ARITY;
  CAVIF_OP_TABLE(CAVIF_X)
#undef CAVIF_X
  return -1;
}

int tc_cand_mode(int i) {
  if (i < 0 || i >= CAVIF_CAND_MODES_N) return -1;
  return search::CAND_MODES[i];
}

}  // extern "C"
