// Directional-candidate costs on the bf16 tensor cores (kernels K4, K5).
//
// Replaces the TPU kernels of the pass-1 prototype harnesses:
//   K4 `pallas_fused` of tools/pallas_proto.py  (variant FULL, reduce
//      "matmul" = STAGED or "loop" = REGS)
//   K5 `make` of tools/pallas_proto2.py         (every variant, STAGED)
// Both compute K1's function (csrc/pass1_dir_cost.cu), the lane value u
// changed by K5's variant; the kernel is dir_tc.cuh's template, K1's own
// (its formulas, layout and reduce modes are described there). One entry
// point, dir_cost_tc, takes the variant and the reduce mode.
//
// What bounds it on an H100: operations, on the CUDA cores. Per harness
// tier (R = 3 (1024 / b)^2 rows, C = 56, n2 = b^2: 1.76e8 (row, candidate,
// lane) elements) the product is 2 E flops an element on the tensor cores
// (0.36 us per million at E = 129 against 989 TFLOP/s) and the full
// epilogue about 15 FP32 instructions an element (0.45 us per million at
// 132 SMs x 128 lanes x 1.98 GHz): 0.316 ms over the four tiers. Bytes
// (4-24 MB a tier) are far below both.
//
// Design (in brackets, the faults of the first version, which ran at 14x
// this bound, half of it in the product and its staging).
// - The tile is (TM rows, LT lanes), one of (128, 32), (64, 32), (128, 16)
//   (ops/proto_kernels.TILES; LT is a cap: min(n2, LT)); a block of 2 TM
//   threads owns TM rows and one chunk of LT lanes and loops over all 56
//   candidates [a block of four warps per 64 rows and 64 columns of MK].
//   TM is the block size at launch, not a template parameter.
// - ext is rounded to bf16 once per block, and each warp keeps its A
//   fragments in registers for every candidate [ext restaged for every
//   column block: 14-56 times per row tile].
// - bkt and the lane constants are loaded once per thread into registers
//   [re-read with __ldg for every element and candidate].
// - MK comes packed once per set of constants (pack_mk with the tile's LT;
//   the harnesses pack it in their closures, outside the timed call) and
//   streams through a three-stage ring of 16-byte cp.async copies [2-byte
//   transposing loads with an integer divide each, one buffer between two
//   barriers, restaged for every 64-row block].
// - STAGED sums in each warp's own shared-memory slab, two threads per
//   row, with no block barrier [one thread per row, a dependent chain of
//   64 adds, 64 of 128 threads busy, between two block barriers].
// - Instantiated for KS = ceil(E / 16) in {2, 3, 5, 9} (E = 4b + 1 at the
//   four tiers and K1's square shapes) and LT in {16, 32}: 8 shapes x 6
//   (variant, reduce) pairs = 48 kernels [18].
// - Sums leave as whole 32-byte runs of a row (dir_tc.cuh), chunk
//   partials in (chunk, row, candidate) order [one scattered 4-byte store
//   per (row, candidate), and a transposing chunk sum].
//
// Registers 59-60 at tier 4, 121-127 at tiers 8-32 with 32 lanes, 64-115
// with 16; shared memory 11-93 KB per block; 1536 blocks at tier 4 and at
// 64 rows or 16 lanes, 768 otherwise (chip_smoke.py's [proto] lines,
// dir_cost_tc_info).
//
// Measured (chip_smoke.py, CUDA events, NVIDIA H100 80GB HBM3 at 700 W):
// over the four tiers at the default tile (128, 32), "matmul" 0.98-0.99
// ms and "loop" 0.93-0.94 ms (the first version: 4.47 and 3.86 at its
// default), against the 0.316 ms bound and 1.36 ms for one torch.matmul of
// the bf16 product alone; per tier 0.19-0.31 ms, "loop" at K1's real
// shapes in K1's time, bit for bit. K5's split (shares of "full"):
// mm_only 0.61-0.80, no_quant 0.66-0.82, no_sign 0.99-1.10.

#include "dir_tc.cuh"

namespace {

using namespace pass1;

struct Launch {
  const DirArgs& p;
  const DirCfg& c;
  cudaStream_t stream;
  template <int KS, int NTW, int V, int RED>
  int run() const { return dir_tc_launch<KS, NTW, V, RED>(p, c, stream); }
};

struct Attributes {
  cudaFuncAttributes* attr;
  template <int KS, int NTW, int V, int RED>
  int run() const {
    return static_cast<int>(
        cudaFuncGetAttributes(attr, dir_tc_kernel<KS, NTW, V, RED>));
  }
};

template <int V, int RED, class F>
int by_shape(const DirCfg& c, const F& f) {
  const bool w = c.NTW == 4;
  switch (c.KS) {
    case 2: return w ? f.template run<2, 4, V, RED>()
                     : f.template run<2, 2, V, RED>();
    case 3: return w ? f.template run<3, 4, V, RED>()
                     : f.template run<3, 2, V, RED>();
    case 5: return w ? f.template run<5, 4, V, RED>()
                     : f.template run<5, 2, V, RED>();
    case 9: return w ? f.template run<9, 4, V, RED>()
                     : f.template run<9, 2, V, RED>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4 "loop" is (FULL, REGS); every variant reduces STAGED
template <class F>
int dispatch(const DirCfg& c, int variant, int reduce, const F& f) {
  if ((c.TM != 64 && c.TM != 128) || (c.NTW != 2 && c.NTW != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reduce == REGS)
    return variant == FULL ? by_shape<FULL, REGS>(c, f)
                           : static_cast<int>(cudaErrorInvalidValue);
  if (reduce != STAGED) return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case FULL: return by_shape<FULL, STAGED>(c, f);
    case MM_ONLY: return by_shape<MM_ONLY, STAGED>(c, f);
    case NO_QUANT: return by_shape<NO_QUANT, STAGED>(c, f);
    case NO_SIGN: return by_shape<NO_SIGN, STAGED>(c, f);
    case RED_BF16: return by_shape<RED_BF16, STAGED>(c, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// mk_tiles: pack_mk(mk, n2, lt)'s (n2 / LT, C, LT, Ep + 8) bf16 tiles;
// part: (n2 / LT) * C * R floats of scratch when n2 > LT (else unused);
// tm rows and lt lanes per block; variant 0..4 = full, mm_only, no_quant,
// no_sign, red_bf16; reduce 0 = "matmul" (STAGED), 1 = "loop" (REGS, full
// only).
extern "C" int dir_cost_tc(const float* ext, const float* bkt,
                           const void* mk_tiles, const float* cc,
                           const float* inv, const float* scale,
                           const float* bias, float lam, float* out,
                           float* part, int R, int E, int n2, int C, int tm,
                           int lt, int variant, int reduce,
                           cudaStream_t stream) {
  const DirCfg c = dir_config(E, n2, tm, lt, reduce == STAGED);
  const DirArgs p{ext, bkt, static_cast<const __nv_bfloat16*>(mk_tiles), cc,
                  inv, scale, bias, lam, out, part, R, E, n2, C, c.nch};
  return dispatch(c, variant, reduce, Launch{p, c, stream});
}

// info as pass1_dir_cost_info's, for the same arguments as dir_cost_tc's
extern "C" int dir_cost_tc_info(int R, int E, int n2, int C, int tm, int lt,
                                int variant, int reduce, int* info) {
  const DirCfg c = dir_config(E, n2, tm, lt, reduce == STAGED);
  cudaFuncAttributes attr;
  const int err = dispatch(c, variant, reduce, Attributes{&attr});
  return dir_tc_info(c, R, C, err, attr, info);
}
