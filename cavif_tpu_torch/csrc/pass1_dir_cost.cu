// Directional-candidate costs of the device pass 1 (kernel K1), on the
// bf16 tensor cores.
//
// Replaces the TPU kernel `_fused_dir_cost` of
// cavif_tpu/ops/device_pass1.py (_cost_body). For every block row r and
// directional candidate c it computes, per coefficient lane k < n2,
//   cp   = sum_e bf16(ext[r, e]) * MK[e, c*n2 + k]          (f32 accumulate)
//   a    = |bkt[r, k] - (cp * (1/32) + cc[k])|
//   l    = floor(a * inv[k] + bias[k]),  e = a - l * scale[k]
//   u    = e * e + lam * (l + 2 * [l != 0])
// and writes out[r, c] = sum_k u. MK is the prediction matrix folded into
// the Kronecker DCT (bfloat16), so the (R, cdir * n2) coefficient tensor
// exists only in registers.
//
// What bounds it on an H100: operations, and on the CUDA cores. The product
// is 2 * R * E * cdir * n2 tensor-core flops (0.186 TFLOP per 1 MP frame
// over the ten block shapes, 0.19 ms at the bf16 peak); the epilogue is
// about 15 FP32 instructions per (row, candidate, lane), 1.31e9 elements a
// frame, 0.59 ms at one instruction per lane and clock. Bytes (15-32 MB a
// launch) are far below both.
//
// The kernel is dir_tc.cuh's template with the full lane value summed in
// registers (FULL, REGS), at 128 rows and 32 lanes a block: the same
// instantiation as K4 "loop" at its default tile (dir_cost_tc.cu), which
// therefore gives K1's costs bit for bit.
//
// Design (in brackets, the faults of the earlier CUDA-core version).
// - The product runs on the tensor cores [on the CUDA cores in f32]:
//   mma.sync.m16n8k16 fed by ldmatrix, ext rounded to bf16 (RNE) as before.
//   mma.sync rather than wgmma: the bound is the epilogue on the CUDA
//   cores, and a warp's fragment layout lets every thread keep its own
//   lanes' constants in registers across all candidates (below).
// - A block owns 128 rows (eight warps of 16) and one chunk of LT = 32
//   lanes (16 at n2 = 16) and loops over all cdir candidates [a block per
//   64 rows and candidate]. It rounds and pads its rows' ext once into
//   shared memory, 128 x (Ep + 8) bf16 (38 KB at Ep = 144), and each warp
//   then holds its 16 rows' A fragments in registers for every candidate
//   [ext restaged for every candidate].
// - Each thread loads bkt of its 2 rows x 2 * NTW lanes and the lane
//   constants cc, inv, scale, bias of its lanes once, into registers, and
//   reuses them for every candidate [bkt and the four constants re-read
//   per element and candidate, 704 MB of L2 traffic per 56-candidate
//   shape].
// - MK is laid out once per ShapeCost (ops/pass1_kernels.pack_mk) as
//   (chunk, candidate, LT, Ep + 8) bf16 tiles: the ldmatrix order
//   ([lane][e], e contiguous), E zero-padded to the k-step and by 8 more so
//   that rows land in distinct bank groups. A candidate's tile is one ring
//   stage: three stages of 16-byte cp.async copies [2-byte transposing
//   loads widened to f32 for every 64-row block, one buffer].
// - Blocks per 1 MP frame: 1536 at 4x4, 768 at every other shape (R / 128
//   row tiles x n2 / 32 chunks) [R / 64 x cdir or x ncols / 64].
// - A (row, candidate) sum is the thread's 2 * NTW lanes in order, then a
//   quad butterfly. Each warp stages its rows' sums of eight candidates in
//   shared memory and writes each row's eight as one 32-byte run; with
//   n2 > 32 the chunk partials go to (chunk, row, candidate) scratch and a
//   second small kernel adds them in chunk order, element by element
//   [4-byte stores 4 cdir bytes apart, and a chunk sum writing transposed:
//   24% of the 8x8 shape's time]. Deterministic, no atomics. Partials and
//   offsets use 64-bit indices (the batched path runs 4x the rows).
// - Rounding: the epilogue is the CUDA-core version's, __fmul_rn /
//   __fadd_rn around floor() (pass1_tc.cuh lane_cost).
//
// Registers 59 (4x4), 98 (8x4), 121 (8x8, 16x8), 123 (16x16), 122-126
// (32-wide); shared memory 18-72 KB per block.
//
// Measured (chip_smoke.py, CUDA events, NVIDIA H100 80GB HBM3 at 700 W):
// 1.86-1.88 ms per 1 MP frame over the ten shapes (1.99-2.03 before the
// output staging, in the same call), against a bound of 0.587 ms (the
// epilogue) and 2.66 ms for one torch.matmul of the bf16 product alone
// (the CUDA-core version: 12.49 ms). The 56-candidate shapes take
// 0.206-0.289 ms, 2.6-3.7x their 0.079 ms bound; K5's ablation on the
// same kernel puts 65-80% of that time outside the quantizer. The
// 8-candidate shapes (0.04-0.08 ms) are bound by the host, which takes
// nearly all of that time to issue a wrapper call.

#include "dir_tc.cuh"

namespace {

using namespace pass1;

constexpr int TM = 128;  // rows per block: 16 per warp
constexpr int LT = 32;   // lanes per chunk (16 at n2 = 16)

// The instantiation of the configuration: E = 2 (bw + bh) + 1 gives KS in
// {2, 3, 4, 5, 7, 9}; n2 = 16 alone has NTW = 2 (and KS = 2).
template <class F>
int dispatch(const DirCfg& c, const F& f) {
  if (c.NTW == 2)
    return c.KS == 2 ? f.template run<2, 2>()
                     : static_cast<int>(cudaErrorInvalidValue);
  switch (c.KS) {
    case 2: return f.template run<2, 4>();
    case 3: return f.template run<3, 4>();
    case 4: return f.template run<4, 4>();
    case 5: return f.template run<5, 4>();
    case 7: return f.template run<7, 4>();
    case 9: return f.template run<9, 4>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1 is the template's full lane value summed in registers (REGS)
struct Launch {
  const DirArgs& p;
  const DirCfg& c;
  cudaStream_t stream;
  template <int KS, int NTW>
  int run() const { return dir_tc_launch<KS, NTW, FULL, REGS>(p, c, stream); }
};

struct Attributes {
  cudaFuncAttributes* attr;
  template <int KS, int NTW>
  int run() const {
    return static_cast<int>(
        cudaFuncGetAttributes(attr, dir_tc_kernel<KS, NTW, FULL, REGS>));
  }
};

}  // namespace

// mk_tiles: pack_mk's (n2 / LT, cdir, LT, Ep + 8) bf16 tiles; part:
// (n2 / LT) * cdir * R floats of scratch when n2 > 32 (else unused).
extern "C" int pass1_dir_cost(const float* ext, const float* bkt,
                              const void* mk_tiles, const float* cc,
                              const float* inv, const float* scale,
                              const float* bias, float lam, float* out,
                              float* part, int R, int E, int n2, int cdir,
                              cudaStream_t stream) {
  const DirCfg c = dir_config(E, n2, TM, LT, false);
  const DirArgs p{ext, bkt, static_cast<const __nv_bfloat16*>(mk_tiles), cc,
                  inv, scale, bias, lam, out, part, R, E, n2, cdir, c.nch};
  return dispatch(c, Launch{p, c, stream});
}

// info = {blocks of the main grid, registers per thread, dynamic shared
// memory bytes per block, blocks of the chunk-sum pass (0 if none)}
extern "C" int pass1_dir_cost_info(int R, int E, int n2, int cdir,
                                   int* info) {
  const DirCfg c = dir_config(E, n2, TM, LT, false);
  cudaFuncAttributes attr;
  const int err = dispatch(c, Attributes{&attr});
  return dir_tc_info(c, R, cdir, err, attr, info);
}
