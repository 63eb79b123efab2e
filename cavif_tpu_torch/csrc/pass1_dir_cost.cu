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
// - A (row, candidate) sum is the thread's 2 * NTW lanes in order, a quad
//   butterfly, then (n2 > 32) a second small kernel adding the n2 / 32
//   chunk partials in chunk order. Deterministic, no atomics. Partials and
//   offsets use 64-bit indices (the batched path runs 4x the rows).
// - Rounding: the epilogue is the CUDA-core version's, __fmul_rn /
//   __fadd_rn around floor() (pass1_tc.cuh lane_cost).
//
// Registers 52 (4x4), 80 (8x4), 96 (8x8), 112 (16x8), 120 (16x16), 124
// (32-wide); shared memory 14-68 KB per block.
//
// Measured (chip_smoke.py, CUDA events, NVIDIA H100 80GB HBM3 at 700 W):
// 1.964 ms per 1 MP frame over the ten shapes, against a bound of 0.587 ms
// (the epilogue) and 2.648 ms for one torch.matmul of the bf16 product
// alone (the CUDA-core version: 12.49 ms). The 56-candidate shapes take
// 0.244-0.288 ms, 3.1-3.7x their 0.079 ms bound, nearly the same at E = 33
// and E = 129: the quantizer's CUDA-core instructions, not the product,
// set their time, issued at about a third of the card's rate with a block
// barrier per candidate. The 8-candidate shapes (0.042-0.054 ms) are bound
// by the host: it takes 94-96% of that time to issue a wrapper call.

#include "pass1_tc.cuh"

namespace {

using namespace pass1;

constexpr int TM = 128;  // rows per block: 16 per warp

struct Cfg {
  int LT, NTW, KS, Ep, nch;
  size_t smem;
};

Cfg config(int E, int n2) {
  Cfg c;
  c.LT = n2 < 32 ? n2 : 32;
  c.NTW = c.LT / 8;
  c.KS = (E + 15) / 16;
  c.Ep = 16 * c.KS;
  c.nch = n2 / c.LT;
  c.smem = (size_t(NS) * c.LT + TM) * (c.Ep + PAD) * 2;
  return c;
}

struct Args {
  const float* ext;
  const float* bkt;
  const __nv_bfloat16* mk;  // packed tiles (pack_mk)
  const float* cc;
  const float* inv;
  const float* scale;
  const float* bias;
  float lam;
  float* out;
  float* part;
  int R, E, n2, cdir, nch;
};

template <int KS, int NTW>
__global__ void __launch_bounds__(NT) dir_cost_kernel(Args p) {
  constexpr int LT = NTW * 8;
  constexpr int SA = KS * 16 + PAD;  // row stride of ext and MK tiles
  constexpr int stage = LT * SA;     // bf16 elements per ring stage
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [NS][LT][SA]
  __nv_bfloat16* xs = ring + NS * stage;                          // [TM][SA]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const long long row0 = (long long)blockIdx.x * TM;
  const int ch = blockIdx.y;
  const int cdir = p.cdir, n2 = p.n2;
  const __nv_bfloat16* mk = p.mk + (size_t)ch * cdir * stage;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < cdir) stage_copy(ring + s * stage, mk + (size_t)s * stage,
                             stage * 2, tid);
    cp_async_commit();
  }

  // ext of the block's rows, rounded to bf16 and zero-padded, once
  for (int idx = tid; idx < TM * (SA / 2); idx += NT) {
    const int r = idx / (SA / 2), k = 2 * (idx - r * (SA / 2));
    const long long gr = row0 + r;
    const float* x = p.ext + gr * p.E;
    const bool in = gr < p.R;
    const float v0 = in && k < p.E ? x[k] : 0.0f;
    const float v1 = in && k + 1 < p.E ? x[k + 1] : 0.0f;
    *reinterpret_cast<__nv_bfloat162*>(xs + r * SA + k) =
        __floats2bfloat162_rn(v0, v1);
  }

  // the thread's lanes ch * LT + j * 8 + tig * 2 + e and rows
  // warp * 16 + g + 8h: bkt and the lane constants, kept for every
  // candidate
  const int c0 = ch * LT + tig * 2;
  float bk[2][NTW][2], cc[NTW][2], inv[NTW][2], scl[NTW][2], bia[NTW][2];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = c0 + j * 8 + e;
      cc[j][e] = __ldg(p.cc + k);
      inv[j][e] = __ldg(p.inv + k);
      scl[j][e] = __ldg(p.scale + k);
      bia[j][e] = __ldg(p.bias + k);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        long long gr = row0 + warp * 16 + g + 8 * h;
        gr = gr < p.R ? gr : p.R - 1;
        bk[h][j][e] = __ldg(p.bkt + gr * n2 + k);
      }
    }

  __syncthreads();  // ext staged
  uint32_t a[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    load_a(a[ks], xs + warp * 16 * SA, SA, ks * 16, lane);

  const long long gr0 = row0 + warp * 16 + g;
  for (int c = 0; c < cdir; ++c) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // candidate c's tile landed; c - 1's is free again
    const int nx = c + NS - 1;
    if (nx < cdir) stage_copy(ring + (nx % NS) * stage,
                              mk + (size_t)nx * stage, stage * 2, tid);
    cp_async_commit();
    const __nv_bfloat16* bt = ring + (c % NS) * stage;

    float acc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int jp = 0; jp < NTW / 2; ++jp) {
        uint32_t b[4];
        load_b2(b, bt, SA, jp * 16, ks * 16, lane);
        mma_bf16(acc[2 * jp], a[ks], b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], a[ks], b[2], b[3]);
      }

    // element (j, 2h + e) of the fragments is row gr0 + 8h, lane
    // c0 + j * 8 + e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float t = __fadd_rn(__fmul_rn(acc[j][2 * h + e], 0.03125f),
                                    cc[j][e]);
          const float av = fabsf(__fsub_rn(bk[h][j][e], t));
          s = __fadd_rn(s, lane_cost(av, inv[j][e], scl[j][e], bia[j][e],
                                     p.lam));
        }
      s = quad_sum(s);
      const long long gr = gr0 + 8 * h;
      if (tig == 0 && gr < p.R) {
        if (p.nch == 1)
          p.out[gr * cdir + c] = s;
        else
          p.part[((long long)ch * cdir + c) * p.R + gr] = s;
      }
    }
  }
}

template <int KS, int NTW>
int launch(const Args& p, const Cfg& c, cudaStream_t stream) {
  auto kern = dir_cost_kernel<KS, NTW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.R + TM - 1) / TM, c.nch);
  kern<<<grid, NT, c.smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || c.nch == 1) return static_cast<int>(err);
  // part is (chunk, candidate, row): sum the chunks, transpose to (row,
  // candidate)
  const long long n = (long long)p.R * p.cdir;
  sum_chunks<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(
      p.part, p.out, n, n, c.nch, p.R, p.cdir, 1);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of the configuration: E = 2 (bw + bh) + 1 gives KS in
// {2, 3, 4, 5, 7, 9}; n2 = 16 alone has NTW = 2 (and KS = 2).
template <class F>
int dispatch(const Cfg& c, const F& f) {
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

struct Launch {
  const Args& p;
  const Cfg& c;
  cudaStream_t stream;
  template <int KS, int NTW>
  int run() const { return launch<KS, NTW>(p, c, stream); }
};

struct Attributes {
  cudaFuncAttributes* attr;
  template <int KS, int NTW>
  int run() const {
    return static_cast<int>(
        cudaFuncGetAttributes(attr, dir_cost_kernel<KS, NTW>));
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
  const Cfg c = config(E, n2);
  const Args p{ext, bkt, static_cast<const __nv_bfloat16*>(mk_tiles), cc,
               inv, scale, bias, lam, out, part, R, E, n2, cdir, c.nch};
  return dispatch(c, Launch{p, c, stream});
}

// info = {blocks of the main grid, registers per thread, dynamic shared
// memory bytes per block, blocks of the chunk-sum pass (0 if none)}
extern "C" int pass1_dir_cost_info(int R, int E, int n2, int cdir,
                                   int* info) {
  const Cfg c = config(E, n2);
  cudaFuncAttributes attr;
  const int err = dispatch(c, Attributes{&attr});
  const long long n = (long long)R * cdir;
  info[0] = (R + TM - 1) / TM * c.nch;
  info[1] = err == 0 ? attr.numRegs : 0;
  info[2] = (int)c.smem;
  info[3] = c.nch > 1 ? (int)((n + NT - 1) / NT) : 0;
  return err;
}
