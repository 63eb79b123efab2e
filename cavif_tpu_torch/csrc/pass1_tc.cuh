// Building blocks shared by the tensor-core kernels (pass1_nd_cost.cu, K2;
// through dir_tc.cuh, pass1_dir_cost.cu, K1, and dir_cost_tc.cu, K4/K5;
// mode_search_cost.cu, K3): the bf16 and f16 mma.sync products fed by
// ldmatrix (which moves 16-bit elements of either type), the 16-byte
// cp.async ring, and the quantizer lane cost with its rounding pinned.
//
// Shared-memory tiles are bf16 rows padded by 8 elements (16 bytes): every
// row length used here is then an odd number of 16-byte units, so the
// eight row addresses of one ldmatrix phase fall into eight different bank
// groups (no conflicts) without a swizzle. The constant tiles are stored
// in device memory already padded (ops/pass1_kernels.pack_kt, pack_mk), so a
// ring stage is one contiguous run of 16-byte copies.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pass1 {

constexpr int NT = 256;  // threads per block: eight warps
constexpr int PAD = 8;   // bf16 elements of padding per shared-memory row
constexpr int NS = 3;    // stages of the constant-operand ring

// Per-lane quantizer cost of |coef| = a. __fmul_rn / __fadd_rn keep nvcc
// from contracting a * inv + bias (or e * e + lam * r) into an FMA, which
// would move floor() at a level boundary away from the plain version.
__device__ __forceinline__ float lane_cost(float a, float inv, float scale,
                                           float bias, float lam) {
  const float l = floorf(__fadd_rn(__fmul_rn(a, inv), bias));
  const float e = __fsub_rn(a, __fmul_rn(l, scale));
  const float r = __fadd_rn(l, l != 0.0f ? 2.0f : 0.0f);
  return __fadd_rn(__fmul_rn(e, e), __fmul_rn(lam, r));
}

// sum over the four threads of a quad (the threads holding one row of an
// mma fragment): (t0 + t1) + (t2 + t3) in every thread
__device__ __forceinline__ float quad_sum(float s) {
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
  return __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 matrices of 16-bit elements (bf16 or f16) from shared memory;
// lane t gives the address of row (t & 7) of matrix (t >> 3).
template <class T>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const T* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x16, row) * b (16x8, col), f16 in, f32 accumulate
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16-row slab at `rows` (row stride ld elements), k
// columns k0..k0+15: matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15) are a0..a3 of mma.m16n8k16.
template <class T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* rows,
                                       int ld, int k0, int lane) {
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(a, rows + r * ld + k0 + (lane >> 4) * 8);
}

// B fragments of two neighbouring 8-column tiles from an [n][k] tile (row
// stride ld elements), columns n0..n0+15, k0..k0+15: b[0], b[1] of the
// first tile, b[2], b[3] of the second.
template <class T>
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const T* tile,
                                        int ld, int n0, int k0, int lane) {
  const int m = lane >> 3;
  ldmatrix_x4(b, tile + (n0 + (m >> 1) * 8 + (lane & 7)) * ld + k0 +
                     (m & 1) * 8);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `bytes` (a multiple of 16) from device to shared memory with all
// nt threads of the block, 16 bytes each per step (the caller commits the
// group).
__device__ __forceinline__ void stage_copy(void* dst, const void* src,
                                           int bytes, int tid, int nt = NT) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  for (int o = tid * 16; o < bytes; o += nt * 16) cp_async16(d + o, s + o);
}

// The second pass of a kernel whose blocks split a row's lanes into nch
// chunks, each chunk's partials laid out as the output (n elements):
// out[i] = sum_c part[c * n + i], added in chunk order (deterministic, no
// atomics).
__global__ void __launch_bounds__(NT)
sum_chunks(const float* __restrict__ part, float* __restrict__ out,
           long long n, int nch) {
  const long long i = blockIdx.x * (long long)NT + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int c = 1; c < nch; ++c) s = __fadd_rn(s, part[c * n + i]);
  out[i] = s;
}

}  // namespace pass1
