// 3x3, stride-1, pad-1 convolution + bias + optional ReLU for Hopper (sm_90a),
// the frozen VGG16's conv, forward and input gradient.
//
// Replaces swapnet_tpu/ops/conv3x3.py::_pallas_conv (the Pallas TPU kernel,
// which stages a padded image in VMEM and runs one im2col matmul
// [8W, 9C] x [9C, N] per 8-row chunk on the MXU).  Here the same product is
// an implicit GEMM over the whole batch:
//
//   out[m, n] = sum_k A[m, k] * Wm[k, n],   m = (b, h, w),  k = (dy, dx, c)
//   A[m, k]   = x[b, h + dy - 1, w + dx - 1, c]  (0 outside the image)
//
// with x channels-last (B, H, W, C), Wm the tap-major (9C, N) weight matrix
// (row (dy*3 + dx)*C + c), bias (N,) and out (B, H, W, N).  The im2col
// matrix is never written: each block gathers its slice of A straight from
// x into shared memory, zero-filling the halo, and its slice of Wm beside it.
//
// Numerics follow _kernel and flax.linen.Conv: the sum is float32 for both
// float32 and bfloat16 operands (a bf16 x bf16 product is exact in f32).
// For bfloat16 the sum is rounded to bf16, then the bf16 bias is added (in
// f32, rounded to bf16 again), then the ReLU; for float32 it is sum + bias,
// then the ReLU.
//
// The input gradient of the conv is the same kernel on the ReLU-masked
// output gradient with the weights flipped in both spatial axes and in/out
// swapped, zero bias and no ReLU; the wrapper builds that weight matrix.
//
// What bounds it on an H100: 2*9*C*N operations per output pixel against
// 2*(C + N) bytes in bf16, i.e. 288 operations per byte at C = N = 64 and
// more for every wider conv, at or above the tensor-core ridge of ~295.  So
// the bf16 form is compute-bound and belongs on the tensor cores:
//
// * bfloat16, conv3x3_tc_kernel: warp-level mma.sync.m16n8k16 (bf16 in,
//   f32 accumulators in registers), operands read from shared memory with
//   ldmatrix (.trans for the k-major Wm tile).  A block of 8 warps computes
//   a BM-pixel x BN-channel tile in BK-deep K steps; the tiles (TcTile
//   below) are 128 x 128 x 64 for N > 64, 256 x 64 x 32 or 128 x 64 x 64 for
//   N <= 64, and 128 x 16 x 64 for N <= 16 (the input gradient of conv1_1).
//   The operands arrive through a 3- or 4-stage ring of cp.async copies in
//   dynamic shared memory: 16 bytes per copy (8 channels of one pixel, or 8
//   output channels of one Wm row), the halo zero-filled by the src-size-0
//   form with its address clamped to x; rows are padded by 16 bytes so that
//   ldmatrix is free of bank conflicts.  cp.async.wait_group waits on the
//   calling thread's own copies, then one __syncthreads publishes the stage:
//   no mbarrier, no expected byte count, nothing that can wait forever on a
//   copy that delivers other bytes.  Where C is not a multiple of 8 (conv1_1's
//   forward, C = 3, K = 27 padded to 32) x takes an element-wise gather into
//   the same tile; Wm always takes 16-byte copies, the wrapper padding its
//   rows to a multiple of 8 (N = 3 becomes 8).
// * Filling the card: the deep convs at 32^2..8^2 give 16-128 tiles for 132
//   SMs.  There the 128 x 128 tile runs one block per SM with 190 registers,
//   reading the next 16-deep substep's operands while the products of the
//   last one run, and the wrapper (ops/conv3x3.py::conv3x3_plan) splits K
//   into S slices of whole steps, as many as keep the grid to one block per
//   SM.  Each slice writes f32 partial sums into a workspace (S, M, N) that
//   the wrapper allocates, and conv3x3_splitk_reduce sums the slices in the
//   fixed order s = 0..S-1 (no atomics: every run gives the same bits) and
//   applies the epilogue.  Where the tiles alone fill the card, two blocks
//   share an SM, each at most 128 registers.
// * float32, conv3x3_kernel: CUDA-core FMAs (67 TFLOP/s at most), kept as
//   it was.  The tensor cores would take float32 as TF32 (10-bit mantissa),
//   which breaks the float32 limit of the checks against the plain form.
//
// Next step: wgmma tiles fed by TMA, now that this data path (the gather,
// the split and the epilogue) is settled on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }

// sum -> bf16 output value, in the order of the JAX kernel: round, add the
// bias, round, ReLU
__device__ __forceinline__ bf16 epilogue_bf16(float acc, float bias, int relu) {
  const float rounded = __bfloat162float(__float2bfloat16_rn(acc));
  const float y = __bfloat162float(__float2bfloat16_rn(rounded + bias));
  return __float2bfloat16_rn((relu && y < 0.0f) ? 0.0f : y);
}
__device__ __forceinline__ void store_out(float* p, float acc, float bias, int relu) {
  const float y = acc + bias;
  *p = (relu && y < 0.0f) ? 0.0f : y;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBK = 16;  // depth of one K step (k = tap * C + c)

// One block computes a (BM pixels) x (BN output channels) tile of out.
// Thread t owns rows ty*TM .. ty*TM+TM-1 and columns tx*TN .. tx*TN+TN-1.
template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ wmat, const T* __restrict__ bias,
               T* __restrict__ out, int H, int W, int C, int N, int M, int relu) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one register tile per thread");
  static_assert(BM % (kThreads / kBK) == 0, "A slice loads evenly");
  static_assert((kBK * BN) % kThreads == 0, "B slice loads evenly");
  constexpr int kRowsPerThread = BM / (kThreads / kBK);  // A rows this thread loads
  constexpr int kBPerThread = kBK * BN / kThreads;

  __shared__ __align__(16) float As[kBK][BM + 4];
  __shared__ __align__(16) float Bs[kBK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * C;
  const int HW = H * W;

  // the pixels of the A rows this thread loads: flat index and packed (h, w)
  const int a_k = tid % kBK;
  const int a_row = tid / kBK;
  int pix[kRowsPerThread];
  int hw[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int m = m0 + a_row + i * (kThreads / kBK);
    if (m < M) {
      const int rem = m % HW;
      pix[i] = m;
      hw[i] = ((rem / W) << 16) | (rem % W);
    } else {
      pix[i] = -1;
      hw[i] = 0;
    }
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A slice: consecutive threads take consecutive k, i.e. consecutive
    // channels of one pixel, so the loads of a tap coalesce
    {
      const int k = k0 + a_k;
      int tap = 0, c = 0, dy = 0, dx = 0;
      if (k < K) {
        tap = k / C;
        c = k - tap * C;
        dy = tap / 3 - 1;
        dx = tap % 3 - 1;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        float v = 0.0f;
        if (k < K && pix[i] >= 0) {
          const int ih = (hw[i] >> 16) + dy;
          const int iw = (hw[i] & 0xffff) + dx;
          if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
            const long long off = static_cast<long long>(pix[i] + dy * W + dx) * C + c;
            v = to_f32(x[off]);
          }
        }
        As[a_k][a_row + i * (kThreads / kBK)] = v;
      }
    }
    // B slice: consecutive threads take consecutive output channels
#pragma unroll
    for (int i = 0; i < kBPerThread; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / BN;
      const int nn = e % BN;
      const int k = k0 + kk;
      const int n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N) ? to_f32(wmat[static_cast<long long>(k) * N + n]) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    T* row = out + static_cast<long long>(m) * N;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) store_out(row + n, acc[i][j], to_f32(bias[n]), relu);
    }
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_f32(const void* x, const void* wmat, const void* bias, void* out, int B,
                       int H, int W, int C, int N, int relu, cudaStream_t stream) {
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  conv3x3_kernel<float, BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wmat),
      static_cast<const float*>(bias), static_cast<float*>(out), H, W, C, N, M, relu);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* x, const void* wmat, const void* bias, void* out, int B,
                         int H, int W, int C, int N, int relu, cudaStream_t stream) {
  // tile width follows N: the input gradient of conv1_1 has N = 3
  if (N <= 16) return launch_f32<256, 16, 4, 4>(x, wmat, bias, out, B, H, W, C, N, relu, stream);
  if (N <= 64) return launch_f32<128, 64, 8, 4>(x, wmat, bias, out, B, H, W, C, N, relu, stream);
  return launch_f32<128, 128, 8, 8>(x, wmat, bias, out, B, H, W, C, N, relu, stream);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync fed by a cp.async ring)
// ---------------------------------------------------------------------------

constexpr int kPad = 8;  // bf16 of padding per shared-memory row (16 bytes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false nothing is read and the 16
// bytes are zero-filled (src-size 0), from an address the caller clamps to
// a valid one
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_, int STAGES_, int MIN_BLOCKS_,
          bool DB_ = false>
struct TcTile {
  static constexpr bool DB = DB_;
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  static constexpr int kWarpM = BM / WARPS_M, kWarpN = BN / WARPS_N;
  static constexpr int kMI = kWarpM / 16, kNI = kWarpN / 8;  // mma tiles per warp
  static constexpr int kAStride = BK + kPad;  // bf16 per A row (one pixel's K step)
  static constexpr int kBStride = BN + kPad;  // bf16 per B row (one k)
  static constexpr int kAStage = BM * kAStride, kBStage = BK * kBStride;
  static constexpr int kSmemBytes = STAGES * (kAStage + kBStage) * 2;
  static constexpr int kARowChunks = BK / 8;                 // 16-byte chunks per A row
  static constexpr int kARowsPerPass = kThreads / kARowChunks;
  static constexpr int kAChunks = BM / kARowsPerPass;        // A chunks per thread
  static constexpr int kBRowChunks = BN / 8;
  static_assert(kWarpM % 16 == 0 && kWarpN % 16 == 0, "whole ldmatrix x4 tiles");
  static_assert(BK % 16 == 0 && BM % kARowsPerPass == 0, "A chunks load evenly");
};

// tile code 1..: (BM, BN, BK, warps along M, along N, ring stages, blocks
// per SM, operands of the next substep read while the products run)
using Tile1 = TcTile<128, 128, 64, 2, 4, 3, 2>;        // warp tile 64 x 32
using Tile2 = TcTile<128, 128, 64, 2, 4, 3, 1, true>;  // warp tile 64 x 32
using Tile3 = TcTile<256, 64, 32, 4, 2, 4, 2>;         // warp tile 64 x 32
using Tile4 = TcTile<128, 64, 64, 4, 2, 3, 2>;         // warp tile 32 x 32
using Tile5 = TcTile<128, 16, 64, 8, 1, 3, 2>;         // warp tile 16 x 16

// One block computes a BM x BN tile of out (or of slice blockIdx.z's
// partial sums) over the K steps of its slice.  Wm arrives with a row
// stride ldw, a multiple of 8 (the wrapper pads N up to it), in 16-byte
// copies; x in 16-byte copies of 8 channels when vec_a (C a multiple of 8,
// x 16-byte aligned), else element by element.
template <class T>
__global__ void __launch_bounds__(T::kThreads, T::MIN_BLOCKS)
conv3x3_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wmat,
                  const bf16* __restrict__ bias, bf16* __restrict__ out,
                  float* __restrict__ ws, int H, int W, int C, int N, int ldw, int M, int relu,
                  int vec_a) {
  constexpr int BK = T::BK;
  constexpr int STAGES = T::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const As = reinterpret_cast<bf16*>(smem_raw);
  bf16* const Bs = As + STAGES * T::kAStage;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / T::WARPS_N;
  const int wn = warp % T::WARPS_N;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int K = 9 * C;
  const int HW = H * W;
  const int ksteps = (K + BK - 1) / BK;
  const int kt0 = static_cast<int>(static_cast<long long>(blockIdx.z) * ksteps / gridDim.z);
  const int kt1 = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * ksteps / gridDim.z);
  const int nsteps = kt1 - kt0;

  // 16-byte A chunks of this thread: column chunk a_kc (8 channels) of rows
  // a_row0 + i * kARowsPerPass; their pixels and (h, w)
  const int a_kc = tid % T::kARowChunks;
  const int a_row0 = tid / T::kARowChunks;
  int a_m[T::kAChunks], a_h[T::kAChunks], a_w[T::kAChunks];
#pragma unroll
  for (int i = 0; i < T::kAChunks; ++i) {
    const int m = m0 + a_row0 + i * T::kARowsPerPass;
    a_m[i] = m;
    const int rem = (m < M) ? m % HW : 0;
    a_h[i] = rem / W;
    a_w[i] = rem - a_h[i] * W;
  }
  // (tap, channel) of this thread's A chunk at the next step to load; the
  // steps load in order, so it advances by BK channels per step
  int a_tap, a_c;
  {
    const int k = kt0 * BK + a_kc * 8;
    a_tap = k / C;
    a_c = k - a_tap * C;
  }

  auto load_stage = [&](int stage, int kt) {
    bf16* as = As + stage * T::kAStage;
    bf16* bs = Bs + stage * T::kBStage;
    const int kbase = kt * BK;
    if (vec_a) {
      // the 8 channels of the chunk lie in one tap (C % 8 == 0)
      const int dy = a_tap >= 6 ? 1 : (a_tap >= 3 ? 0 : -1);
      const int dx = a_tap - 3 * (dy + 1) - 1;
      const bool in_k = a_tap < 9;
#pragma unroll
      for (int i = 0; i < T::kAChunks; ++i) {
        const int ih = a_h[i] + dy;
        const int iw = a_w[i] + dx;
        const bool ok = in_k && a_m[i] < M && ih >= 0 && ih < H && iw >= 0 && iw < W;
        const bf16* src =
            ok ? x + static_cast<long long>(a_m[i] + dy * W + dx) * C + a_c : x;
        cp_async16(smem_u32(as + (a_row0 + i * T::kARowsPerPass) * T::kAStride + a_kc * 8), src,
                   ok);
      }
      a_c += BK;
      while (a_c >= C) {
        a_c -= C;
        ++a_tap;
      }
    } else {
      // element by element: this thread takes column kk of every
      // (kThreads / BK)-th row
      const int kk = tid % BK;
      const int k = kbase + kk;
      const int tap = k / C;
      const int c = k - tap * C;
      const int dy = tap / 3 - 1;
      const int dx = tap - (tap / 3) * 3 - 1;
      for (int row = tid / BK; row < T::BM; row += T::kThreads / BK) {
        const int m = m0 + row;
        bf16 v = __float2bfloat16_rn(0.0f);
        if (k < K && m < M) {
          const int rem = m % HW;
          const int ih = rem / W + dy;
          const int iw = rem % W + dx;
          if (ih >= 0 && ih < H && iw >= 0 && iw < W)
            v = x[static_cast<long long>(m + dy * W + dx) * C + c];
        }
        as[row * T::kAStride + kk] = v;
      }
    }
    for (int e = tid; e < BK * T::kBRowChunks; e += T::kThreads) {
      const int kr = e / T::kBRowChunks;
      const int nc = e % T::kBRowChunks;
      const int k = kbase + kr;
      const int n = n0 + nc * 8;
      const bool ok = k < K && n < ldw;  // ldw % 8 == 0: the chunk is whole
      const bf16* src = ok ? wmat + static_cast<long long>(k) * ldw + n : wmat;
      cp_async16(smem_u32(bs + kr * T::kBStride + nc * 8), src, ok);
    }
  };

  float acc[T::kMI][T::kNI][4];
#pragma unroll
  for (int i = 0; i < T::kMI; ++i)
#pragma unroll
    for (int j = 0; j < T::kNI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  // the ring: steps 0 .. STAGES-2 in flight before the first product; one
  // commit group per step (empty past the slice's end, so the count of
  // groups per iteration stays fixed)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_stage(s, kt0 + s);
    cp_async_commit();
  }

  // operands of one 16-deep substep of a stage, into registers
  auto load_frags = [&](uint32_t (&a)[T::kMI][4], uint32_t (&b)[T::kNI][2], int stage, int kk) {
    const bf16* as = As + stage * T::kAStage;
    const bf16* bs = Bs + stage * T::kBStage;
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi) {
      const int row = wm * T::kWarpM + mi * 16 + (lane & 15);
      ldmatrix_x4(a[mi], smem_u32(as + row * T::kAStride + kk + (lane >> 4) * 8));
    }
#pragma unroll
    for (int nj = 0; nj < T::kNI / 2; ++nj) {
      const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int col = wn * T::kWarpN + nj * 16 + (lane >> 4) * 8;
      uint32_t r[4];
      ldmatrix_x4_trans(r, smem_u32(bs + krow * T::kBStride + col));
      b[2 * nj][0] = r[0];
      b[2 * nj][1] = r[1];
      b[2 * nj + 1][0] = r[2];
      b[2 * nj + 1][1] = r[3];
    }
  };
  auto mma_all = [&](const uint32_t (&a)[T::kMI][4], const uint32_t (&b)[T::kNI][2]) {
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::kNI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  };

  if constexpr (!T::DB) {
    for (int i = 0; i < nsteps; ++i) {
      // this thread's copies of step i have landed; the barrier makes every
      // thread's visible and frees the stage that step i-1 read
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int next = i + STAGES - 1;
      if (next < nsteps) load_stage(next % STAGES, kt0 + next);
      cp_async_commit();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[T::kMI][4];
        uint32_t b[T::kNI][2];
        load_frags(a, b, i % STAGES, kk);
        mma_all(a, b);
      }
    }
  } else {
    // the operands of each substep are read while the products of the one
    // before run; the barrier comes before the last substep of a step, so
    // that its products overlap the wait and the next step's first reads
    constexpr int KS = BK / 16;
    uint32_t a[2][T::kMI][4];
    uint32_t b[2][T::kNI][2];
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    int read_stage = 0;
    int write_step = STAGES - 1;
    load_frags(a[0], b[0], 0, 0);
    for (int i = 0; i < nsteps; ++i) {
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s == KS - 1) {
          // step i+1 has landed; every warp has read step i-1's stage
          cp_async_wait<STAGES - 2>();
          __syncthreads();
          read_stage = (read_stage + 1) % STAGES;
        }
        load_frags(a[(s + 1) & 1], b[(s + 1) & 1], read_stage, ((s + 1) % KS) * 16);
        if (s == 0) {
          // the stage of step i-1, free since the barrier of step i-1
          if (write_step < nsteps) load_stage(write_step % STAGES, kt0 + write_step);
          cp_async_commit();
          ++write_step;
        }
        mma_all(a[s & 1], b[s & 1]);
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (mi, ni, r) holds row g (+8 for r >= 2), columns 2t, 2t+1
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < T::kMI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * T::kWarpM + mi * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < T::kNI; ++ni) {
        const int n = n0 + wn * T::kWarpN + ni * 8 + 2 * t;
        if (n >= N) continue;
        const float v0 = acc[mi][ni][2 * half];
        const float v1 = acc[mi][ni][2 * half + 1];
        if (ws != nullptr) {
          float* p = ws + (static_cast<long long>(blockIdx.z) * M + m) * N + n;
          if (pairs) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (n + 1 < N) p[1] = v1;
          }
        } else {
          bf16* p = out + static_cast<long long>(m) * N + n;
          const bf16 y0 = epilogue_bf16(v0, __bfloat162float(bias[n]), relu);
          if (pairs) {
            const bf16 y1 = epilogue_bf16(v1, __bfloat162float(bias[n + 1]), relu);
            *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(y0, y1);
          } else {
            p[0] = y0;
            if (n + 1 < N) p[1] = epilogue_bf16(v1, __bfloat162float(bias[n + 1]), relu);
          }
        }
      }
    }
  }
}

// out[i] = epilogue(sum over s = 0..S-1, in that order, of ws[s, i]); four
// consecutive elements per thread
__global__ void __launch_bounds__(kThreads)
conv3x3_splitk_reduce(const float* __restrict__ ws, const bf16* __restrict__ bias,
                      bf16* __restrict__ out, long long MN, int N, int S, int relu) {
  const long long i = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i >= MN) return;
  if ((N & 3) == 0) {  // MN % 4 == 0 and the four share one row
    float4 sum = *reinterpret_cast<const float4*>(ws + i);
    for (int s = 1; s < S; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(ws + s * MN + i);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int n = static_cast<int>(i % N);
    out[i] = epilogue_bf16(sum.x, __bfloat162float(bias[n]), relu);
    out[i + 1] = epilogue_bf16(sum.y, __bfloat162float(bias[n + 1]), relu);
    out[i + 2] = epilogue_bf16(sum.z, __bfloat162float(bias[n + 2]), relu);
    out[i + 3] = epilogue_bf16(sum.w, __bfloat162float(bias[n + 3]), relu);
  } else {
    for (long long j = i; j < i + 4 && j < MN; ++j) {
      float sum = ws[j];
      for (int s = 1; s < S; ++s) sum += ws[s * MN + j];
      out[j] = epilogue_bf16(sum, __bfloat162float(bias[j % N]), relu);
    }
  }
}

template <class T>
cudaError_t launch_tc(const void* x, const void* wmat, const void* bias, void* out, float* ws,
                      int B, int H, int W, int C, int N, int ldw, int relu, int splits,
                      int reduce, cudaStream_t stream) {
  const int M = B * H * W;
  const int ksteps = (9 * C + T::BK - 1) / T::BK;
  if (splits < 1 || splits > ksteps || splits > 65535) return cudaErrorInvalidValue;
  if (ws == nullptr && splits != 1) return cudaErrorInvalidValue;
  if (ldw < N || ldw % 8 != 0 || reinterpret_cast<uintptr_t>(wmat) % 16 != 0)
    return cudaErrorInvalidValue;
  const int vec_a = (C % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const dim3 grid((M + T::BM - 1) / T::BM, (N + T::BN - 1) / T::BN, splits);
  conv3x3_tc_kernel<T><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wmat),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), ws, H, W, C, N, ldw, M, relu,
      vec_a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr || !reduce) return err;
  const long long MN = static_cast<long long>(M) * N;
  const long long blocks = (MN + 4LL * kThreads - 1) / (4LL * kThreads);
  conv3x3_splitk_reduce<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      ws, static_cast<const bf16*>(bias), static_cast<bf16*>(out), MN, N, splits, relu);
  return cudaGetLastError();
}

template <class T>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(conv3x3_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              T::kSmemBytes);
}

}  // namespace

// C interface, loaded with ctypes by swapnet_tpu_torch/ops/conv3x3.py.

// Opt every tensor-core instantiation in to its dynamic shared memory (above
// 48 KB for the wider tiles) on ``device``.  Called once per device when the
// library is loaded, before any launch (and so never first inside a CUDA-graph
// capture).  Returns the first CUDA error, 0 on success.
extern "C" int conv3x3_init(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = allow_smem<Tile1>();
  if (err == cudaSuccess) err = allow_smem<Tile2>();
  if (err == cudaSuccess) err = allow_smem<Tile3>();
  if (err == cudaSuccess) err = allow_smem<Tile4>();
  if (err == cudaSuccess) err = allow_smem<Tile5>();
  return static_cast<int>(err);
}

// x (B, H, W, C), bias (N,) and out (B, H, W, N) are contiguous device
// pointers of one type (float32, or bfloat16 when is_bf16), and so is wmat,
// (9C, ldw): N columns of weights, then zeros up to its row stride ldw
// (ldw == N for float32; for bfloat16 a multiple of 8, 16-byte aligned).
// The wrapper has checked shapes, types and contiguity.  ``tile`` is the
// plan's form: 0 the CUDA-core kernel (float32 only), 1.. the tensor-core
// kernel with the tile of that number (bfloat16 only).  ``splits`` is the
// number of K slices.  With ``ws`` null the tensor-core kernel writes out
// directly (splits must be 1); otherwise each slice writes its float32
// partial sums into ws (splits, M, N) and, when ``reduce``,
// conv3x3_splitk_reduce sums them into out.  Launches on ``stream`` and
// allocates nothing.  ``device`` is the CUDA ordinal that owns the pointers
// and the stream.  Returns cudaGetLastError() after each launch (0 when
// every launch was accepted).
extern "C" int conv3x3_forward(const void* x, const void* wmat, const void* bias, void* out,
                               void* ws, int is_bf16, int B, int H, int W, int C, int N,
                               int ldw, int relu, int tile, int splits, int reduce, int device,
                               void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (B == 0 || H == 0 || W == 0 || N == 0) return 0;
  if (W >= (1 << 16) || H >= (1 << 15) || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  cudaError_t err = cudaErrorInvalidValue;
#define CONV3X3_TILE(code, T)                                                             \
  else if (tile == code) err =                                                            \
      launch_tc<T>(x, wmat, bias, out, w, B, H, W, C, N, ldw, relu, splits, reduce, s);
  if (!is_bf16) {
    if (tile == 0 && splits == 1 && ws == nullptr && ldw == N)
      err = dispatch_f32(x, wmat, bias, out, B, H, W, C, N, relu, s);
  }
  CONV3X3_TILE(1, Tile1)
  CONV3X3_TILE(2, Tile2)
  CONV3X3_TILE(3, Tile3)
  CONV3X3_TILE(4, Tile4)
  CONV3X3_TILE(5, Tile5)
#undef CONV3X3_TILE
  return static_cast<int>(err);
}
