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
// matrix is never written: each block gathers its (BM x BK) slice of A
// straight from x into shared memory, zero-filling the halo, and its
// (BK x BN) slice of Wm beside it; 256 threads then each accumulate a
// (TM x TN) register tile in float32 with FMAs.
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
// Bound on an H100: the VGG convs are compute bound (2*9*C*N operations per
// output pixel against 2*(C + N) bytes in bf16; at C = N = 64 that is 288
// operations per byte, at the tensor-core ridge of ~295, and above it for
// every wider conv).  This kernel runs on the CUDA cores (67 TFLOP/s of
// float32 FMA at most), not the tensor cores (989 TFLOP/s in bf16): it is
// the simple, right first form.  wgmma tiles fed by TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // depth of one K step (k = tap * C + c)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// sum -> output value, in the order of the JAX kernel: (round,) add the
// bias, ReLU
__device__ __forceinline__ void store_out(float* p, float acc, float bias, int relu) {
  const float y = acc + bias;
  *p = (relu && y < 0.0f) ? 0.0f : y;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float acc, float bias, int relu) {
  const float rounded = __bfloat162float(__float2bfloat16_rn(acc));
  const float y = __bfloat162float(__float2bfloat16_rn(rounded + bias));
  *p = __float2bfloat16_rn((relu && y < 0.0f) ? 0.0f : y);
}

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

template <typename T, int BM, int BN, int TM, int TN>
cudaError_t launch(const void* x, const void* wmat, const void* bias, void* out, int B, int H,
                   int W, int C, int N, int relu, cudaStream_t stream) {
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  conv3x3_kernel<T, BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wmat), static_cast<const T*>(bias),
      static_cast<T*>(out), H, W, C, N, M, relu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* wmat, const void* bias, void* out, int B, int H,
                     int W, int C, int N, int relu, cudaStream_t stream) {
  // tile width follows N: the input gradient of conv1_1 has N = 3
  if (N <= 16) return launch<T, 256, 16, 4, 4>(x, wmat, bias, out, B, H, W, C, N, relu, stream);
  if (N <= 64) return launch<T, 128, 64, 8, 4>(x, wmat, bias, out, B, H, W, C, N, relu, stream);
  return launch<T, 128, 128, 8, 8>(x, wmat, bias, out, B, H, W, C, N, relu, stream);
}

}  // namespace

// C interface, loaded with ctypes by swapnet_tpu_torch/ops/conv3x3.py.
// x (B, H, W, C), wmat (9C, N), bias (N,) and out (B, H, W, N) are
// contiguous device pointers of one type (float32, or bfloat16 when
// is_bf16); the wrapper has checked shapes, types and contiguity.  Launches
// on ``stream`` and allocates nothing.  ``device`` is the CUDA ordinal that
// owns the pointers and the stream.  Returns cudaGetLastError() after the
// launch (0 when it was accepted).
extern "C" int conv3x3_forward(const void* x, const void* wmat, const void* bias, void* out,
                               int is_bf16, int B, int H, int W, int C, int N, int relu,
                               int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (B == 0 || H == 0 || W == 0 || N == 0) return 0;
  if (W >= (1 << 16) || H >= (1 << 15)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(x, wmat, bias, out, B, H, W, C, N, relu, s)
              : dispatch<float>(x, wmat, bias, out, B, H, W, C, N, relu, s);
  return static_cast<int>(err);
}
