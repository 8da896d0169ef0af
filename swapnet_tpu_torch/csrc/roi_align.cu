// ROI-Align forward for Hopper (sm_90a): torchvision semantics with
// aligned=False and sampling_ratio=1, as the texture stage uses it.
//
// Replaces swapnet_tpu/ops/pallas_kernels.py::roi_align_pallas (the Pallas
// TPU kernel, which builds the separable bilinear weight matrices Wy and Wx
// in VMEM and runs Wy . img . Wx^T on the MXU).  On the GPU the natural form
// is the direct 4-corner gather of swapnet_tpu/ops/roi_align.py::
// roi_align_reference, with the validity, clamp and edge rules of
// _axis_weights: a sample outside [-1, size] counts for nothing, a sample is
// clamped to [0, size-1], and at the last pixel both taps collapse onto it.
//
// Layout: features NCHW (B, C, H, W), rois (B, R, 4) float32 [x1, y1, x2, y2],
// output (B, R, C, oh, ow), which TextureModule views as (B, R*C, oh, ow).
// One thread computes one (b, r, i, j) and loops over the C channels; the
// sum is kept in float32 and written in the features' type (float32 or
// bfloat16).  Neighbouring threads write neighbouring j, so stores coalesce.
//
// Bound on an H100: at B=1, 128^2, C=3, R=12 in bfloat16 the function reads
// 98 KB of features and writes 1.18 MB, about 1.3 MB in all: well under a
// microsecond at 3.35 TB/s, so the launch itself dominates.  The simple
// gather is right first; making it fast (fusing it into the next conv, or
// keeping the image in shared memory) is later work.
//
// The arithmetic avoids FMA contraction where the plain PyTorch version
// (swapnet_tpu_torch/ops/roi_align.py::roi_align_plain) rounds twice, so the
// sample positions agree bit for bit with it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The two taps of one axis and their weights; both weights are 0 when the
// sample lies outside [-1, size].
struct Taps {
  int low, high;
  float w_low, w_high;
};

__device__ __forceinline__ Taps axis_taps(float start, float bin, int idx, int size) {
  float pos = __fadd_rn(start, __fmul_rn(static_cast<float>(idx) + 0.5f, bin));
  Taps t{0, 0, 0.0f, 0.0f};
  if (pos < -1.0f || pos > static_cast<float>(size)) return t;
  pos = fmaxf(pos, 0.0f);
  const float low = floorf(pos);
  if (low >= static_cast<float>(size - 1)) {
    t.low = t.high = size - 1;
    t.w_low = 1.0f;
    return t;
  }
  t.low = static_cast<int>(low);
  t.high = t.low + 1;
  const float frac = __fsub_rn(pos, low);
  t.w_low = __fsub_rn(1.0f, frac);
  t.w_high = frac;
  return t;
}

template <typename T>
__global__ void roi_align_kernel(const T* __restrict__ feats, const float* __restrict__ rois,
                                 T* __restrict__ out, int R, int C, int H, int W, int oh,
                                 int ow, float spatial_scale, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = static_cast<int>(idx % ow);
  long long rest = idx / ow;
  const int i = static_cast<int>(rest % oh);
  rest /= oh;
  const int r = static_cast<int>(rest % R);
  const long long b = rest / R;

  const float* roi = rois + (b * R + r) * 4;
  const float x1 = __fmul_rn(__ldg(roi + 0), spatial_scale);
  const float y1 = __fmul_rn(__ldg(roi + 1), spatial_scale);
  const float x2 = __fmul_rn(__ldg(roi + 2), spatial_scale);
  const float y2 = __fmul_rn(__ldg(roi + 3), spatial_scale);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1.0f), static_cast<float>(ow));
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1.0f), static_cast<float>(oh));
  const Taps ty = axis_taps(y1, bin_h, i, H);
  const Taps tx = axis_taps(x1, bin_w, j, W);

  const long long plane = static_cast<long long>(H) * W;
  const long long out_plane = static_cast<long long>(oh) * ow;
  const T* img = feats + b * C * plane;
  T* o = out + (b * R + r) * C * out_plane + static_cast<long long>(i) * ow + j;
  const int o00 = ty.low * W + tx.low, o01 = ty.low * W + tx.high;
  const int o10 = ty.high * W + tx.low, o11 = ty.high * W + tx.high;
  for (int c = 0; c < C; ++c) {
    const T* p = img + c * plane;
    const float top = tx.w_low * load_f32(p + o00) + tx.w_high * load_f32(p + o01);
    const float bottom = tx.w_low * load_f32(p + o10) + tx.w_high * load_f32(p + o11);
    store_as(o + c * out_plane, ty.w_low * top + ty.w_high * bottom);
  }
}

}  // namespace

// C interface, loaded with ctypes by swapnet_tpu_torch/ops/roi_align.py.
// feats, rois and out are device pointers; the wrapper has checked shapes,
// types and contiguity.  Launches on ``stream`` and allocates nothing.
// ``device`` is the CUDA ordinal that owns the pointers and the stream.
// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int roi_align_forward(const void* feats, const void* rois, void* out, int is_bf16,
                                 int B, int C, int H, int W, int R, int oh, int ow,
                                 float spatial_scale, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long total = static_cast<long long>(B) * R * oh * ow;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = static_cast<unsigned int>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  if (is_bf16) {
    roi_align_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats), r, static_cast<__nv_bfloat16*>(out), R, C, H,
        W, oh, ow, spatial_scale, total);
  } else {
    roi_align_kernel<float><<<blocks, threads, 0, s>>>(static_cast<const float*>(feats), r,
                                                       static_cast<float*>(out), R, C, H, W, oh,
                                                       ow, spatial_scale, total);
  }
  return static_cast<int>(cudaGetLastError());
}
