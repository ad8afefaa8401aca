// Fused sparse-mask upsample + shift + blend + preprocess for STRise, for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel fused_mask_blend_preprocess
// (xfr_tpu/blackbox/pallas_blend.py, _blend_kernel with _interp_matrix).
// For each mask n, row i, column j and channel c:
//
//   m            = bilinear sample of grid[n] (gh x gw) at (i + shift_r,
//                  j + shift_c) of its (H + s) x (W + s) upsample, with
//                  half-pixel centres and clamped edges
//   out[n,c,i,j] = m * probe[i,j,c] + (1 - m) * fill[i,j,c] - mean[c]
//
// The [N,H,W] float masks never reach device memory.
//
// Bound: bytes.  At the scorer's shapes (N=64, 224x224, 3 channels) the
// kernel writes 38.5 MB and reads 1.3 MB (grids, shifts, probe, fill),
// about 12 us at 3.35 TB/s; it does ~20 flops per output value.
//
// Design.  The TPU kernel builds the interpolation matrices R[H,gh] and
// C[W,gw] and runs two matmuls on the MXU.  Each row of R and C has at
// most two non-zero taps, so here each output pixel is a 2x2 bilinear
// read of the grid: one block per (mask, band of rows) stages the grid in
// shared memory (19 x 19 floats = 1.4 KB), each thread computes its row
// and column source coordinates in f32 exactly as _interp_matrix does,
// blends the 3 channels and stores along W, so neighbouring threads write
// neighbouring addresses.  Probe and fill (602 KB each, HWC) stay
// resident in L2 across the blocks.  Arithmetic uses round-to-nearest
// intrinsics so that no multiply-add is contracted: the result then
// matches the plain PyTorch version (F.interpolate, then the blend) to
// rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 8;
constexpr int kMaxGridCells = 64 * 64;

// Source coordinate, its lower tap and the upper tap's weight for output
// index `o` (already shifted) of an upsample from n_in samples.
__device__ __forceinline__ void source_taps(int o, float scale, int n_in,
                                            int* lo, int* hi, float* w_hi) {
  float src = __fsub_rn(__fmul_rn(__fadd_rn((float)o, 0.5f), scale), 0.5f);
  src = fminf(fmaxf(src, 0.0f), (float)(n_in - 1));
  int l = (int)floorf(src);
  *lo = l;
  *hi = l < n_in - 1 ? l + 1 : l;
  *w_hi = __fsub_rn(src, (float)l);
}

__global__ void __launch_bounds__(kThreads)
fused_blend_kernel(const float* __restrict__ grids,
                   const int* __restrict__ shifts,
                   const float* __restrict__ probe,
                   const float* __restrict__ fill,
                   const float* __restrict__ mean,
                   float* __restrict__ out,
                   int gh, int gw, int H, int W,
                   float scale_h, float scale_w) {
  __shared__ float g[kMaxGridCells];
  const int n = blockIdx.y;
  const int cells = gh * gw;
  const float* grid = grids + (size_t)n * cells;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) g[k] = grid[k];
  __syncthreads();

  const int sr = shifts[2 * n];
  const int sc = shifts[2 * n + 1];
  const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, H - row0);
  const size_t plane = (size_t)H * W;
  float* out_n = out + (size_t)n * 3 * plane;

  for (int p = threadIdx.x; p < rows * W; p += blockDim.x) {
    const int i = row0 + p / W;
    const int j = p - (p / W) * W;
    int r0, r1, c0, c1;
    float wr1, wc1;
    source_taps(i + sr, scale_h, gh, &r0, &r1, &wr1);
    source_taps(j + sc, scale_w, gw, &c0, &c1, &wc1);
    const float wr0 = __fsub_rn(1.0f, wr1);
    const float wc0 = __fsub_rn(1.0f, wc1);
    // F.interpolate's order: rows outside, columns inside
    const float top = __fadd_rn(__fmul_rn(wc0, g[r0 * gw + c0]),
                                __fmul_rn(wc1, g[r0 * gw + c1]));
    const float bot = __fadd_rn(__fmul_rn(wc0, g[r1 * gw + c0]),
                                __fmul_rn(wc1, g[r1 * gw + c1]));
    const float m = __fadd_rn(__fmul_rn(wr0, top), __fmul_rn(wr1, bot));
    const float inv = __fsub_rn(1.0f, m);

    const size_t px = (size_t)i * W + j;
    const float* pp = probe + 3 * px;
    const float* fp = fill + 3 * px;
    const float b0 = __fadd_rn(__fmul_rn(m, pp[0]), __fmul_rn(inv, fp[0]));
    const float b1 = __fadd_rn(__fmul_rn(m, pp[1]), __fmul_rn(inv, fp[1]));
    const float b2 = __fadd_rn(__fmul_rn(m, pp[2]), __fmul_rn(inv, fp[2]));
    out_n[px] = __fsub_rn(b0, m0);
    out_n[plane + px] = __fsub_rn(b1, m1);
    out_n[2 * plane + px] = __fsub_rn(b2, m2);
  }
}

}  // namespace

// Plain C entry, bound with ctypes.  All pointers are device pointers of
// contiguous tensors: grids f32 [n,gh,gw], shifts i32 [n,2], probe and
// fill f32 [H,W,3], mean f32 [3], out f32 [n,3,H,W].  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_mask_blend_preprocess_f32(
    const float* grids, const int* shifts, const float* probe,
    const float* fill, const float* mean, float* out, int n, int gh, int gw,
    int H, int W, float scale_h, float scale_w, void* stream) {
  if (n <= 0) return 0;
  if (gh * gw > kMaxGridCells) return (int)cudaErrorInvalidValue;
  dim3 grid((H + kRowsPerBlock - 1) / kRowsPerBlock, n);
  fused_blend_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      grids, shifts, probe, fill, mean, out, gh, gw, H, W, scale_h,
      scale_w);
  return (int)cudaGetLastError();
}
