// Fused elementwise epilogue of a convolution's output, for Hopper
// (sm_90a): conv bias, inference BatchNorm, squeeze-excite gate, residual
// add and ReLU in one read and one write of the activation.
//
// Replaces no TPU kernel: in xfr_tpu XLA fuses this chain into the
// convolution's consumers for free.  Eager PyTorch runs it as up to eight
// passes (the bias add; BatchNorm kept unfolded as (x - mean) /
// sqrt(var + eps) * gamma + beta, so that EBP can ReLU gamma alone; the
// gate multiply; the residual add; the ReLU), each reading and writing the
// whole activation.  For each element (n, c, position) and each stage the
// chain holds, in this order:
//
//   v = y + b[c]
//   v = v - mean[c];  v = v / sqrt(var[c] + eps);  v = v * gamma[c];
//   v = v + beta[c]
//   v = gate[n, c] * v
//   v = v + r
//   v = v != v ? v : max(v, 0)          (torch.maximum's NaN rule)
//
// Every stage is one correctly rounded operation (__fadd_rn, __fsub_rn,
// __fdiv_rn, __fmul_rn, __fsqrt_rn), so nothing is contracted into a
// multiply-add: the result equals the eager chain's bit for bit.
//
// Bound: bytes.  At ResNet-101's shapes a chain reads 4 bytes an element
// (8 with a residual) and writes 4, about 14 flops; the H100's 3.35 TB/s
// is the limit.  Design: 16-byte loads and stores, and each channel's
// parameters (and its sqrt(var + eps)) read once by the thread that owns
// the channel, never per element.
//   * NCHW planes (HW % 4 == 0): a group of threads per run of one
//     (n, c) plane, float4 along the plane: a block a plane segment for
//     planes of 512 vectors and more (56x56, 112x112), a warp a plane
//     below (28x28, 14x14).  7x7 planes, which 4 does not divide, go
//     through the same kernel a float at a time.
//   * channels_last (C % 4 == 0): each thread owns four consecutive
//     channels and walks positions, two loads in flight; neighbouring
//     threads hold neighbouring channel vectors, so a warp reads
//     contiguous memory.  The grid is what the card holds at once, so a
//     thread reads its channels' parameters once for many positions.
//   * Anything else (unaligned pointers, C % 4 != 0 in channels_last): a
//     flat loop, a float at a time.
// The kernel runs on the caller's stream, allocates nothing and never
// synchronizes, so it can be captured in a CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int kBias = 1, kBN = 2, kGate = 4, kRes = 8, kRelu = 16;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

struct Args {
  const float* x;
  const float* bias;
  const float* mean;
  const float* var;
  const float* gamma;
  const float* beta;
  const float* gate;  // [N, C], element (n, c) at n * C + c
  const float* res;   // the layout of x
  float* out;         // the layout of x
  float eps;
  int N, C, HW, flags;
};

// One channel's parameters, read once by the thread that owns it.
struct Chan {
  float b, mean, sd, gamma, beta;
};

__device__ __forceinline__ Chan load_chan(const Args& a, int c) {
  Chan p{0.0f, 0.0f, 1.0f, 1.0f, 0.0f};
  if (a.flags & kBias) p.b = __ldg(a.bias + c);
  if (a.flags & kBN) {
    p.mean = __ldg(a.mean + c);
    // torch.sqrt(var + eps): both in float32, each rounded
    p.sd = __fsqrt_rn(__fadd_rn(__ldg(a.var + c), a.eps));
    p.gamma = __ldg(a.gamma + c);
    p.beta = __ldg(a.beta + c);
  }
  return p;
}

__device__ __forceinline__ float apply(float v, const Chan& p, float g,
                                       float r, int flags) {
  if (flags & kBias) v = __fadd_rn(v, p.b);
  if (flags & kBN) {
    v = __fsub_rn(v, p.mean);
    v = __fdiv_rn(v, p.sd);
    v = __fmul_rn(v, p.gamma);
    v = __fadd_rn(v, p.beta);
  }
  if (flags & kGate) v = __fmul_rn(g, v);
  if (flags & kRes) v = __fadd_rn(v, r);
  if (flags & kRelu) v = v != v ? v : fmaxf(v, 0.0f);
  return v;
}

__device__ __forceinline__ float4 apply4(float4 v, const Chan* p, float4 g,
                                         float4 r, int flags) {
  v.x = apply(v.x, p[0], g.x, r.x, flags);
  v.y = apply(v.y, p[1], g.y, r.y, flags);
  v.z = apply(v.z, p[2], g.z, r.z, flags);
  v.w = apply(v.w, p[3], g.w, r.w, flags);
  return v;
}

// NCHW: a group of G threads a segment of one (n, c) plane, V floats a
// load (V == 4 needs HW % 4 == 0 and 16-byte aligned pointers).
template <int V, int G>
__global__ void __launch_bounds__(kThreads)
epilogue_nchw(Args a, int segs, int seg_len, long long groups) {
  const long long grp =
      (long long)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (grp >= groups) return;
  const int lane = threadIdx.x % G;
  const long long plane = grp / segs;
  const int seg = (int)(grp - plane * segs);
  const int c = (int)(plane % a.C);
  const Chan p = load_chan(a, c);
  const float g = (a.flags & kGate) ? __ldg(a.gate + plane) : 0.0f;
  const long long base = plane * a.HW;
  const int start = seg * seg_len;
  const int end = min(a.HW, start + seg_len);
  for (int j = start + lane * V; j < end; j += G * V) {
    const long long i = base + j;
    if constexpr (V == 4) {
      const Chan p4[4] = {p, p, p, p};
      const float4 x = *reinterpret_cast<const float4*>(a.x + i);
      const float4 r = (a.flags & kRes)
                           ? *reinterpret_cast<const float4*>(a.res + i)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(a.out + i) =
          apply4(x, p4, make_float4(g, g, g, g), r, a.flags);
    } else {
      const float r = (a.flags & kRes) ? a.res[i] : 0.0f;
      a.out[i] = apply(a.x[i], p, g, r, a.flags);
    }
  }
}

// channels_last: each thread owns the four channels c .. c + 3 and walks
// the positions (n, h, w), two a step so that two loads are in flight;
// ``per`` positions a block a step.
__global__ void __launch_bounds__(kThreads)
epilogue_nhwc4(Args a, int cv, int per, long long P) {
  int cvec;
  long long pos;
  if (cv <= kThreads) {
    if (threadIdx.x >= per * cv) return;
    cvec = threadIdx.x % cv;
    pos = (long long)blockIdx.x * per + threadIdx.x / cv;
  } else {
    cvec = blockIdx.y * kThreads + threadIdx.x;
    if (cvec >= cv) return;
    pos = blockIdx.x;
  }
  const int c = cvec * 4;
  const Chan p[4] = {load_chan(a, c), load_chan(a, c + 1),
                     load_chan(a, c + 2), load_chan(a, c + 3)};
  const long long step = (long long)gridDim.x * per;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (; pos < P; pos += 2 * step) {
    const bool two = pos + step < P;
    const long long i0 = pos * a.C + c;
    const long long i1 = (pos + step) * a.C + c;
    const float4 x0 = *reinterpret_cast<const float4*>(a.x + i0);
    const float4 x1 =
        two ? *reinterpret_cast<const float4*>(a.x + i1) : zero;
    float4 g0 = zero, g1 = zero, r0 = zero, r1 = zero;
    if (a.flags & kGate) {
      g0 = __ldg(reinterpret_cast<const float4*>(
          a.gate + (pos / a.HW) * a.C + c));
      if (two)
        g1 = __ldg(reinterpret_cast<const float4*>(
            a.gate + ((pos + step) / a.HW) * a.C + c));
    }
    if (a.flags & kRes) {
      r0 = *reinterpret_cast<const float4*>(a.res + i0);
      if (two) r1 = *reinterpret_cast<const float4*>(a.res + i1);
    }
    *reinterpret_cast<float4*>(a.out + i0) = apply4(x0, p, g0, r0, a.flags);
    if (two)
      *reinterpret_cast<float4*>(a.out + i1) =
          apply4(x1, p, g1, r1, a.flags);
  }
}

// Any dense layout, a float at a time.
__global__ void __launch_bounds__(kThreads)
epilogue_flat(Args a, int nhwc, long long total) {
  const long long chw = (long long)a.C * a.HW;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    const long long n = i / chw;
    const int c = nhwc ? (int)(i % a.C) : (int)((i / a.HW) % a.C);
    const Chan p = load_chan(a, c);
    const float g = (a.flags & kGate) ? __ldg(a.gate + n * a.C + c) : 0.0f;
    const float r = (a.flags & kRes) ? a.res[i] : 0.0f;
    a.out[i] = apply(a.x[i], p, g, r, a.flags);
  }
}

// Blocks of ``kernel`` the card holds at once: a grid-stride kernel
// launches no more, so that each thread reads its channels' parameters
// once for as many positions as it can.
// Read once a device for each kernel.
template <typename K>
long long resident_blocks(K kernel) {
  static long long known[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && known[dev]) return known[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                0);
  const long long n = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm
                                                                   : 1);
  if (dev < kMaxDevices) known[dev] = n;
  return n;
}

template <int V, int G>
void launch_nchw(const Args& a, cudaStream_t s) {
  const int vecs = a.HW / V;
  const int segs = (vecs + G * 4 - 1) / (G * 4);  // about 4 loads a thread
  int seg_len = (a.HW + segs - 1) / segs;
  seg_len = (seg_len + V - 1) / V * V;
  const long long groups = (long long)a.N * a.C * segs;
  const long long blocks = (groups + kThreads / G - 1) / (kThreads / G);
  epilogue_nchw<V, G><<<(unsigned)blocks, kThreads, 0, s>>>(a, segs, seg_len,
                                                           groups);
}

long long min_ll(long long a, long long b) { return a < b ? a : b; }

}  // namespace

// Plain C entry, bound with ctypes.  x, res and out are [N, C, H, W]
// float32 of one dense layout: NCHW (nhwc = 0) or channels_last
// (nhwc = 1); gate is [N, C] contiguous; bias, mean, var, gamma, beta are
// [C].  A pointer whose stage ``flags`` leaves out may be null.
// ``aligned``: every pointer is 16-byte aligned.  Launches on ``stream``
// and returns cudaGetLastError() (0 on success).
extern "C" int fused_epilogue_f32(const float* x, const float* bias,
                                  const float* mean, const float* var,
                                  const float* gamma, const float* beta,
                                  const float* gate, const float* res,
                                  float* out, float eps, int N, int C, int HW,
                                  int nhwc, int flags, int aligned,
                                  void* stream) {
  const long long total = (long long)N * C * HW;
  if (total == 0) return 0;
  const Args a{x, bias, mean, var, gamma, beta, gate, res, out, eps,
               N, C, HW, flags};
  cudaStream_t s = (cudaStream_t)stream;
  if (nhwc && aligned && C % 4 == 0) {
    const int cv = C / 4;
    const long long P = (long long)N * HW;
    const int per = cv <= kThreads ? kThreads / cv : 1;
    const int tiles = cv <= kThreads ? 1 : (cv + kThreads - 1) / kThreads;
    const long long bx =
        min_ll((P + per - 1) / per,
               (resident_blocks(epilogue_nhwc4) + tiles - 1) / tiles);
    epilogue_nhwc4<<<dim3((unsigned)bx, tiles), kThreads, 0, s>>>(a, cv, per,
                                                                  P);
  } else if (nhwc) {
    const long long blocks = min_ll((total + kThreads - 1) / kThreads,
                                    resident_blocks(epilogue_flat));
    epilogue_flat<<<(unsigned)blocks, kThreads, 0, s>>>(a, 1, total);
  } else {
    const bool v4 = aligned && HW % 4 == 0;
    const int vecs = v4 ? HW / 4 : HW;
    if (v4 && vecs >= 512) launch_nchw<4, kThreads>(a, s);
    else if (v4) launch_nchw<4, 32>(a, s);
    else if (vecs >= 512) launch_nchw<1, kThreads>(a, s);
    else launch_nchw<1, 32>(a, s);
  }
  return (int)cudaGetLastError();
}
