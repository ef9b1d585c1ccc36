// sepconv7: the 7-tap "SAME" convolution along one spatial axis of an NCHW tensor,
//
//     out[b, o, h, w] = sum_{c, k} x[b, c, h, w + k - 3] * w[o, c, k]   (axis W, a 1x7 conv)
//     out[b, o, h, w] = sum_{c, k} x[b, c, h + k - 3, w] * w[o, c, k]   (axis H, a 7x1 conv)
//
// zero padded, f32 accumulation, output in the input's dtype (f32 or bf16).
//
// Replaces the TPU kernel tools/exp_sepconv.py:make_pallas_sepconv (body `kernel`,
// pl.pallas_call at :86). That kernel ran the 1x7 case as 7 shifted (rows*24, C) @ (C, O)
// dots over a W-padded (B*H, 24, C) copy in a sequential grid, and the 7x1 case needed an
// H<->W transposed copy (im2col_matmul_h). InceptionV3 runs 26 such convs per forward
// (Mixed_6b-6e and Mixed_7a), at 17x17 with C, O in {128, 160, 192}.
//
// Bound on an H100 SXM: 2*B*H*W*O*C*7 operations against reading x and w once and writing
// out once. At the trunk's shapes (B=512, 17x17) that is 40-76 GFLOP against 30-60 MB in
// bf16, ~1,000 operations per byte, so the operations bound it: >= 0.04-0.08 ms at the
// bf16 tensor-core peak (989 TFLOP/s), >= 0.6-1.1 ms at the f32 CUDA-core peak (67 TFLOP/s).
//
// Design (a first, simple version: f32 FMA on the CUDA cores, no tensor cores, no TMA):
// - A block owns one image b, an O-tile of 32 outputs and a tile of whole lines along the
//   conv axis, at most 320 positions: all 17 lines of a 17x17 plane. Blocks are independent;
//   nothing is carried across the grid.
// - The block walks C in chunks of 16. Per chunk it stages the zero-padded input strip
//   (chunk, lines, L + 6) and the weight slice (chunk, 7, 32) in shared memory as f32, so
//   the padding, the ragged lines and the C and O tails are zeros, never branches.
// - Each of the 4 warps owns 8 outputs and each lane up to 10 positions (lane + 32*s): an
//   8x10 tile of sums in registers. Weights are warp-uniform (a shared-memory broadcast),
//   inputs are lane-consecutive, so one loaded value feeds 8 FMAs.
// - A tap is an offset into the strip, so the 7x1 case reads x through its strides and no
//   transposed copy is made. Positions are numbered along the dimension that is contiguous
//   in memory, so loads and stores coalesce for both axes.
// wgmma, TMA and warp specialisation are left to a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int TAPS = 7;
constexpr int HALF = 3;                   // taps on each side of the centre
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int O_PER_WARP = 8;
constexpr int O_TILE = WARPS * O_PER_WARP;  // 32 outputs per block
constexpr int POS_SLOTS = 10;              // positions per lane
constexpr int MAX_POS = 32 * POS_SLOTS;    // 320 positions per block
constexpr int C_CHUNK = 16;                // input channels staged per step
constexpr int STRIP_MAX = 480;             // floats of padded strip per staged channel

struct Geometry {
  int C, O;
  int P, L;        // lines, and positions along a line (the conv axis)
  int sp, sl;      // element strides between lines and along a line, in one (b, c) plane
  int plane;       // H * W
  int n_lines;     // lines per block
  int strip;       // n_lines * (L + 6): floats per staged channel
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
sepconv7_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, Geometry g) {
  __shared__ float xs[C_CHUNK * STRIP_MAX];
  __shared__ __align__(16) float ws[C_CHUNK * TAPS * O_TILE];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int o0 = blockIdx.y * O_TILE;
  const int p0 = blockIdx.z * g.n_lines;
  const int lines = min(g.n_lines, g.P - p0);  // valid lines in this block
  const int npos = lines * g.L;
  const int LP = g.L + 2 * HALF;
  // axis H: lines run along W, which is the contiguous dimension, so lines go innermost
  const bool line_inner = g.sl != 1;

  // per slot: strip offset of the position's tap 0, and its offset within an output plane
  int soff[POS_SLOTS];
  int goff[POS_SLOTS];
#pragma unroll
  for (int s = 0; s < POS_SLOTS; ++s) {
    const int pos = lane + 32 * s;
    const int line = line_inner ? pos % lines : pos / g.L;
    const int l = line_inner ? pos / lines : pos % g.L;
    const bool ok = pos < npos;
    soff[s] = ok ? line * LP + l : 0;
    goff[s] = ok ? (p0 + line) * g.sp + l * g.sl : -1;
  }

  float acc[O_PER_WARP][POS_SLOTS];
#pragma unroll
  for (int o = 0; o < O_PER_WARP; ++o)
#pragma unroll
    for (int s = 0; s < POS_SLOTS; ++s) acc[o][s] = 0.f;

  const T* xb = x + (size_t)b * g.C * g.plane;
  for (int c0 = 0; c0 < g.C; c0 += C_CHUNK) {
    __syncthreads();  // the previous chunk's readers are done with xs and ws
    // stage the padded strip: xs[c][line][j] = x[b, c0+c, p0+line, j-3], zeros outside
    for (int i = tid; i < C_CHUNK * g.strip; i += THREADS) {
      const int c = i / g.strip;
      const int r = i - c * g.strip;
      const int line = line_inner ? r % g.n_lines : r / LP;
      const int j = line_inner ? r / g.n_lines : r % LP;
      const int l = j - HALF;
      float v = 0.f;
      if (c0 + c < g.C && line < lines && l >= 0 && l < g.L)
        v = to_f32(xb[(size_t)(c0 + c) * g.plane + (p0 + line) * g.sp + l * g.sl]);
      xs[c * g.strip + line * LP + j] = v;
    }
    // stage the weights: ws[c][k][o] = w[o0+o, c0+c, k], zeros outside
    for (int i = tid; i < O_TILE * C_CHUNK * TAPS; i += THREADS) {
      const int o = i / (C_CHUNK * TAPS);
      const int ck = i - o * (C_CHUNK * TAPS);  // c * 7 + k
      float v = 0.f;
      if (o0 + o < g.O && c0 + ck / TAPS < g.C)
        v = to_f32(w[((size_t)(o0 + o) * g.C + c0) * TAPS + ck]);
      ws[ck * O_TILE + o] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < C_CHUNK; ++c) {
      const float* xc = xs + c * g.strip;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        const float4* wk = reinterpret_cast<const float4*>(ws + (c * TAPS + k) * O_TILE + warp * O_PER_WARP);
        const float4 wa = wk[0];
        const float4 wb = wk[1];
        const float wv[O_PER_WARP] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int s = 0; s < POS_SLOTS; ++s) {
          const float xv = xc[soff[s] + k];
#pragma unroll
          for (int o = 0; o < O_PER_WARP; ++o) acc[o][s] = fmaf(wv[o], xv, acc[o][s]);
        }
      }
    }
  }

  T* ob = out + (size_t)b * g.O * g.plane;
#pragma unroll
  for (int o = 0; o < O_PER_WARP; ++o) {
    const int oo = o0 + warp * O_PER_WARP + o;
    if (oo < g.O) {
#pragma unroll
      for (int s = 0; s < POS_SLOTS; ++s)
        if (goff[s] >= 0) ob[(size_t)oo * g.plane + goff[s]] = from_f32<T>(acc[o][s]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int B, int C, int H, int W, int O, int axis,
                   cudaStream_t stream) {
  Geometry g;
  g.C = C;
  g.O = O;
  g.plane = H * W;
  if (axis == 3) {  // 1x7: lines are rows, taps run along W
    g.P = H; g.L = W; g.sp = W; g.sl = 1;
  } else {          // 7x1: lines are columns, taps run along H
    g.P = W; g.L = H; g.sp = 1; g.sl = W;
  }
  const int LP = g.L + 2 * HALF;
  g.n_lines = std::min(g.P, std::min(MAX_POS / g.L, STRIP_MAX / LP));
  if (g.n_lines < 1) return cudaErrorInvalidValue;
  g.strip = g.n_lines * LP;
  const dim3 grid(B, (O + O_TILE - 1) / O_TILE, (g.P + g.n_lines - 1) / g.n_lines);
  sepconv7_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                    static_cast<T*>(out), g);
  return cudaGetLastError();
}

}  // namespace

// ---- host entry (plain C interface, bound with ctypes) ----
// x (B, C, H, W), w (O, C, 7) and out (B, O, H, W), contiguous, all of one dtype:
// dtype 0 = float32, 1 = bfloat16. axis 3 = W (1x7), 2 = H (7x1). Returns cudaGetLastError().
extern "C" int sepconv7_launch(const void* x, const void* w, void* out, int B, int C, int H, int W, int O,
                               int axis, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0 || (axis != 2 && axis != 3)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, B, C, H, W, O, axis, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, B, C, H, W, O, axis, s);
  return cudaErrorInvalidValue;
}
