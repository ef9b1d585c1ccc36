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
// bf16: an implicit GEMM on the tensor cores (wgmma), M = output positions, N = O,
// K = 7*C walked as (32-channel chunk, tap). No im2col reaches device memory.
// - Persistent grid (one block per SM, 416 threads): a tile is (image, 64 outputs, a run of
//   whole lines of at most 384 positions): all 17 lines of a 17x17 plane. Tiles are walked
//   with the O-tiles of one image next to each other, so x is read from L2 after the first.
// - Warp 12 is the producer. Per chunk it brings the raw [c][position] slice of x into a ring
//   of 3 slots with cp.async.bulk (one copy per chunk when the tile is a whole plane, one per
//   channel when lines are cut along W) completing on an mbarrier; ragged or unaligned
//   slices (a C tail that is not a multiple of 8, lines cut along H) are plain loads by the
//   same warp. The weight slice comes by bulk copy into a ring of 2 slots, pre-packed per
//   (O-tile, chunk) into wgmma's no-swizzle K-major layout [tap][c/8][o][8] by a small pack
//   kernel at each call (<= 0.5 MB, zero padded in C and O). A raw slot is freed as soon as
//   it is transposed, a weight slot when its wgmma have retired, so loads run two chunks
//   ahead of the tensor cores.
// - Warps 0-11 are three consumer warpgroups. Per chunk they transpose the raw slice into a
//   zero-haloed strip [line][j][c] (j = position along the conv axis + 3, 80-byte rows:
//   32 channels + 8 of padding, so ldmatrix rows are 16-byte aligned and conflict-free), then
//   run m64n64k16 wgmma with A from registers: an ldmatrix.x4 from strip rows shifted by the
//   tap k, so a tap is an address offset, never a copy. B is the tap's [o][c] weight tile,
//   read through a matrix descriptor. Each warpgroup owns up to 2 row tiles of 64 (64 f32
//   accumulators a thread): three warpgroups share 289 positions as 2+2+1 tiles, where two
//   took 3+2, and give the transpose 384 threads. A fragments are double-buffered with
//   wgmma.wait_group 1. Two strips alternate, so a chunk's transpose overlaps the previous
//   chunk's last wgmma.
// - Rows are numbered in memory order (h*W + w) for both axes; the epilogue rounds to bf16,
//   stages each 64x64 tile through shared memory and writes contiguous runs of each (b, o)
//   plane. Padding, ragged lines, M-row tails and the C and O tails are zeros or skipped
//   stores, never branches inside the product.
// - Shared memory: 3 raw slots x 24,576 + 2 weight slots x 28,672 + 2 strips x 32,000 +
//   3 x 9,216 epilogue tiles + barriers = 222,800 B (dynamic).
// - Measured on an H100 SXM (PERF.md): about F.conv2d's time on the trunk's convs, ~27% of
//   the tensor-core bound. The tensor cores are not what bounds it: staging (loads,
//   transpose) and the epilogue are, and ~15% of the products are padding (289 positions in
//   320 rows; O=160 in three 64-wide tiles).
// f32 keeps the first design, f32 FMA on the CUDA cores: the JAX trunk's f32 convs run at
// Precision.HIGHEST and the 1e-4 limit rules out TF32. A block owns (image, 32 outputs,
// <= 320 positions); per 16-channel chunk it stages the padded strip and weight slice as
// f32 in shared memory, and each lane keeps an 8x10 tile of sums in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int TAPS = 7;
constexpr int HALF = 3;  // taps on each side of the centre

// --------------------------------------------------------------------------------------
// f32: SIMT FMA
// --------------------------------------------------------------------------------------
namespace simt {

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

__global__ void __launch_bounds__(THREADS)
sepconv7_simt_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out, Geometry g) {
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

  const float* xb = x + (size_t)b * g.C * g.plane;
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
        v = xb[(size_t)(c0 + c) * g.plane + (p0 + line) * g.sp + l * g.sl];
      xs[c * g.strip + line * LP + j] = v;
    }
    // stage the weights: ws[c][k][o] = w[o0+o, c0+c, k], zeros outside
    for (int i = tid; i < O_TILE * C_CHUNK * TAPS; i += THREADS) {
      const int o = i / (C_CHUNK * TAPS);
      const int ck = i - o * (C_CHUNK * TAPS);  // c * 7 + k
      float v = 0.f;
      if (o0 + o < g.O && c0 + ck / TAPS < g.C) v = w[((size_t)(o0 + o) * g.C + c0) * TAPS + ck];
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

  float* ob = out + (size_t)b * g.O * g.plane;
#pragma unroll
  for (int o = 0; o < O_PER_WARP; ++o) {
    const int oo = o0 + warp * O_PER_WARP + o;
    if (oo < g.O) {
#pragma unroll
      for (int s = 0; s < POS_SLOTS; ++s)
        if (goff[s] >= 0) ob[(size_t)oo * g.plane + goff[s]] = acc[o][s];
    }
  }
}

cudaError_t launch(const float* x, const float* w, float* out, int B, int C, int H, int W, int O, int axis,
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
  sepconv7_simt_kernel<<<grid, THREADS, 0, stream>>>(x, w, out, g);
  return cudaGetLastError();
}

}  // namespace simt

// --------------------------------------------------------------------------------------
// bf16: implicit GEMM on the tensor cores (wgmma), warp-specialised, async staging
// --------------------------------------------------------------------------------------
namespace tc {

constexpr int CC = 32;                              // channels per chunk
constexpr int CG = CC / 8;                          // 8-channel groups per chunk
constexpr int N_TILE = 64;                          // outputs per tile: wgmma N
constexpr int M_SLOTS = 2;                          // 64-row tiles per consumer warpgroup
constexpr int CONSUMER_WGS = 3;
constexpr int MAX_ROWS = CONSUMER_WGS * M_SLOTS * 64;  // 384 positions per tile
constexpr int STRIP_ROWS = 400;                     // lines * (L + 6) per strip
constexpr int ROW_BYTES = (CC + 8) * 2;             // 80: 16-byte aligned, ldmatrix conflict-free
constexpr int RAW_SLOTS = 3;                        // raw slices of x: freed once transposed
constexpr int RAW_BYTES = CC * MAX_ROWS * 2;        // 24,576
constexpr int W_SLOTS = 2;                          // weight slices: freed once the wgmma retire
constexpr int W_ELEMS = TAPS * CC * N_TILE;         // one packed (O-tile, chunk) weight slice
constexpr int W_BYTES = W_ELEMS * 2;                // 28,672
constexpr int W_OFF = RAW_SLOTS * RAW_BYTES;
constexpr int STRIP_BYTES = STRIP_ROWS * ROW_BYTES;  // 32,000
constexpr int EP_STRIDE = 72;                       // bf16 per row of an epilogue tile [o][row]
constexpr int EP_BYTES = N_TILE * EP_STRIDE * 2;    // 9,216
constexpr int STRIP_OFF = W_OFF + W_SLOTS * W_BYTES;
constexpr int EP_OFF = STRIP_OFF + 2 * STRIP_BYTES;
constexpr int BAR_OFF = EP_OFF + CONSUMER_WGS * EP_BYTES;
constexpr int SMEM_BYTES = BAR_OFF + 2 * (RAW_SLOTS + W_SLOTS) * 8;
constexpr int CONSUMERS = CONSUMER_WGS * 128;
constexpr int THREADS = CONSUMERS + 32;             // + one producer warp
constexpr int BAR_CONSUMERS = 1;                    // named barrier ids (0 is __syncthreads)
constexpr int BAR_WG0 = 2;

struct Geometry {
  int C, O;
  int P, L;          // lines, and positions along a line (the conv axis)
  int sp, sl;        // element strides between lines and along a line, in one (b, c) plane
  int plane;         // H * W
  int n_lines;       // lines per tile
  int n_lt, n_ot, n_ch;
  int rs;            // elements between channels of a staged raw slice
  int tiles;         // B * n_ot * n_lt
  int axis_h;        // 7x1: lines run along W, positions along H
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

// Spins until the barrier's phase with the given parity has completed. A wait that never
// ends (a fault in the pipeline) traps after ~2^26 tries instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// K-major, no swizzle: core matrices of 8 rows x 16 B; LBO steps 8 channels (N_TILE rows of
// 16 B), SBO steps 8 outputs (128 B).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  constexpr uint64_t LBO = (N_TILE * 16) >> 4;
  constexpr uint64_t SBO = 128 >> 4;
  return (uint64_t)((addr >> 4) & 0x3FFF) | (LBO << 16) | (SBO << 32);
}

// D (64 x 64, f32) += A (64 x 16, bf16, registers) * B (16 x 64, bf16, shared memory)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

struct Tile {
  int b, ot, p0, nl, npos;
};

__device__ __forceinline__ Tile tile_of(const Geometry& g, int t) {
  Tile tl;
  tl.b = t / (g.n_ot * g.n_lt);
  const int r = t - tl.b * (g.n_ot * g.n_lt);
  const int lt = r / g.n_ot;
  tl.ot = r - lt * g.n_ot;  // O-tiles of one line tile are neighbours: x is reused from L2
  tl.p0 = lt * g.n_lines;
  tl.nl = min(g.n_lines, g.P - tl.p0);
  tl.npos = tl.nl * g.L;
  return tl;
}

// Position q of a tile (memory order) -> (line, l): lines are rows (1x7) or columns (7x1).
__device__ __forceinline__ void split(const Geometry& g, int nl, int q, int& line, int& l) {
  if (g.axis_h) {
    l = q / nl;
    line = q - l * nl;
  } else {
    line = q / g.L;
    l = q - line * g.L;
  }
}

__device__ __forceinline__ int strip_row(const Geometry& g, int nl, int q) {
  int line, l;
  split(g, nl, q, line, l);
  return line * (g.L + 2 * HALF) + l;  // row of tap 0; tap k is row + k
}

// wp[ot][ch][k][c/8][o][c%8] = w[ot*64 + o, ch*32 + c, k], zeros outside (O, C)
__global__ void pack_weights_kernel(const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ wp, int C,
                                    int O, int n_ch, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int e = i & 7;
  const int o = (i >> 3) % N_TILE;
  int r = i / (8 * N_TILE);
  const int cg = r % CG;
  r /= CG;
  const int k = r % TAPS;
  r /= TAPS;
  const int ch = r % n_ch;
  const int ot = r / n_ch;
  const int oo = ot * N_TILE + o;
  const int cc = ch * CC + cg * 8 + e;
  wp[i] = (oo < O && cc < C) ? w[((size_t)oo * C + cc) * TAPS + k] : __float2bfloat16(0.f);
}

__global__ void __launch_bounds__(THREADS, 1)
sepconv7_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                   __nv_bfloat16* __restrict__ out, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t raw_full = base + BAR_OFF;               // RAW_SLOTS: raw slice landed
  const uint32_t raw_empty = raw_full + RAW_SLOTS * 8;     // RAW_SLOTS: raw slice transposed
  const uint32_t w_full = raw_empty + RAW_SLOTS * 8;       // W_SLOTS: weight slice landed
  const uint32_t w_empty = w_full + W_SLOTS * 8;           // W_SLOTS: its wgmma retired
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < RAW_SLOTS; ++s) {
      mbar_init(raw_full + 8 * s, 32);
      mbar_init(raw_empty + 8 * s, CONSUMERS);
    }
    for (int s = 0; s < W_SLOTS; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // both strips start as zeros: the halo rows (j < 3, j >= L + 3) are never written again
  for (int i = tid; i < 2 * STRIP_BYTES / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem + STRIP_OFF)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // the warpgroup index, broadcast so the compiler sees it is uniform over each warp: wgmma
  // issued under a condition it cannot prove uniform is serialised
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == CONSUMER_WGS) {
    // ---------------- producer warp ----------------
    uint32_t it = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      const Tile tl = tile_of(g, t);
      for (int ch = 0; ch < g.n_ch; ++ch, ++it) {
        const int ws = it % W_SLOTS;
        mbar_wait(w_empty + 8 * ws, ((it / W_SLOTS) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(w_full + 8 * ws, W_BYTES);
          bulk_copy(base + W_OFF + ws * W_BYTES, wp + ((size_t)tl.ot * g.n_ch + ch) * W_ELEMS, W_BYTES,
                    w_full + 8 * ws);
        }
        const int s = it % RAW_SLOTS;
        mbar_wait(raw_empty + 8 * s, ((it / RAW_SLOTS) & 1) ^ 1);
        const uint32_t raw = base + s * RAW_BYTES;
        const uint32_t bar = raw_full + 8 * s;
        const int c0 = ch * CC;
        const int cv = min(CC, g.C - c0);
        const __nv_bfloat16* xc = x + ((size_t)tl.b * g.C + c0) * g.plane;
        const bool whole = tl.nl == g.P;
        const uint32_t run_bytes = (uint32_t)tl.npos * 2;  // one channel's positions
        // bulk copies need 16-byte aligned sources and sizes
        bool bulk;
        if (whole) {
          bulk = ((reinterpret_cast<uintptr_t>(xc) | (cv * run_bytes)) & 15) == 0;
        } else if (!g.axis_h) {
          const __nv_bfloat16* src = xc + (size_t)min(lane, cv - 1) * g.plane + (size_t)tl.p0 * g.L;
          bulk = __all_sync(0xffffffffu, ((reinterpret_cast<uintptr_t>(src) | run_bytes) & 15) == 0);
        } else {
          bulk = false;
        }
        if (bulk && lane == 0) mbar_expect_tx(bar, cv * run_bytes);
        __syncwarp();
        if (bulk) {
          if (whole) {
            if (lane == 0) bulk_copy(raw, xc, cv * run_bytes, bar);
          } else if (lane < cv) {
            bulk_copy(raw + lane * g.rs * 2, xc + (size_t)lane * g.plane + (size_t)tl.p0 * g.L, run_bytes, bar);
          }
        } else {
          __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(smem + s * RAW_BYTES);
          for (int i = lane; i < cv * tl.npos; i += 32) {
            const int c = i / tl.npos;
            const int q = i - c * tl.npos;
            int line, l;
            split(g, tl.nl, q, line, l);
            dst[c * g.rs + q] = xc[(size_t)c * g.plane + (tl.p0 + line) * g.sp + l * g.sl];
          }
        }
        mbar_arrive(bar);  // release: this lane's plain stores are visible to the consumers
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  const int wwarp = (tid >> 5) & 3;
  uint32_t it = 0;
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const Tile tl = tile_of(g, t);
    // ldmatrix.x4 row address of this lane for each 64-row slot, tap 0, channels 0-15:
    // lanes 0-7 rows 0-7, lanes 8-15 rows 8-15 (channels 0-7), lanes 16-31 again (channels 8-15)
    uint32_t arow[M_SLOTS];
    bool active[M_SLOTS];
#pragma unroll
    for (int m = 0; m < M_SLOTS; ++m) {
      const int row0 = (wg * M_SLOTS + m) * 64;
      active[m] = row0 < tl.npos;  // uniform over the warpgroup
      int q = row0 + wwarp * 16 + (lane & 15);
      if (q >= tl.npos) q = 0;  // a row past the tile reads a real row; its result is dropped
      arow[m] = strip_row(g, tl.nl, q) * ROW_BYTES + (lane >> 4) * 16;
    }
    float acc[M_SLOTS][32];
#pragma unroll
    for (int m = 0; m < M_SLOTS; ++m)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;

    int prev = 0;
    for (int ch = 0; ch < g.n_ch; ++ch, ++it) {
      const int s = it % RAW_SLOTS;
      const int ws = it % W_SLOTS;
      const uint32_t strip = base + STRIP_OFF + (it & 1) * STRIP_BYTES;
      mbar_wait(raw_full + 8 * s, (it / RAW_SLOTS) & 1);
      {  // transpose raw [c][q] into strip rows [line][l + 3][c]; channels past C are zeros
        const __nv_bfloat16* raw = reinterpret_cast<const __nv_bfloat16*>(smem + s * RAW_BYTES);
        unsigned char* dst = smem + STRIP_OFF + (it & 1) * STRIP_BYTES;
        const int cv = min(CC, g.C - ch * CC);
        for (int i = tid; i < CG * tl.npos; i += CONSUMERS) {
          const int cg = i / tl.npos;
          const int q = i - cg * tl.npos;
          const unsigned short* src = reinterpret_cast<const unsigned short*>(raw) + cg * 8 * g.rs + q;
          uint32_t v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = cg * 8 + 2 * e;
            const uint32_t lo = c < cv ? src[2 * e * g.rs] : 0u;
            const uint32_t hi = c + 1 < cv ? src[(2 * e + 1) * g.rs] : 0u;
            v[e] = lo | (hi << 16);
          }
          const int row = strip_row(g, tl.nl, q) + HALF;
          *reinterpret_cast<uint4*>(dst + row * ROW_BYTES + cg * 16) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
      mbar_arrive(raw_empty + 8 * s);  // the raw slot may be refilled
      if (ch > 0) {  // the previous chunk's wgmma have retired: its weight slot may be refilled
        wgmma_wait<0>();
        mbar_arrive(w_empty + 8 * prev);
      }
      named_sync(BAR_CONSUMERS, CONSUMERS);  // the strip is complete
      mbar_wait(w_full + 8 * ws, (it / W_SLOTS) & 1);

      const uint32_t wst = base + W_OFF + ws * W_BYTES;
      uint32_t a[2][M_SLOTS][4];
#pragma unroll
      for (int ks = 0; ks < CC / 16; ++ks) {
#pragma unroll
        for (int k = 0; k < TAPS; ++k) {
          const int step = ks * TAPS + k;
          const int p = step & 1;
          if (step >= 2) wgmma_wait<1>();  // the group that read a[p] has retired
#pragma unroll
          for (int m = 0; m < M_SLOTS; ++m)
            if (active[m]) ldmatrix_x4(a[p][m], strip + arow[m] + k * ROW_BYTES + ks * 32);
          wgmma_fence();
          const uint64_t desc = b_desc(wst + (k * CG + 2 * ks) * N_TILE * 16);
#pragma unroll
          for (int m = 0; m < M_SLOTS; ++m)
            if (active[m]) wgmma_m64n64k16(acc[m], a[p][m], desc);
          wgmma_commit();
        }
      }
      prev = ws;
    }
    wgmma_wait<0>();
    mbar_arrive(w_empty + 8 * prev);
#pragma unroll
    for (int m = 0; m < M_SLOTS; ++m)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(acc[m][i]);

    // epilogue: each 64x64 tile through shared memory [o][row], then runs of each (b, o) plane
    __nv_bfloat16* ep = reinterpret_cast<__nv_bfloat16*>(smem + EP_OFF + wg * EP_BYTES);
    const int o0 = tl.ot * N_TILE;
    const bool whole = tl.nl == g.P;
#pragma unroll
    for (int m = 0; m < M_SLOTS; ++m) {
      if (!active[m]) continue;
      named_sync(BAR_WG0 + wg, 128);  // the previous tile's readers are done
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = wwarp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        ep[col * EP_STRIDE + row] = __float2bfloat16_rn(acc[m][i]);
      }
      named_sync(BAR_WG0 + wg, 128);
      const int row0 = (wg * M_SLOTS + m) * 64;
      for (int o = wwarp; o < N_TILE && o0 + o < g.O; o += 4) {
        __nv_bfloat16* plane = out + ((size_t)tl.b * g.O + o0 + o) * g.plane;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane + 32 * h;
          const int q = row0 + r;
          if (q < tl.npos) {
            // memory order: a tile of whole lines along W, or all the lines, is one run
            int at = tl.p0 * g.L + q;
            if (g.axis_h && !whole) {
              int line, l;
              split(g, tl.nl, q, line, l);
              at = (tl.p0 + line) * g.sp + l * g.sl;
            }
            plane[at] = ep[o * EP_STRIDE + r];
          }
        }
      }
    }
  }
}

cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* wp, __nv_bfloat16* out, int B,
                   int C, int H, int W, int O, int axis, cudaStream_t stream) {
  Geometry g;
  g.C = C;
  g.O = O;
  g.plane = H * W;
  g.axis_h = axis == 2;
  if (!g.axis_h) {  // 1x7: lines are rows, taps run along W
    g.P = H; g.L = W; g.sp = W; g.sl = 1;
  } else {          // 7x1: lines are columns, taps run along H
    g.P = W; g.L = H; g.sp = 1; g.sl = W;
  }
  g.n_lines = std::min(g.P, std::min(MAX_ROWS / g.L, STRIP_ROWS / (g.L + 2 * HALF)));
  if (g.n_lines < 1) return cudaErrorInvalidValue;
  g.n_lt = (g.P + g.n_lines - 1) / g.n_lines;
  g.n_ot = (O + N_TILE - 1) / N_TILE;
  g.n_ch = (C + CC - 1) / CC;
  // a whole plane is one contiguous run per chunk; a cut one keeps 16-byte aligned channels
  g.rs = g.n_lines == g.P ? g.plane : (g.n_lines * g.L + 7) / 8 * 8;
  g.tiles = B * g.n_ot * g.n_lt;

  const int packed = g.n_ot * g.n_ch * W_ELEMS;
  pack_weights_kernel<<<(packed + 255) / 256, 256, 0, stream>>>(w, wp, C, O, g.n_ch, packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(sepconv7_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  sepconv7_tc_kernel<<<std::min(g.tiles, sms), THREADS, SMEM_BYTES, stream>>>(x, wp, out, g);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// ---- host entry (plain C interface, bound with ctypes) ----
// x (B, C, H, W), w (O, C, 7) and out (B, O, H, W), contiguous, all of one dtype:
// dtype 0 = float32, 1 = bfloat16. axis 3 = W (1x7), 2 = H (7x1). For bfloat16, `wpack` is
// scratch for ceil(O/64) * ceil(C/32) * 7 * 32 * 64 bfloat16 values (the packed weights);
// float32 ignores it.
// Returns cudaGetLastError() after the launches.
extern "C" int sepconv7_launch(const void* x, const void* w, void* wpack, void* out, int B, int C, int H, int W,
                               int O, int axis, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0 || (axis != 2 && axis != 3)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::launch(static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), B, C,
                        H, W, O, axis, s);
  if (dtype == 1) {
    if (wpack == nullptr) return cudaErrorInvalidValue;
    return tc::launch(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                      static_cast<__nv_bfloat16*>(wpack), static_cast<__nv_bfloat16*>(out), B, C, H, W, O, axis, s);
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 kernel, for reports (ptxas does not see it).
extern "C" int sepconv7_tc_smem_bytes() { return tc::SMEM_BYTES; }
