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
// out once. At the trunk's shapes that is ~1,000 operations per byte, so the operations
// bound it: in bf16 at the tensor cores' 989 TFLOP/s; in f32, which takes three TF32
// products per product (below), at 495/3 = 165 TFLOP/s.
//
// Both dtypes run one design: an implicit GEMM on the tensor cores (wgmma), M = output
// positions, N = O, K = 7*C walked as (chunk of 64 bytes of channels, tap). No im2col
// reaches device memory. A chunk is 32 bf16 or 16 f32 channels, so both paths share one
// byte geometry: 24,576-byte raw slots, 80-byte strip rows, 28,672-byte weight parts, and
// 7 taps x 2 k-steps = 14 wgmma steps a chunk (m64n64k16 bf16, m64n64k8 TF32).
// - Persistent grid (one block per SM, 416 threads): a tile is (image, 64 outputs, a run of
//   whole lines of at most 384 positions): all 17 lines of a 17x17 plane. Tiles are walked
//   with the O-tiles of one image next to each other, so x is read from L2 after the first.
//   A last wave that would leave over half the SMs idle (the f32 trunk at B=64: 192 tiles on
//   132 SMs) runs each of its tiles as two halves on two SMs, row tiles 0-2 and 3-5, one per
//   warpgroup: each half stages the whole plane, so the wave takes ~3/5 of a tile's products.
// - Warp 12 is the producer. Per chunk it brings the raw [c][position] slice of x into a ring
//   of raw slots with cp.async.bulk (one copy per chunk when the tile is a whole plane, one
//   per channel when lines are cut along W) completing on an mbarrier; ragged or unaligned
//   slices (a C tail that does not fill 16 bytes, lines cut along H) are plain loads by the
//   same warp. The weight slice comes by bulk copy into a ring of 2 slots, pre-packed per
//   (O-tile, chunk) into wgmma's no-swizzle K-major layout [tap][c/16B][o][16 B] by a small
//   pack kernel at each call (zero padded in C and O). A raw slot is freed as soon as it is
//   transposed, a weight slot when its wgmma have retired, so loads run ahead of the tensor
//   cores.
// - Warps 0-11 are three consumer warpgroups. Per chunk they transpose the raw slice into a
//   zero-haloed strip [line][j][c] (j = position along the conv axis + 3, 80-byte rows:
//   64 bytes of channels + 16 of padding, so ldmatrix rows are 16-byte aligned and
//   conflict-free; each thread's share of the transpose is computed once per tile, as
//   offsets, since its integer divisions cost more than the copy), then run wgmma with A from registers: an ldmatrix.x4 from strip rows
//   shifted by the tap k, so a tap is an address offset, never a copy (on the b16 view, an
//   8x8 matrix is 8 rows of 8 bf16 or of 4 TF32: the same load serves both fragments). B is
//   the tap's [o][c] weight tile, read through a matrix descriptor. Each warpgroup owns up
//   to 2 row tiles of 64 (64 f32 accumulators a thread): three warpgroups share 289
//   positions as 2+2+1 tiles. A fragments are double-buffered with wgmma.wait_group 1. Two
//   strips alternate, so a chunk's transpose overlaps the previous chunk's last wgmma.
// - Rows are numbered in memory order (h*W + w) for both axes. Padding, ragged lines, M-row
//   tails and the C and O tails are zeros or skipped stores, never branches inside the
//   product.
//
// bf16: one m64n64k16 wgmma a step. The epilogue rounds to bf16, stages each 64x64 tile
// through shared memory and writes contiguous runs of each (b, o) plane. Shared memory:
// 3 raw slots x 24,576 + 2 weight slots x 28,672 + 2 strips x 32,000 + 3 x 9,216 epilogue
// tiles + barriers = 222,800 B.
//
// f32: 3xTF32 split products. The JAX trunk's f32 convs run at Precision.HIGHEST and the
// 1e-4 limit rules out one TF32 product (~1.5e-3 at the trunk's shapes); splitting each
// operand into hi = rna_tf32(v) and lo = rna_tf32(v - hi) and summing x_lo*w_hi + x_hi*w_lo
// + x_hi*w_hi (the small terms first) in the f32 accumulator keeps ~2e-6 with sums rounded
// to nearest; the tensor cores' accumulation truncates, which leaves up to ~6e-5 at the
// trunk's shapes, growing with C (three additions per 8 channels per tap). x is split in
// registers after the ldmatrix; the pack kernel writes w_hi and w_lo as two K-major parts
// of each weight slice (TF32 wgmma takes no transposed B). The rounding is explicit: the
// tensor cores read only the top 19 bits of a TF32 operand, which would truncate. Shared
// memory: the weight slots double (hi + lo), so the f32 path keeps 2 raw slots and stores
// its f32 accumulators straight from registers (8 consecutive positions of one plane per
// lane group: whole 32-byte sectors) instead of staging them: 2 x 24,576 + 2 x 57,344 +
// 2 x 32,000 + barriers = 227,904 B.
//
// Measured on an H100 SXM (PERF.md): both paths take less time than F.conv2d on the trunk's
// convs, at a third of the bound or less. The tensor cores run near their rate inside a
// chunk's wgmma steps; between the steps, the transpose, the waits at each chunk and each
// tile's epilogue do not overlap them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int TAPS = 7;
constexpr int HALF = 3;  // taps on each side of the centre

namespace tc {

constexpr int CHUNK_BYTES = 64;                     // channel bytes per chunk (one strip row)
constexpr int CG = CHUNK_BYTES / 16;                // 16-byte channel groups per chunk
constexpr int K_STEPS = CHUNK_BYTES / 32;           // wgmma steps per tap: 32 bytes of K each
constexpr int N_TILE = 64;                          // outputs per tile: wgmma N
constexpr int M_SLOTS = 2;                          // 64-row tiles per consumer warpgroup
constexpr int CONSUMER_WGS = 3;
constexpr int MAX_ROWS = CONSUMER_WGS * M_SLOTS * 64;  // 384 positions per tile
constexpr int STRIP_ROWS = 400;                     // lines * (L + 6) per strip
constexpr int ROW_BYTES = CHUNK_BYTES + 16;         // 80: 16-byte aligned, ldmatrix conflict-free
constexpr int RAW_BYTES = CHUNK_BYTES * MAX_ROWS;   // 24,576: one chunk of MAX_ROWS positions
constexpr int W_SLOTS = 2;                          // weight slices: freed once the wgmma retire
constexpr int W_PART_BYTES = TAPS * CHUNK_BYTES * N_TILE;  // 28,672: one packed weight part
constexpr int STRIP_BYTES = STRIP_ROWS * ROW_BYTES;  // 32,000
constexpr int CONSUMERS = CONSUMER_WGS * 128;
constexpr int THREADS = CONSUMERS + 32;             // + one producer warp
constexpr int BAR_CONSUMERS = 1;                    // named barrier ids (0 is __syncthreads)
constexpr int BAR_WG0 = 2;
constexpr int T_ITEMS = CG * MAX_ROWS / CONSUMERS;  // transpose items of a thread per chunk

struct Geometry {
  int C, O;
  int P, L;          // lines, and positions along a line (the conv axis)
  int sp, sl;        // element strides between lines and along a line, in one (b, c) plane
  int plane;         // H * W
  int n_lines;       // lines per tile
  int n_lt, n_ot, n_ch;
  int rs;            // elements between channels of a staged raw slice
  int full;          // whole tiles, B * n_ot * n_lt less those of a last wave split in halves
  int tiles;         // work items: the whole tiles, then two halves of each split one
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

// f32 -> TF32, round to nearest (ties away): the low 13 bits of the result are zero
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm volatile("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// K-major, no swizzle: core matrices of 8 rows x 16 B; LBO steps 16 bytes of channels
// (N_TILE rows of 16 B), SBO steps 8 outputs (128 B).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  constexpr uint64_t LBO = (N_TILE * 16) >> 4;
  constexpr uint64_t SBO = 128 >> 4;
  return (uint64_t)((addr >> 4) & 0x3FFF) | (LBO << 16) | (SBO << 32);
}

#define SEPCONV7_D32                                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),     \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),      \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SEPCONV7_D32_OPERANDS                                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                       \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "

// D (64 x 64, f32) += A (64 x 16, bf16, registers) * B (16 x 64, bf16, shared memory)
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SEPCONV7_D32_OPERANDS
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
      : SEPCONV7_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// D (64 x 64, f32) += A (64 x 8, TF32, registers) * B (8 x 64, TF32, shared memory, K-major)
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SEPCONV7_D32_OPERANDS
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}"
      : SEPCONV7_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

#undef SEPCONV7_D32
#undef SEPCONV7_D32_OPERANDS

__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// What differs between the two paths: the element type, the A fragment and its products,
// the number of weight parts, the raw ring's depth and the epilogue's staging.
struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int W_PARTS = 1;
  static constexpr int RAW_SLOTS = 3;
  static constexpr int EP_STRIDE = 72;              // bf16 per row of an epilogue tile [o][row]
  static constexpr int EP_BYTES = N_TILE * EP_STRIDE * 2;  // 9,216 per warpgroup
  struct Frag {
    uint32_t r[4];
  };
  static __device__ __forceinline__ void load(Frag& a, uint32_t addr) { ldmatrix_x4(a.r, addr); }
  static __device__ __forceinline__ void mma(float (&d)[32], const Frag& a, uint32_t w) {
    wgmma_m64n64k16_bf16(d, a.r, b_desc(w));
  }
  static __device__ __forceinline__ T pack(float v, int) { return __float2bfloat16_rn(v); }
};

struct Tf32 {
  using T = float;
  static constexpr int W_PARTS = 2;                 // w_hi, then w_lo
  static constexpr int RAW_SLOTS = 2;
  static constexpr int EP_BYTES = 0;                // stores from registers
  struct Frag {
    uint32_t hi[4], lo[4];
  };
  static __device__ __forceinline__ void load(Frag& a, uint32_t addr) {
    uint32_t v[4];
    ldmatrix_x4(v, addr);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a.hi[e] = tf32_rna(__uint_as_float(v[e]));
      a.lo[e] = tf32_rna(__uint_as_float(v[e]) - __uint_as_float(a.hi[e]));
    }
  }
  static __device__ __forceinline__ void mma(float (&d)[32], const Frag& a, uint32_t w) {
    const uint64_t w_hi = b_desc(w), w_lo = b_desc(w + W_PART_BYTES);
    wgmma_m64n64k8_tf32(d, a.lo, w_hi);
    wgmma_m64n64k8_tf32(d, a.hi, w_lo);
    wgmma_m64n64k8_tf32(d, a.hi, w_hi);
  }
  static __device__ __forceinline__ T pack(float v, int part) {
    const float hi = __uint_as_float(tf32_rna(v));
    return part == 0 ? hi : __uint_as_float(tf32_rna(v - hi));
  }
};

template <class P>
struct Layout {
  static constexpr int EPV = 16 / sizeof(typename P::T);  // elements per 16 bytes
  static constexpr int CC = CHUNK_BYTES / sizeof(typename P::T);  // channels per chunk: 32 or 16
  static constexpr int W_ELEMS = P::W_PARTS * TAPS * CC * N_TILE;  // one packed (O-tile, chunk) slice
  static constexpr int W_BYTES = P::W_PARTS * W_PART_BYTES;
  static constexpr int W_OFF = P::RAW_SLOTS * RAW_BYTES;
  static constexpr int STRIP_OFF = W_OFF + W_SLOTS * W_BYTES;
  static constexpr int EP_OFF = STRIP_OFF + 2 * STRIP_BYTES;
  static constexpr int BAR_OFF = EP_OFF + CONSUMER_WGS * P::EP_BYTES;
  static constexpr int SMEM_BYTES = BAR_OFF + 2 * (P::RAW_SLOTS + W_SLOTS) * 8;
  static_assert(SMEM_BYTES <= 232448, "a block has at most 227 KB of shared memory on an H100");
};

struct Tile {
  int b, ot, p0, nl, npos;
  int half;  // -1: the whole tile; 0 or 1: row tiles 0-2 or 3-5 of it, one per warpgroup
};

__device__ __forceinline__ Tile tile_of(const Geometry& g, int t) {
  Tile tl;
  tl.half = -1;
  if (t >= g.full) {  // the last wave: each tile as two halves on two SMs
    tl.half = (t - g.full) & 1;
    t = g.full + ((t - g.full) >> 1);
  }
  tl.b = t / (g.n_ot * g.n_lt);
  const int r = t - tl.b * (g.n_ot * g.n_lt);
  const int lt = r / g.n_ot;
  tl.ot = r - lt * g.n_ot;  // O-tiles of one line tile are neighbours: x is reused from L2
  tl.p0 = lt * g.n_lines;
  tl.nl = min(g.n_lines, g.P - tl.p0);
  tl.npos = tl.nl * g.L;
  return tl;
}

// First row of row tile m of warpgroup wg (64 rows each), or -1 where it has none.
__device__ __forceinline__ int row_tile(const Tile& tl, int wg, int m) {
  const int r = tl.half < 0 ? (wg * M_SLOTS + m) * 64 : (m == 0 ? (tl.half * CONSUMER_WGS + wg) * 64 : tl.npos);
  return r < tl.npos ? r : -1;
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

// Offset of position q of a tile within its (b, o) plane.
__device__ __forceinline__ int plane_offset(const Geometry& g, const Tile& tl, int q) {
  if (g.axis_h && tl.nl != g.P) {
    int line, l;
    split(g, tl.nl, q, line, l);
    return (tl.p0 + line) * g.sp + l * g.sl;
  }
  return tl.p0 * g.L + q;  // a tile of whole lines along W, or all the lines, is one run
}

// One 16-byte strip group: channels c0 .. c0 + EPV - 1 of position q, zeros past cv.
template <class T>
__device__ __forceinline__ uint4 gather16(const T* src, int rs, int c0, int cv) {
  uint32_t v[4];
  if constexpr (sizeof(T) == 2) {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 2 * e;
      const uint32_t lo = c < cv ? s[2 * e * rs] : 0u;
      const uint32_t hi = c + 1 < cv ? s[(2 * e + 1) * rs] : 0u;
      v[e] = lo | (hi << 16);
    }
  } else {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = c0 + e < cv ? s[e * rs] : 0u;
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// wp[ot][ch][part][k][c/EPV][o][c%EPV] = part of w[ot*64 + o, ch*CC + c, k], zeros outside (O, C)
template <class P>
__device__ __forceinline__ void pack_weights(const typename P::T* __restrict__ w, typename P::T* __restrict__ wp,
                                             int C, int O, int n_ch, int total) {
  using L = Layout<P>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int e = i % L::EPV;
  const int o = (i / L::EPV) % N_TILE;
  int r = i / (L::EPV * N_TILE);
  const int cg = r % CG;
  r /= CG;
  const int k = r % TAPS;
  r /= TAPS;
  const int part = r % P::W_PARTS;
  r /= P::W_PARTS;
  const int ch = r % n_ch;
  const int ot = r / n_ch;
  const int oo = ot * N_TILE + o;
  const int cc = ch * L::CC + cg * L::EPV + e;
  const float v = (oo < O && cc < C) ? to_f32(w[((size_t)oo * C + cc) * TAPS + k]) : 0.f;
  wp[i] = P::pack(v, part);
}

template <class P>
__device__ __forceinline__ void sepconv7_body(const typename P::T* __restrict__ x, const typename P::T* __restrict__ wp,
                                              typename P::T* __restrict__ out, Geometry g) {
  using T = typename P::T;
  using L = Layout<P>;
  constexpr int RAW_SLOTS = P::RAW_SLOTS;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t raw_full = base + L::BAR_OFF;            // RAW_SLOTS: raw slice landed
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
    reinterpret_cast<uint4*>(smem + L::STRIP_OFF)[i] = make_uint4(0, 0, 0, 0);
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
          mbar_arrive_expect_tx(w_full + 8 * ws, L::W_BYTES);
          bulk_copy(base + L::W_OFF + ws * L::W_BYTES, wp + ((size_t)tl.ot * g.n_ch + ch) * L::W_ELEMS, L::W_BYTES,
                    w_full + 8 * ws);
        }
        const int s = it % RAW_SLOTS;
        mbar_wait(raw_empty + 8 * s, ((it / RAW_SLOTS) & 1) ^ 1);
        const uint32_t raw = base + s * RAW_BYTES;
        const uint32_t bar = raw_full + 8 * s;
        const int c0 = ch * L::CC;
        const int cv = min(L::CC, g.C - c0);
        const T* xc = x + ((size_t)tl.b * g.C + c0) * g.plane;
        const bool whole = tl.nl == g.P;
        const uint32_t run_bytes = (uint32_t)tl.npos * sizeof(T);  // one channel's positions
        // bulk copies need 16-byte aligned sources and sizes
        bool bulk;
        if (whole) {
          bulk = ((reinterpret_cast<uintptr_t>(xc) | (cv * run_bytes)) & 15) == 0;
        } else if (!g.axis_h) {
          const T* src = xc + (size_t)min(lane, cv - 1) * g.plane + (size_t)tl.p0 * g.L;
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
            bulk_copy(raw + lane * g.rs * sizeof(T), xc + (size_t)lane * g.plane + (size_t)tl.p0 * g.L, run_bytes,
                      bar);
          }
        } else {
          T* dst = reinterpret_cast<T*>(smem + s * RAW_BYTES);
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
    // ldmatrix.x4 row address of this lane for each 64-row slot, tap 0, the k-step's first
    // 32 bytes: lanes 0-7 rows 0-7, lanes 8-15 rows 8-15 (bytes 0-15), lanes 16-31 again
    // (bytes 16-31)
    uint32_t arow[M_SLOTS];
    bool active[M_SLOTS];
#pragma unroll
    for (int m = 0; m < M_SLOTS; ++m) {
      const int row0 = row_tile(tl, wg, m);
      active[m] = row0 >= 0;  // uniform over the warpgroup
      int q = row0 + wwarp * 16 + (lane & 15);
      if (q >= tl.npos) q = 0;  // a row past the tile reads a real row; its result is dropped
      arow[m] = strip_row(g, tl.nl, q) * ROW_BYTES + (lane >> 4) * 16;
    }
    // this thread's share of each chunk's transpose, the same for every chunk of the tile:
    // item u moves 16 bytes of channels of one position from raw [c][q] to its strip row
    int t_src[T_ITEMS], t_dst[T_ITEMS];  // t_dst < 0: no item
#pragma unroll
    for (int u = 0; u < T_ITEMS; ++u) {
      const int i = tid + u * CONSUMERS;
      const int cg = i / tl.npos;
      const int q = i - cg * tl.npos;
      t_src[u] = cg * L::EPV * g.rs + q;
      t_dst[u] = i < CG * tl.npos ? (strip_row(g, tl.nl, q) + HALF) * ROW_BYTES + cg * 16 : -1;
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
      const uint32_t strip = base + L::STRIP_OFF + (it & 1) * STRIP_BYTES;
      mbar_wait(raw_full + 8 * s, (it / RAW_SLOTS) & 1);
      {  // transpose raw [c][q] into strip rows [line][l + 3][c]; channels past C are zeros
        const T* raw = reinterpret_cast<const T*>(smem + s * RAW_BYTES);
        unsigned char* dst = smem + L::STRIP_OFF + (it & 1) * STRIP_BYTES;
        const int cv = min(L::CC, g.C - ch * L::CC);
#pragma unroll
        for (int u = 0; u < T_ITEMS; ++u)
          if (t_dst[u] >= 0)  // the 16-byte group's first channel, from its place in the row
            *reinterpret_cast<uint4*>(dst + t_dst[u]) =
                gather16(raw + t_src[u], g.rs, t_dst[u] % ROW_BYTES / 16 * L::EPV, cv);
      }
      mbar_arrive(raw_empty + 8 * s);  // the raw slot may be refilled
      if (ch > 0) {  // the previous chunk's wgmma have retired: its weight slot may be refilled
        wgmma_wait<0>();
        mbar_arrive(w_empty + 8 * prev);
      }
      named_sync(BAR_CONSUMERS, CONSUMERS);  // the strip is complete
      mbar_wait(w_full + 8 * ws, (it / W_SLOTS) & 1);

      const uint32_t wst = base + L::W_OFF + ws * L::W_BYTES;
      typename P::Frag a[2][M_SLOTS];
#pragma unroll
      for (int ks = 0; ks < K_STEPS; ++ks) {
#pragma unroll
        for (int k = 0; k < TAPS; ++k) {
          const int step = ks * TAPS + k;
          const int p = step & 1;
          if (step >= 2) wgmma_wait<1>();  // the group that read a[p] has retired
#pragma unroll
          for (int m = 0; m < M_SLOTS; ++m)
            if (active[m]) P::load(a[p][m], strip + arow[m] + k * ROW_BYTES + ks * 32);
          wgmma_fence();
          const uint32_t wk = wst + (k * CG + 2 * ks) * N_TILE * 16;
#pragma unroll
          for (int m = 0; m < M_SLOTS; ++m)
            if (active[m]) P::mma(acc[m], a[p][m], wk);
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

    // accumulator i of a lane: row wwarp*16 + lane/4 + 8*((i >> 1) & 1), output 8*(i >> 2) + 2*(lane % 4) + (i & 1)
    const int o0 = tl.ot * N_TILE;
    if constexpr (P::EP_BYTES > 0) {
      // each 64x64 tile through shared memory [o][row], then runs of each (b, o) plane
      T* ep = reinterpret_cast<T*>(smem + L::EP_OFF + wg * P::EP_BYTES);
#pragma unroll
      for (int m = 0; m < M_SLOTS; ++m) {
        if (!active[m]) continue;
        named_sync(BAR_WG0 + wg, 128);  // the previous tile's readers are done
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = wwarp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
          const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          ep[col * P::EP_STRIDE + row] = P::pack(acc[m][i], 0);
        }
        named_sync(BAR_WG0 + wg, 128);
        const int row0 = row_tile(tl, wg, m);
        for (int o = wwarp; o < N_TILE && o0 + o < g.O; o += 4) {
          T* plane = out + ((size_t)tl.b * g.O + o0 + o) * g.plane;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = lane + 32 * h;
            const int q = row0 + r;
            if (q < tl.npos) plane[plane_offset(g, tl, q)] = ep[o * P::EP_STRIDE + r];
          }
        }
      }
    } else {
      // straight from registers: per store, 8 lanes write 8 consecutive rows of one plane
#pragma unroll
      for (int m = 0; m < M_SLOTS; ++m) {
        if (!active[m]) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = row_tile(tl, wg, m) + wwarp * 16 + (lane >> 2) + 8 * h;
          if (q >= tl.npos) continue;
          T* at = out + ((size_t)tl.b * g.O + o0) * g.plane + plane_offset(g, tl, q);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int o = 8 * j + 2 * (lane & 3) + e;
              if (o0 + o < g.O) at[(size_t)o * g.plane] = acc[m][4 * j + 2 * h + e];
            }
        }
      }
    }
  }
}

__global__ void pack_weights_bf16_kernel(const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ wp, int C,
                                         int O, int n_ch, int total) {
  pack_weights<Bf16>(w, wp, C, O, n_ch, total);
}

__global__ void pack_weights_tf32_kernel(const float* __restrict__ w, float* __restrict__ wp, int C, int O, int n_ch,
                                         int total) {
  pack_weights<Tf32>(w, wp, C, O, n_ch, total);
}

__global__ void __launch_bounds__(THREADS, 1)
sepconv7_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                     __nv_bfloat16* __restrict__ out, Geometry g) {
  sepconv7_body<Bf16>(x, wp, out, g);
}

__global__ void __launch_bounds__(THREADS, 1)
sepconv7_tf32_kernel(const float* __restrict__ x, const float* __restrict__ wp, float* __restrict__ out, Geometry g) {
  sepconv7_body<Tf32>(x, wp, out, g);
}

template <class P>
cudaError_t launch(void (*pack)(const typename P::T*, typename P::T*, int, int, int, int),
                   void (*kernel)(const typename P::T*, const typename P::T*, typename P::T*, Geometry),
                   const typename P::T* x, const typename P::T* w, typename P::T* wp, typename P::T* out, int B, int C,
                   int H, int W, int O, int axis, cudaStream_t stream) {
  using L = Layout<P>;
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
  g.n_ch = (C + L::CC - 1) / L::CC;
  // a whole plane is one contiguous run per chunk; a cut one keeps 16-byte aligned channels
  g.rs = g.n_lines == g.P ? g.plane : (g.n_lines * g.L + 7) / 8 * 8;
  g.tiles = B * g.n_ot * g.n_lt;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = std::min(g.tiles, sms);
  // a last wave that would leave most SMs idle runs as half tiles, if they fit one wave
  const int tail = g.tiles % grid;
  g.full = g.tiles;
  if (tail > 0 && 2 * tail <= grid) {
    g.full = g.tiles - tail;
    g.tiles += tail;
  }

  const int packed = g.n_ot * g.n_ch * L::W_ELEMS;
  pack<<<(packed + 255) / 256, 256, 0, stream>>>(w, wp, C, O, g.n_ch, packed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, L::SMEM_BYTES, stream>>>(x, wp, out, g);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// ---- host entry (plain C interface, bound with ctypes) ----
// x (B, C, H, W), w (O, C, 7) and out (B, O, H, W), contiguous, all of one dtype:
// dtype 0 = float32, 1 = bfloat16. axis 3 = W (1x7), 2 = H (7x1). `wpack` is scratch for the
// packed weights, in x's dtype: ceil(O/64) * ceil(C/32) * 7 * 32 * 64 bfloat16 values, or
// ceil(O/64) * ceil(C/16) * 2 * 7 * 16 * 64 float32 values (hi and lo parts).
// Returns cudaGetLastError() after the launches.
extern "C" int sepconv7_launch(const void* x, const void* w, void* wpack, void* out, int B, int C, int H, int W,
                               int O, int axis, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0 || (axis != 2 && axis != 3)) return cudaErrorInvalidValue;
  if (wpack == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tc::launch<tc::Tf32>(tc::pack_weights_tf32_kernel, tc::sepconv7_tf32_kernel, static_cast<const float*>(x),
                                static_cast<const float*>(w), static_cast<float*>(wpack), static_cast<float*>(out), B,
                                C, H, W, O, axis, s);
  if (dtype == 1)
    return tc::launch<tc::Bf16>(tc::pack_weights_bf16_kernel, tc::sepconv7_bf16_kernel,
                                static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                                static_cast<__nv_bfloat16*>(wpack), static_cast<__nv_bfloat16*>(out), B, C, H, W, O,
                                axis, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the kernel for a dtype (0 = float32, 1 = bfloat16), for
// reports (ptxas does not see it); -1 for another code.
extern "C" int sepconv7_smem_bytes(int dtype) {
  if (dtype == 0) return tc::Layout<tc::Tf32>::SMEM_BYTES;
  if (dtype == 1) return tc::Layout<tc::Bf16>::SMEM_BYTES;
  return -1;
}
