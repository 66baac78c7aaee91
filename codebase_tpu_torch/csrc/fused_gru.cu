// The port's hand-written kernels for Hopper (sm_90a), built by nvcc into
// one shared library with a plain C interface and loaded with ctypes
// (codebase_tpu_torch/ops/kernel_lib.py). Three families:
// - gru_*: the fused GRU recurrence over a whole sequence, forward and
//   backward (ops/fused_gru.py);
// - grouped_dw*: the weight gradient of the grouped f32 Linear products
//   (ops/grouped_dw.py);
// - grouped_mm*: the forward and input gradient of those products, with
//   the bias in the epilogue (ops/grouped_mm.py).
// The two long-K weight-gradient kernels, gru_dw_kernel and
// grouped_dw_kernel, run one pipeline (dw_pipeline), each with a policy of
// its own for what differs. The families after the GRU's replace no TPU
// kernel (XLA forms those products there); their sections are at the end.
//
// The GRU family replaces the TPU kernels of codebase_tpu/ops/fused_gru.py:
//   gru_fwd_kernel    <- _fwd_kernel (body :80-102, launched by
//                        _fused_gru_fwd_impl :225-264)
//   gru_bwd_kernel    <- _bwd_kernel (body :105-168, launched by
//                        _fused_gru_bwd :274-332): the reverse-time recurrence
//   gru_dw_kernel     <- its dW_hh/db_hh products (:160-165), taken out of
//                        the recurrence as one long-K product (wgmma, TMA)
//   gru_reduce_kernel <- its in-order dW_hh/db_hh accumulation (:123-126,
//                        :166-167), which on the TPU is race-free only
//                        because grid steps run in order.
//
// Function (torch gate order [r, z, n]), per group g and batch row b:
//   gh  = h_{t-1} @ W_hh + b_hh
//   r   = sigmoid(gi_r + gh_r),  z = sigmoid(gi_z + gh_z)
//   n   = tanh(gi_n + r * gh_n), h_t = (1 - z) * n + z * h_{t-1}
// gi = x @ W_ih + b_ih is computed outside (one large matmul).
//
// gru_fwd_kernel. What bounds it on an H100 (H = 128): its bytes (gi, h0,
// y, hT: 403 MB at the rollout shape G=2 T=1 B=65536, 0.12 ms at 3.35 TB/s)
// hide under the work of each 16-row tile, which is the limit at both shapes:
// three mma.sync products per k8 step, the splits of W_hh's fragments into
// TF32 parts (redone for every tile: split W_hh would not fit in shared
// memory), and the gates. At the update shape (G=2 T=26 B=1024) that work
// also forms a serial chain of 26 dependent steps per tile. Three TF32
// products at the 495 TFLOP/s peak would take 0.08 ms at the rollout shape;
// that peak needs wgmma, whose B operand must sit in shared memory, so the
// split W_hh would have to fit there. Design:
// - W_hh (192 KB f32) is staged once per block into shared memory, laid out
//   in the order of the m16n8k8 B fragments (one conflict-free 16-byte load
//   per fragment pair), and read from there at every step;
// - h @ W_hh runs on tensor cores (mma.sync m16n8k8, TF32) in 3xTF32: each
//   operand is split into big = tf32(x) and small = x - big, and
//   small*big + big*small + big*big is accumulated in f32, which keeps the
//   result at f32 level (single-pass TF32 keeps about 3 digits). Each
//   16-deep slice of k is summed in a fresh MMA accumulator and added to the
//   running sum with an f32 add, so the tensor core's truncating
//   accumulation never runs over more than 6 products;
// - warp w owns hidden units [16w, 16w+16) as two blocks of 8, i.e. n-tiles
//   {c, H+c, 2H+c} for its unit blocks c: one thread's accumulators hold r,
//   z and n of the same (row, unit), so the gates are applied in registers
//   with no exchange through shared memory. gi is loaded for exactly those
//   positions before the product, so its latency hides under the MMAs; the
//   gates of all a thread's positions are computed branch-free before any
//   store, so they interleave;
// - the h tile (16 rows x 128, row stride 144 floats: conflict-free A loads)
//   stays in shared memory across all T steps; h' goes to it and to y;
// - persistent grid: about one block per SM, each walking 16-row tiles of
//   its group (62 at the rollout shape, one at the update shape, so that
//   every SM carries a chain); the next tile's h0 is loaded under the last
//   step's product.
//
// gru_bwd_kernel, the reverse-time recurrence. Per group, row and step t
// (from T - 1 down): rematerialise gh = h_prev @ W_hh + b_hh and the gates
// from h_prev = h0 || y[:-1] and gi (the TPU design's trade of flops for
// bytes); dh_total = dy + dh; dgi = [dr, dz, dn] and dgh = [dr, dz, dn * r];
// dh <- dh_total * z + dgh @ W_hh^T. Bound on an H100 by the work of each
// 16-row step, on the SM: two 3xTF32 products (288 mma.sync per warp each),
// the TF32 splits of W_hh's fragments, redone every step, and the gates; at
// the update shape these form a serial chain of T steps on every SM (0.095
// ms for the whole backward's products at the TF32 peak, which needs
// wgmma). Interleaving the next step's gates with this step's dh product,
// which leaves one product on the chain, was measured slower: the step is
// bound by the SM's throughput, not by the chain's latency. Design:
// - the forward's grid, tiles, warp ownership and 3xTF32 product;
// - W_hh (192 KB) staged once per block, in the forward's B-fragment order
//   with an XOR swizzle (bwd_slot) under which both of its readings are
//   conflict-free: float4 fragment pairs for h_prev @ W_hh, and four scalars
//   from one row of W_hh for dgh @ W_hh^T, whose B operand is W_hh^T;
// - the h_prev tile (stride 144) and the dgh tile (16 x 3H, stride 400: 16
//   mod 32, conflict-free A loads) in the remaining 35 KB of shared memory;
//   gi and dy are loaded into registers at the accumulator positions;
// - dgh @ W_hh^T has its output fragments on the (row, unit) positions of
//   the gates, so dh stays in registers across steps;
// - it writes dgi, dh0 and dgh_n = dn * r (the one part of dgh that dgi
//   does not hold) for the weight gradient; dW_hh is off the chain.
//
// gru_dw_kernel, the weight gradient: dW_hh[g] = sum_k h_prev[k]^T dgh[k]
// and db_hh[g] = sum_k dgh[k] over the K = T * B rows, one kernel for every
// H. What could bound it on an H100: the 3xTF32 products (2.95 ms at G=10 T=121
// B=256 H=512 at the 495 TFLOP/s TF32 peak; its bytes, 2.5 GB, take 0.76
// ms) and the stream of h_prev and dgh out of the L2 into every block, for
// every tile of dW_hh: G * tiles * K * (128 + 192) * 4 bytes, 12.7 GB there.
// Design (dw_pipeline's, which grouped_dw_kernel shares):
// - tiles of 128 x 192 (two consumer warpgroups of 64 rows; 192 divides 3H
//   at every H the kernels take), each over a share of K's stages of 32
//   rows (ops/fused_gru.py dw_tiling: P blocks a tile, so that the grid
//   fills whole waves and no block sums more than DW_MAX_STAGES stages);
// - a producer warpgroup (one thread issues; setmaxnreg hands its
//   registers to the consumers) brings each stage by TMA into a ring of
//   three fp32 stages behind mbarriers: 4 + 6 boxes of 32 x 32 floats under the
//   128-byte swizzle, h_prev's rows from h0 or y, dgh's from dgi or dgh_n;
//   a stage never straddles h0 and y, and each tensor map ends where its
//   segment does, so the ragged edges read as zeros with no branch;
// - wgmma takes TF32 from shared memory only K-major, and both operands
//   are M- or N-contiguous in device memory. So A = h_prev^T comes from
//   registers (each thread reads its fragment from the fp32 stage and
//   splits it once per warpgroup; the tile's rows are permuted so that the
//   reads are conflict-free under the box swizzle), and B = dgh from a
//   split pass: the consumers read each staged dgh value once per block and
//   write its TF32 big and small parts K-major (128-byte rows, the swizzle
//   the descriptor names) into one of two buffer pairs, under the previous
//   stage's products, and read the next stage's A fragments into a second
//   register set there too. Per k8 step three m64n192k8 wgmma: small * big,
//   big * small, big * big, into one f32 accumulator a block;
// - the accumulator's error grows with the stages it sums (about 2.4e-7
//   of the largest entry a stage on an H100 80GB HBM3 at 700 W,
//   kernel_bench --dw-stages), so the split bounds a block's share;
// - db_hh: the split pass sums its staged dgh values (valid rows only) in
//   the blocks of the first row of tiles, added in a fixed order; no
//   atomics, two calls are bitwise equal.
// A 128 x 384 tile (two n192 products a k8 step) would cut the stream by a
// fifth but needs 192 accumulators a thread beside the A fragments. On an
// H100 80GB HBM3 at 700 W (kernel_bench against copies of the kernel) a
// stage takes about 2 us, in proportion to the shared-memory bytes it
// moves (wgmma's B reads, the split pass, TMA's writes, the A reads): with
// no split pass 68% of the time, with no products 46%, with no A reads 98%;
// the L2 stream is not the limit (the grid's order made no difference).
//
// gru_reduce_kernel. Bound by bytes: it reads the P partials once (16 per
// group at the update shape, 6.3 MB, 0.002 ms at 3.35 TB/s). One thread per
// column sums its P values in order p = 0, 1, ...: deterministic, no
// atomics. Read from
// HBM on an H100 (80GB HBM3, 700 W) it runs at two thirds of that rate with
// 64 partials, as torch.sum does; 16-byte loads with more of them in flight
// were measured 4% faster there and not kept.
//
// gru_fwd_wide_kernel and gru_bwd_wide_kernel: the same two functions at
// any H % 128 == 0 from 256 to kMaxH (the TPU kernel takes any H % 128 ==
// 0 that fits its VMEM budget). W_hh is H x 3H x 4 bytes, 768 KB at H=256
// and 3 MB at H=512: it does not fit the 227 KB of shared memory a block
// can have. Both walk the hidden units in chunks of 128 (8 warps x 2 unit
// blocks of 8, the H=128 kernels' warp ownership): one thread's
// accumulators hold r, z and n of the same (row, unit), so the gates stay
// in registers; the k order inside a 16-deep slice is permuted as in the
// H=128 kernels.
//
// gru_fwd_wide_kernel. What bounds it on an H100: the stream of W_hh out
// of the L2 (50 MB; the ten copies of the MMM2 update at G=10 take 30 MB)
// into each block at every step, G * ceil(B / R) * 12H^2 bytes a step for
// row tiles of R rows, and the 3xTF32 mma.sync work (2.95 ms of
// operations at G=10 T=121 B=256 H=512, at the TF32 peak). Its first
// design read all of W_hh from the L2 for each 16-row tile at every step,
// fragment by fragment, and moved that stream at about 1.9 TB/s. Design:
// - R = 16, 32 or 64 rows a block (a template parameter: R / 16 m-tiles);
//   the host picks R and, at T=1, a split of the hidden units across
//   blocks (ops/fused_gru.py wide_forward_tiling);
// - W_hh goes through shared memory in stages of one 16-deep k slice of
//   one unit chunk's r, z and n columns (16 x 384 floats), copied by
//   16-byte cp.async into a ring of two stages (deeper rings measured
//   slower), in the order (step, chunk, slice), so the copies run ahead
//   across chunk and step boundaries; each stage is read once per block,
//   and each B fragment is read and split into TF32 parts once for all R
//   rows, the products of several n-tiles issued interleaved;
// - each warp copies, waits for and reads only its own 48 columns of a
//   stage, so the warps meet once a step (for the h tile) rather than once
//   a stage, and one warp's gates overlap another's products;
// - the columns are XOR-swizzled by row (wide_stage_at), so the B-fragment
//   reads (four rows, one column per lane) are conflict-free;
// - the h tile (R x H, stride H + 16) is double-buffered when T > 1, since
//   every chunk of a step reads all of h; it arrives with the first stage;
// - at T=1 the grid's y axis runs over unit chunks: one block forms one
//   chunk of a row tile (no block needs another's h), which fills the card
//   at small batches and lets a large batch take R = 64;
// - gi of a chunk is prefetched into the L2 when its product starts and
//   read into registers after it.
//
// gru_bwd_wide_kernel. What bounds it on an H100: the same two streams
// as the forward's, twice a step (W_hh for h_prev @ W_hh and again for
// dgh @ W_hh^T: G * ceil(B / R) * 24H^2 bytes a step out of the L2), and
// twice the forward's 3xTF32 mma.sync work (5.91 ms of operations at G=10
// T=121 B=256 H=512, at the TF32 peak). Its first design read all of W_hh
// from the L2 twice a step for each 16-row tile, fragment by fragment, and
// kept the whole dgh tile (16 x 3H) in shared memory. Design:
// - R = 16 or 32 rows a block (a template parameter), one block an SM,
//   picked by the host (ops/fused_gru.py wide_backward_tiling): 32 where
//   16-row tiles would need a second wave, else 16, whose chain is shorter;
// - both products read W_hh from the forward's warp-private ring of
//   cp.async stages: each stage is read once per block for R rows. A
//   chunk's gh stages are the forward's (a 16-deep slice of its r, z and n
//   columns); its dh stages hold the rows of W_hh (units) of the warp's
//   16 units of one unit chunk by 48 of the summed chunk's 384 columns
//   (dh_stage_at), the same size, so one ring carries both in the order
//   (step, chunk, gh slices, dh stages);
// - dh is summed one unit chunk at a time: after the gates of chunk uc,
//   its dgh columns (R x 384, kDghStride) sit in shared memory and their
//   share dgh[:, cols(uc)] @ W_hh[:, cols(uc)]^T is added to dh_{t-1} over
//   all H units. Only that chunk's dgh is held, so the shared memory does
//   not grow with 3H: R=32 fits at every H up to kMaxH. dh_{t-1} is summed
//   in device memory, each thread at its own positions (dgh_n[t - 1], which
//   step t - 1 reads before it overwrites it, or dh0);
// - the h_prev tile (R x H, stride H + 16) is copied under the last
//   chunk's dh product; gi, dy and dh_t of a chunk are prefetched into the
//   L2 when its product starts.
// Rows past the batch edge are masked inside the kernels; there is no
// padding of time or batch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <array>
#include <tuple>

namespace {

constexpr int kH = 128;       // hidden size of the resident-W_hh kernels
constexpr int kH3 = 3 * kH;
// the wide kernels' largest H: where the first wide backward, which held the whole
// dgh tile, filled shared memory; the tiles of both wide kernels now leave
// room at 896 (ops/fused_gru.py MAX_HIDDEN)
constexpr int kMaxH = 896;

// the forward's gate: branch-free (division by a 2-ulp reciprocal, no
// IEEE slow path), so a thread's gates interleave
__device__ __forceinline__ float gru_gate(float gr, float gz, float gn, float ar, float az,
                                          float an, float hp) {
  const float r = __fdividef(1.f, 1.f + expf(-(gr + ar)));
  const float z = __fdividef(1.f, 1.f + expf(-(gz + az)));
  const float n = tanhf(gn + r * an);
  return (1.f - z) * n + z * hp;
}

// ---------------------------------------------------------------------------
// Forward: tensor cores, 3xTF32, W_hh resident in shared memory
// ---------------------------------------------------------------------------

constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdRows = 16;                    // rows per tile: one m16 MMA tile
constexpr int kUnitBlocks = kH / 8;             // blocks of 8 hidden units (one n-tile each)
constexpr int kUB = kUnitBlocks / kFwdWarps;    // unit blocks per warp
constexpr int kNJ = 3 * kUB;                    // n-tiles per warp: r, z, n of each unit block
constexpr int kKPairs = kH / 16;                // k walked 16 at a time: two k8 MMA steps
constexpr int kNTiles = kH3 / 8;                // n-tiles of 8 columns
constexpr int kHS = 144;                        // h tile row stride in floats (16 mod 32)
constexpr int kWFloats = kH * kH3;
constexpr int kH0Vecs = kFwdRows * kH / 4 / kFwdThreads;  // float4 of an h0 tile per thread
constexpr size_t kFwdSmem = (size_t)(kWFloats + kFwdRows * kHS) * sizeof(float);

// x = big + small: big is x rounded to TF32 (10 mantissa bits, to nearest,
// ties away from zero, as cvt.rna.tf32.f32 does), small = x - big exactly;
// the tensor core reads the top 19 bits of small (TF32 by truncation).
// Integer and FP32 adds instead of cvt, whose conversion pipe runs at a
// quarter of their rate.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a (16x8, row-major) * b (8x8, col-major); TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A 16-row tile of a (B, H) matrix m in registers: float4 i = threadIdx.x +
// k * kFwdThreads holds row r0 + i / 32, columns 4 * (i % 32) .. +3; rows
// past B are zero.
__device__ __forceinline__ void load_rows(float4 (&v)[kH0Vecs], const float* __restrict__ m, int B,
                                          int r0) {
#pragma unroll
  for (int k = 0; k < kH0Vecs; ++k) {
    const int i = threadIdx.x + k * kFwdThreads;
    const int row = r0 + i / 32;
    v[k] = row < B ? __ldg(reinterpret_cast<const float4*>(m + (size_t)row * kH) + i % 32)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void store_h0_tile(float* hs, const float4 (&v)[kH0Vecs]) {
#pragma unroll
  for (int k = 0; k < kH0Vecs; ++k) {
    const int i = threadIdx.x + k * kFwdThreads;
    *reinterpret_cast<float4*>(hs + (i / 32) * kHS + 4 * (i % 32)) = v[k];
  }
}

// A fragments of both k8 steps of a 16-deep slice, split into TF32 parts,
// from two float4: lo holds row gid, hi row gid + 8, each at k = 4tig + 0..3
// of the slice (k8 step 0 takes + 0, + 1; step 1 + 2, + 3). The B fragments
// hold the same k order, so the permutation inside the slice cancels.
__device__ __forceinline__ void split_a(const float4& lo, const float4& hi, uint32_t (&ab)[2][4],
                                        uint32_t (&as)[2][4]) {
  split_tf32(lo.x, ab[0][0], as[0][0]);
  split_tf32(hi.x, ab[0][1], as[0][1]);
  split_tf32(lo.y, ab[0][2], as[0][2]);
  split_tf32(hi.y, ab[0][3], as[0][3]);
  split_tf32(lo.z, ab[1][0], as[1][0]);
  split_tf32(hi.z, ab[1][1], as[1][1]);
  split_tf32(lo.w, ab[1][2], as[1][2]);
  split_tf32(hi.w, ab[1][3], as[1][3]);
}

// B fragments of both k8 steps from B[4tig + 0..3, gid] of the slice
__device__ __forceinline__ void split_b(float x0, float x1, float x2, float x3, uint32_t (&bb)[2][2],
                                        uint32_t (&bs)[2][2]) {
  split_tf32(x0, bb[0][0], bs[0][0]);
  split_tf32(x1, bb[0][1], bs[0][1]);
  split_tf32(x2, bb[1][0], bs[1][0]);
  split_tf32(x3, bb[1][1], bs[1][1]);
}

// part += a * b over one 16-deep slice in 3xTF32: small*big, big*small,
// big*big of both k8 steps
__device__ __forceinline__ void mma_3xtf32_slice(float (&part)[4], const uint32_t (&ab)[2][4],
                                                 const uint32_t (&as)[2][4],
                                                 const uint32_t (&bb)[2][2],
                                                 const uint32_t (&bs)[2][2]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    mma_tf32(part, as[ks], bb[ks]);
    mma_tf32(part, ab[ks], bs[ks]);
    mma_tf32(part, ab[ks], bb[ks]);
  }
}

// acc += h @ W_hh at this thread's n-tiles j (gate j % 3 of unit block
// warp * kUB + j / 3): h a 16-row tile at stride kHS in shared memory, ws
// W_hh in B-fragment order, where the lane's fragment pair of n-tile nt sits
// at slot[nt & 1] (nt & 1 == j / 3). Each 16-deep slice of k is summed in a
// fresh accumulator and added to acc in f32.
__device__ __forceinline__ void hw_product(float (&acc)[kNJ][4], const float* hs, const float4* ws,
                                           int warp, int lane, const int (&slot)[2]) {
  static_assert(kUB == 2 && kUnitBlocks % 2 == 0, "slot[] is indexed by j / 3");
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll 2
  for (int kp = 0; kp < kKPairs; ++kp) {
    const float4 lo = *reinterpret_cast<const float4*>(hs + gid * kHS + kp * 16 + 4 * tig);
    const float4 hi = *reinterpret_cast<const float4*>(hs + (gid + 8) * kHS + kp * 16 + 4 * tig);
    uint32_t ab[2][4], as[2][4];
    split_a(lo, hi, ab, as);
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int nt = (j % 3) * kUnitBlocks + warp * kUB + j / 3;
      const float4 wv = ws[(kp * kNTiles + nt) * 32 + slot[j / 3]];
      uint32_t bb[2][2], bs[2][2];
      split_b(wv.x, wv.y, wv.z, wv.w, bb, bs);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32_slice(part, ab, as, bb, bs);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += part[i];
    }
  }
}

// grid (blocks per group, G), kFwdThreads threads, kFwdSmem bytes of dynamic
// shared memory. Block x of group g walks the row tiles x, x + gridDim.x, ...
// Its product is written out here rather than through hw_product: the
// shared version measured 3% slower on an H100.
__global__ void __launch_bounds__(kFwdThreads, 1)
gru_fwd_kernel(const float* __restrict__ gi, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ hT, int T, int B) {
  extern __shared__ __align__(16) float smem[];
  float4* ws = reinterpret_cast<float4*>(smem);  // W_hh in B-fragment order
  float* hs = smem + kWFloats;                   // (kFwdRows, kHS) h tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;     // MMA fragment row group, thread in group
  const int g = blockIdx.y;
  const int n_tiles = (B + kFwdRows - 1) / kFwdRows;
  int tile = blockIdx.x;
  if (tile >= n_tiles) return;

  // ws[(kp * kNTiles + nt) * 32 + lane] = W[16kp + 4tig + {0..3}, 8nt + gid]:
  // the B fragments (b0, b1) of both k8 steps of slice kp, for n-tile nt.
  // The A fragments read h[., 16kp + 4tig + {0..3}] to match, so the k
  // order inside a slice is permuted identically on both sides.
  const float* w = w_hh + (size_t)g * kWFloats;
  for (int s = tid; s < kKPairs * kNTiles * 32; s += kFwdThreads) {
    const int l = s & 31, nt = (s >> 5) % kNTiles, kp = s / (32 * kNTiles);
    const float* src = w + (size_t)(kp * 16 + (l & 3) * 4) * kH3 + nt * 8 + (l >> 2);
    ws[s] = make_float4(__ldg(src), __ldg(src + kH3), __ldg(src + 2 * kH3), __ldg(src + 3 * kH3));
  }

  // this thread's columns: gate q of unit block cu = warp * kUB + u is
  // n-tile q * kUnitBlocks + cu (j = 3u + q); its accumulator columns are
  // 2tig, 2tig + 1, of rows gid (entries 0, 1) and gid + 8 (entries 2, 3)
  float bias[kNJ][2];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int col = (j % 3) * kH + (warp * kUB + j / 3) * 8 + 2 * tig;
    bias[j][0] = __ldg(b_hh + g * kH3 + col);
    bias[j][1] = __ldg(b_hh + g * kH3 + col + 1);
  }

  float4 h0v[kH0Vecs];
  const float* h0g = h0 + (size_t)g * B * kH;
  load_rows(h0v, h0g, B, tile * kFwdRows);
  store_h0_tile(hs, h0v);
  __syncthreads();

  for (; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * kFwdRows;
    const int next = tile + gridDim.x;
    for (int t = 0; t < T; ++t) {
      const size_t base = ((size_t)g * T + t) * B;
      // this step's gi at the accumulator positions (and, at the last
      // step, the next tile's h0): issued before the product to hide latency
      float2 gv[2][kNJ];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + gid + 8 * half;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int col = (j % 3) * kH + (warp * kUB + j / 3) * 8 + 2 * tig;
          gv[half][j] = row < B ? __ldg(reinterpret_cast<const float2*>(gi + (base + row) * kH3 + col))
                                : make_float2(0.f, 0.f);
        }
      }
      const bool last = t == T - 1;
      if (last && next < n_tiles) load_rows(h0v, h0g, B, next * kFwdRows);

      // gh = b_hh + h @ W_hh. Each 16-deep slice of k is summed in a fresh
      // accumulator (small*big, big*small, big*big of both k8 steps) and
      // added to acc in f32.
      float acc[kNJ][4];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        acc[j][0] = acc[j][2] = bias[j][0];
        acc[j][1] = acc[j][3] = bias[j][1];
      }
#pragma unroll 2
      for (int kp = 0; kp < kKPairs; ++kp) {
        // A fragments of both k8 steps: a0/a2 from row gid, a1/a3 from row
        // gid + 8; k = 16kp + 4tig + {0, 1} for step 0, + {2, 3} for step 1
        const float4 lo = *reinterpret_cast<const float4*>(hs + gid * kHS + kp * 16 + 4 * tig);
        const float4 hi = *reinterpret_cast<const float4*>(hs + (gid + 8) * kHS + kp * 16 + 4 * tig);
        uint32_t ab[2][4], as[2][4];
        split_tf32(lo.x, ab[0][0], as[0][0]);
        split_tf32(hi.x, ab[0][1], as[0][1]);
        split_tf32(lo.y, ab[0][2], as[0][2]);
        split_tf32(hi.y, ab[0][3], as[0][3]);
        split_tf32(lo.z, ab[1][0], as[1][0]);
        split_tf32(hi.z, ab[1][1], as[1][1]);
        split_tf32(lo.w, ab[1][2], as[1][2]);
        split_tf32(hi.w, ab[1][3], as[1][3]);
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int nt = (j % 3) * kUnitBlocks + warp * kUB + j / 3;
          const float4 wv = ws[(kp * kNTiles + nt) * 32 + lane];
          uint32_t bb[2][2], bs[2][2];
          split_tf32(wv.x, bb[0][0], bs[0][0]);
          split_tf32(wv.y, bb[0][1], bs[0][1]);
          split_tf32(wv.z, bb[1][0], bs[1][0]);
          split_tf32(wv.w, bb[1][1], bs[1][1]);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            mma_tf32(part, as[ks], bb[ks]);
            mma_tf32(part, ab[ks], bs[ks]);
            mma_tf32(part, ab[ks], bb[ks]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += part[i];
        }
      }

      // the gates at this thread's positions, all computed before any store
      // so that they interleave
      float2 hn[2][kUB];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int u = 0; u < kUB; ++u) {
          const float2 hp = *reinterpret_cast<const float2*>(
              hs + (gid + 8 * half) * kHS + (warp * kUB + u) * 8 + 2 * tig);
          const float2 gr = gv[half][3 * u], gz = gv[half][3 * u + 1], gn = gv[half][3 * u + 2];
          const int c = 2 * half;
          hn[half][u].x = gru_gate(gr.x, gz.x, gn.x, acc[3 * u][c], acc[3 * u + 1][c],
                                   acc[3 * u + 2][c], hp.x);
          hn[half][u].y = gru_gate(gr.y, gz.y, gn.y, acc[3 * u][c + 1], acc[3 * u + 1][c + 1],
                                   acc[3 * u + 2][c + 1], hp.y);
        }
      __syncthreads();  // every read of the tile is done

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lr = gid + 8 * half;
        const int row = r0 + lr;
#pragma unroll
        for (int u = 0; u < kUB; ++u) {
          const int unit = (warp * kUB + u) * 8 + 2 * tig;
          if (row < B) {
            *reinterpret_cast<float2*>(y + (base + row) * kH + unit) = hn[half][u];
            if (last) *reinterpret_cast<float2*>(hT + ((size_t)g * B + row) * kH + unit) = hn[half][u];
          }
          if (!last) *reinterpret_cast<float2*>(hs + lr * kHS + unit) = hn[half][u];
        }
      }
      if (last && next < n_tiles) store_h0_tile(hs, h0v);
      __syncthreads();  // the tile holds the next step's (or tile's) h
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, kernel 1: the reverse-time recurrence (tensor cores, 3xTF32,
// W_hh resident in shared memory)
// ---------------------------------------------------------------------------

constexpr int kDgS = 400;          // dgh tile row stride in floats (16 mod 32)
constexpr int kKPairsT = kH3 / 16;  // dgh @ W_hh^T walks k over 3H, 16 at a time
constexpr size_t kBwdSmem = (size_t)(kWFloats + kFwdRows * (kHS + kDgS)) * sizeof(float);

// The backward's W_hh layout: the forward's B-fragment order with bits 1-2
// of the slot (the lane whose fragment pair it holds) XORed with bit 4 of
// the slot and bit 0 of the n-tile. The float4 reads of h_prev @ W_hh stay
// conflict-free (the XOR permutes the slots inside each group of 8); the
// scalar reads of dgh @ W_hh^T, which take four consecutive columns of one
// row of W_hh, become conflict-free (in the forward's order four lanes
// share a bank). The map is its own inverse.
__device__ __forceinline__ int bwd_slot(int slot, int nt) {
  return slot ^ ((((slot >> 4) & 1) | ((nt & 1) << 1)) << 1);
}

// float index of W_hh[r, c] in that layout
__device__ __forceinline__ int bwd_w_index(int r, int c) {
  const int nt = c >> 3;
  const int slot = (c & 7) * 4 + ((r >> 2) & 3);
  return (((r >> 4) * kNTiles + nt) * 32 + bwd_slot(slot, nt)) * 4 + (r & 3);
}

// The gates' backward at one (row, unit), from gi (xr, xz, xn), gh with
// b_hh (ar, az, an), h_prev and dh_total = dy + dh: the pre-activation
// gradients dgi = [dr, dz, dn] and dgh = [dr, dz, dgn], and carry =
// dh_total * z, the direct path to dh_{t-1}. Branch-free, as the forward.
__device__ __forceinline__ void gru_gate_bwd(float xr, float xz, float xn, float ar, float az,
                                             float an, float hp, float dht, float& dr, float& dz,
                                             float& dn, float& dgn, float& carry) {
  const float r = __fdividef(1.f, 1.f + expf(-(xr + ar)));
  const float z = __fdividef(1.f, 1.f + expf(-(xz + az)));
  const float n = tanhf(xn + r * an);
  dn = dht * (1.f - z) * (1.f - n * n);
  dgn = dn * r;
  dr = dn * an * r * (1.f - r);
  dz = dht * (hp - n) * z * (1.f - z);
  carry = dht * z;
}

// this thread's (row, unit) positions of a (B, H) matrix m: rows r0 + gid
// (half 0) and r0 + gid + 8 (half 1), units (warp * kUB + u) * 8 + 2tig, +1;
// rows past B read as zero
__device__ __forceinline__ void load_positions(float2 (&v)[2][kUB], const float* __restrict__ m,
                                               int B, int r0, int warp, int gid, int tig) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + gid + 8 * half;
#pragma unroll
    for (int u = 0; u < kUB; ++u) {
      const int unit = (warp * kUB + u) * 8 + 2 * tig;
      v[half][u] = row < B ? __ldg(reinterpret_cast<const float2*>(m + (size_t)row * kH + unit))
                           : make_float2(0.f, 0.f);
    }
  }
}

// h_prev at step t of group g as a (B, H) matrix: h0[g] at t == 0, else y[g, t - 1]
__device__ __forceinline__ const float* h_prev_at(const float* __restrict__ h0,
                                                  const float* __restrict__ y, int g, int T, int B,
                                                  int t) {
  return t == 0 ? h0 + (size_t)g * B * kH : y + ((size_t)g * T + t - 1) * B * kH;
}

// grid (blocks per group, G), kFwdThreads threads, kBwdSmem bytes of dynamic
// shared memory. Block x of group g walks the row tiles x, x + gridDim.x, ...
// in reverse time. Writes dgi (G, T, B, 3H), dh0 (G, B, H) and dgh_n =
// dn * r (G, T, B, H), the one part of dgh that dgi does not hold, for
// gru_dw_kernel.
__global__ void __launch_bounds__(kFwdThreads, 1)
gru_bwd_kernel(const float* __restrict__ gi, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, const float* __restrict__ h0,
               const float* __restrict__ y, const float* __restrict__ dy,
               const float* __restrict__ dhT, float* __restrict__ dgi,
               float* __restrict__ dh0, float* __restrict__ dgh_n, int T, int B) {
  extern __shared__ __align__(16) float smem[];
  float4* ws = reinterpret_cast<float4*>(smem);  // W_hh, see bwd_slot
  float* hs = smem + kWFloats;                   // (kFwdRows, kHS) h_prev tile
  float* ds = hs + kFwdRows * kHS;               // (kFwdRows, kDgS) dgh tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = blockIdx.y;
  const int n_tiles = (B + kFwdRows - 1) / kFwdRows;
  int tile = blockIdx.x;
  if (tile >= n_tiles) return;

  const float* w = w_hh + (size_t)g * kWFloats;
  for (int s = tid; s < kKPairs * kNTiles * 32; s += kFwdThreads) {
    const int nt = (s >> 5) % kNTiles, kp = s / (32 * kNTiles);
    const int l = bwd_slot(s & 31, nt);
    const float* src = w + (size_t)(kp * 16 + (l & 3) * 4) * kH3 + nt * 8 + (l >> 2);
    ws[s] = make_float4(__ldg(src), __ldg(src + kH3), __ldg(src + 2 * kH3), __ldg(src + 3 * kH3));
  }
  const int slot[2] = {bwd_slot(lane, 0), bwd_slot(lane, 1)};
  // dgh @ W_hh^T: the B fragments of output n-tile warp * kUB + u are rows
  // 8 * (warp * kUB + u) + gid of W_hh, columns 4tig + i of k slice 0; slice
  // kp adds 16 columns, 256 floats in the layout
  int wt[kUB][4];
#pragma unroll
  for (int u = 0; u < kUB; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) wt[u][i] = bwd_w_index(8 * (warp * kUB + u) + gid, 4 * tig + i);
  float bias[kNJ][2];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int col = (j % 3) * kH + (warp * kUB + j / 3) * 8 + 2 * tig;
    bias[j][0] = __ldg(b_hh + g * kH3 + col);
    bias[j][1] = __ldg(b_hh + g * kH3 + col + 1);
  }

  float4 hv[kH0Vecs];
  load_rows(hv, h_prev_at(h0, y, g, T, B, T - 1), B, tile * kFwdRows);
  store_h0_tile(hs, hv);
  float2 dh[2][kUB], dh_next[2][kUB] = {};
  load_positions(dh, dhT + (size_t)g * B * kH, B, tile * kFwdRows, warp, gid, tig);
  __syncthreads();

  for (; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * kFwdRows;
    const int next = tile + gridDim.x;
    for (int t = T - 1; t >= 0; --t) {
      const size_t base = ((size_t)g * T + t) * B;
      // this step's gi and dy at the accumulator positions, then the next
      // (tile, step)'s h_prev and, at a tile's last step, the next tile's
      // dhT: issued before the product to hide their latency
      float2 gv[2][kNJ];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + gid + 8 * half;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int col = (j % 3) * kH + (warp * kUB + j / 3) * 8 + 2 * tig;
          gv[half][j] = row < B ? __ldg(reinterpret_cast<const float2*>(gi + (base + row) * kH3 + col))
                                : make_float2(0.f, 0.f);
        }
      }
      float2 dyv[2][kUB];
      load_positions(dyv, dy + base * kH, B, r0, warp, gid, tig);
      const bool more = t > 0 || next < n_tiles;
      if (t > 0) {
        load_rows(hv, h_prev_at(h0, y, g, T, B, t - 1), B, r0);
      } else if (next < n_tiles) {
        load_rows(hv, h_prev_at(h0, y, g, T, B, T - 1), B, next * kFwdRows);
        load_positions(dh_next, dhT + (size_t)g * B * kH, B, next * kFwdRows, warp, gid, tig);
      }

      // gh = b_hh + h_prev @ W_hh (the forward's product)
      float acc[kNJ][4];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        acc[j][0] = acc[j][2] = bias[j][0];
        acc[j][1] = acc[j][3] = bias[j][1];
      }
      hw_product(acc, hs, ws, warp, lane, slot);

      // the gates' backward at this thread's positions, all computed before
      // any store so that they interleave
      float2 d_r[2][kUB], d_z[2][kUB], d_n[2][kUB], d_gn[2][kUB], carry[2][kUB];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int u = 0; u < kUB; ++u) {
          const float2 hp = *reinterpret_cast<const float2*>(
              hs + (gid + 8 * half) * kHS + (warp * kUB + u) * 8 + 2 * tig);
          const float2 xr = gv[half][3 * u], xz = gv[half][3 * u + 1], xn = gv[half][3 * u + 2];
          const float2 dht = make_float2(dyv[half][u].x + dh[half][u].x, dyv[half][u].y + dh[half][u].y);
          const int c = 2 * half;
          gru_gate_bwd(xr.x, xz.x, xn.x, acc[3 * u][c], acc[3 * u + 1][c], acc[3 * u + 2][c], hp.x,
                       dht.x, d_r[half][u].x, d_z[half][u].x, d_n[half][u].x, d_gn[half][u].x,
                       carry[half][u].x);
          gru_gate_bwd(xr.y, xz.y, xn.y, acc[3 * u][c + 1], acc[3 * u + 1][c + 1],
                       acc[3 * u + 2][c + 1], hp.y, dht.y, d_r[half][u].y, d_z[half][u].y,
                       d_n[half][u].y, d_gn[half][u].y, carry[half][u].y);
        }
      // rows past B hold zeros throughout (their gi, dy, dh and h_prev are
      // zero), so their dgh adds nothing to dh; only their stores are masked
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lr = gid + 8 * half;
        const int row = r0 + lr;
#pragma unroll
        for (int u = 0; u < kUB; ++u) {
          const int unit = (warp * kUB + u) * 8 + 2 * tig;
          if (row < B) {
            float* dgir = dgi + (base + row) * kH3 + unit;
            *reinterpret_cast<float2*>(dgir) = d_r[half][u];
            *reinterpret_cast<float2*>(dgir + kH) = d_z[half][u];
            *reinterpret_cast<float2*>(dgir + 2 * kH) = d_n[half][u];
            *reinterpret_cast<float2*>(dgh_n + (base + row) * kH + unit) = d_gn[half][u];
          }
          *reinterpret_cast<float2*>(ds + lr * kDgS + unit) = d_r[half][u];
          *reinterpret_cast<float2*>(ds + lr * kDgS + kH + unit) = d_z[half][u];
          *reinterpret_cast<float2*>(ds + lr * kDgS + 2 * kH + unit) = d_gn[half][u];
        }
      }
      __syncthreads();  // the dgh tile is complete; every read of the h_prev tile is done
      if (more) store_h0_tile(hs, hv);

      // dh_{t-1} = dh_total * z + dgh @ W_hh^T. Its output fragments fall on
      // the same (row, unit) positions, so dh stays in registers.
      float dacc[kUB][4] = {};
#pragma unroll 2
      for (int kp = 0; kp < kKPairsT; ++kp) {
        const float4 lo = *reinterpret_cast<const float4*>(ds + gid * kDgS + kp * 16 + 4 * tig);
        const float4 hi = *reinterpret_cast<const float4*>(ds + (gid + 8) * kDgS + kp * 16 + 4 * tig);
        uint32_t ab[2][4], as[2][4];
        split_a(lo, hi, ab, as);
        const float* wk = smem + kp * 256;
#pragma unroll
        for (int u = 0; u < kUB; ++u) {
          uint32_t bb[2][2], bs[2][2];
          split_b(wk[wt[u][0]], wk[wt[u][1]], wk[wt[u][2]], wk[wt[u][3]], bb, bs);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32_slice(part, ab, as, bb, bs);
#pragma unroll
          for (int i = 0; i < 4; ++i) dacc[u][i] += part[i];
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int u = 0; u < kUB; ++u)
          dh[half][u] = make_float2(carry[half][u].x + dacc[u][2 * half],
                                    carry[half][u].y + dacc[u][2 * half + 1]);
      if (t == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + gid + 8 * half;
#pragma unroll
          for (int u = 0; u < kUB; ++u) {
            const int unit = (warp * kUB + u) * 8 + 2 * tig;
            if (row < B) *reinterpret_cast<float2*>(dh0 + ((size_t)g * B + row) * kH + unit) = dh[half][u];
            dh[half][u] = dh_next[half][u];
          }
        }
      }
      __syncthreads();  // before the next step writes the tiles
    }
  }
}

// ---------------------------------------------------------------------------
// Wide variants (256 <= H <= kMaxH, H % 128 == 0): W_hh streamed through shared memory
// ---------------------------------------------------------------------------

constexpr int kChunk = 8 * kUB * kFwdWarps;  // hidden units per pass: 128

// a 16-row tile of a (B, H) matrix m into shared memory at row stride s;
// rows past B are zero
__device__ __forceinline__ void load_tile_wide(float* hs, int s, const float* __restrict__ m, int B,
                                               int r0, int H) {
  const int q = H / 4;
  for (int i = threadIdx.x; i < kFwdRows * q; i += kFwdThreads) {
    const int rr = i / q, c = i % q, row = r0 + rr;
    *reinterpret_cast<float4*>(hs + rr * s + 4 * c) =
        row < B ? __ldg(reinterpret_cast<const float4*>(m + (size_t)row * H) + c)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// first column of this thread's n-tile j (gate j % 3 of unit block
// uc * 16 + warp * kUB + j / 3) in a row of a (., 3H) matrix
__device__ __forceinline__ int wide_col(int j, int H, int uc, int warp) {
  return (j % 3) * H + uc * kChunk + (warp * kUB + j / 3) * 8;
}

// acc += h @ W_hh at this thread's n-tiles of unit chunk uc: h a 16-row
// tile at stride s in shared memory, W_hh (H, 3H) row-major in global
// memory. Each 16-deep slice of k in a fresh accumulator, added in f32.
__device__ __forceinline__ void wide_product(float (&acc)[kNJ][4], const float* hs, int s,
                                             const float* __restrict__ w, int H, int uc, int warp,
                                             int lane) {
  const int gid = lane >> 2, tig = lane & 3, H3 = 3 * H;
  int col[kNJ];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) col[j] = wide_col(j, H, uc, warp) + gid;
  const float* wl = w + (size_t)(4 * tig) * H3;
#pragma unroll 2
  for (int kp = 0; kp < H / 16; ++kp) {
    const float4 lo = *reinterpret_cast<const float4*>(hs + gid * s + kp * 16 + 4 * tig);
    const float4 hi = *reinterpret_cast<const float4*>(hs + (gid + 8) * s + kp * 16 + 4 * tig);
    uint32_t ab[2][4], as[2][4];
    split_a(lo, hi, ab, as);
    const float* wk = wl + (size_t)(kp * 16) * H3;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const float* src = wk + col[j];
      uint32_t bb[2][2], bs[2][2];
      split_b(__ldg(src), __ldg(src + H3), __ldg(src + 2 * H3), __ldg(src + 3 * H3), bb, bs);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32_slice(part, ab, as, bb, bs);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += part[i];
    }
  }
}

// acc starts at b_hh, at this thread's columns of unit chunk uc
__device__ __forceinline__ void wide_bias(float (&acc)[kNJ][4], const float* __restrict__ b, int H,
                                          int uc, int warp, int tig) {
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(b + wide_col(j, H, uc, warp) + 2 * tig));
    acc[j][0] = acc[j][2] = v.x;
    acc[j][1] = acc[j][3] = v.y;
  }
}

// gi (B rows of 3H at `rows`) at this thread's accumulator positions of
// unit chunk uc; rows past B read as zero
__device__ __forceinline__ void wide_gi(float2 (&gv)[2][kNJ], const float* __restrict__ rows, int B,
                                        int r0, int H, int uc, int warp, int gid, int tig) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + gid + 8 * half;
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      gv[half][j] = row < B ? __ldg(reinterpret_cast<const float2*>(
                                  rows + (size_t)row * 3 * H + wide_col(j, H, uc, warp) + 2 * tig))
                            : make_float2(0.f, 0.f);
  }
}

// unit of this thread's position u in unit chunk uc
__device__ __forceinline__ int wide_unit(int uc, int warp, int u, int tig) {
  return uc * kChunk + (warp * kUB + u) * 8 + 2 * tig;
}

// The wide forward's W_hh stages: one 16-deep slice of k (rows 16kp .. +15
// of W_hh) of one unit chunk's r, z and n columns, in 8 parts, one a warp:
// the 48 columns of its own 16 units (r, z and n), 16 rows at a stride of
// 52 floats. 26 KB a stage.
constexpr int kWideWarpCols = 3 * 8 * kUB;
constexpr int kWideWarpStride = kWideWarpCols + 4;
constexpr int kWideWarpFloats = 16 * kWideWarpStride;
constexpr int kWideStageFloats = kFwdWarps * kWideWarpFloats;
constexpr int kWideStages = 2;  // the ring: deeper rings measured slower on an H100 (PERF.md)
constexpr size_t kSmemPerBlock = 232448;  // the most dynamic shared memory an H100 block can have

// float offset of (row k, column c) in a warp's part of a stage: bit 3 of
// the column XORed with bit 3 of the row. The B fragments read rows 4tig +
// i at column base + gid (base a multiple of 8): at a stride of 52 floats
// rows 4 apart lie 16 banks apart, and the XOR moves tig 2 and 3 by 8, so
// the 32 lanes fall on 32 banks. A 16-byte copy of 4 columns stays
// contiguous, and the XOR keeps every column below 48.
__device__ __forceinline__ int wide_stage_at(int k, int c) {
  return k * kWideWarpStride + (c ^ (((k >> 3) & 1) << 3));
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// the forward's dynamic shared memory: the h tile (double-buffered when
// T > 1: every chunk of a step reads all of h), then the ring
__host__ __device__ __forceinline__ size_t wide_fwd_smem(int T, int H, int rows) {
  return ((size_t)(T > 1 ? 2 : 1) * rows * (H + 16) + (size_t)kWideStages * kWideStageFloats) * sizeof(float);
}

// grid (ceil(B / kR), units, G), kFwdThreads threads, wide_fwd_smem(T, H,
// kR) bytes of dynamic shared memory; kR = 16 * kM rows a block.
// units == 1: block (x, 0, g) runs row tile x of group g over all T steps
// and all unit chunks. units == H / kChunk (T == 1 only): block (x, y, g)
// forms unit chunk y alone (a single step needs no other block's h).
// W_hh stages run through a ring of kWideStages buffers in the order (t,
// chunk, kp): stage q + 1 is copied while stage q is summed, across chunk
// and step boundaries (W_hh does not depend on h). Each warp copies and
// reads only its own part of each stage, so it waits for its own copies
// alone (__syncwarp); the block meets once a step, for the h tile.
template <int kM>
__global__ void __launch_bounds__(kFwdThreads, kM == 1 ? 2 : 1)
gru_fwd_wide_kernel(const float* __restrict__ gi, const float* __restrict__ w_hh,
                    const float* __restrict__ b_hh, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ hT, int T, int B, int H) {
  constexpr int kR = 16 * kM;
  extern __shared__ __align__(16) float smem[];
  const int s = H + 16;  // 16 mod 32: conflict-free A loads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = blockIdx.z, r0 = blockIdx.x * kR;
  const int H3 = 3 * H, KS = H / 16;
  const int chunks = gridDim.y == 1 ? H / kChunk : 1;  // this block's unit chunks, from uc0
  const int uc0 = gridDim.y == 1 ? 0 : blockIdx.y;
  const float* w = w_hh + (size_t)g * H * H3;
  const float* bg = b_hh + (size_t)g * H3;
  const float* h0g = h0 + (size_t)g * B * H;
  float* hbuf[2] = {smem, smem + kR * s};
  float* ring = smem + (T > 1 ? 2 : 1) * kR * s;

  // the next stage to copy (this warp's part): its index, slice and chunk
  const long long n_stages = (long long)T * chunks * KS;
  long long iq = 0;
  int ikp = 0, ic = 0, wslot = 0;
  float* ring_w = ring + warp * kWideWarpFloats;
  auto issue = [&]() {
    if (iq < n_stages) {
      float* dst = ring_w + wslot * kWideStageFloats;
      const float* src = w + (size_t)(ikp * 16) * H3 + (uc0 + ic) * kChunk + warp * 8 * kUB;
#pragma unroll
      for (int r = 0; r < 16 * kWideWarpCols / 4 / 32; ++r) {
        const int i = lane + 32 * r;
        const int k = i / (kWideWarpCols / 4), c = 4 * (i % (kWideWarpCols / 4));
        // column c: gate c / 16, unit c % 16 of the warp's 16
        cp_async16(dst + wide_stage_at(k, c), src + (size_t)k * H3 + (c / 16) * H + c % 16, true);
      }
      ++iq;
      if (++ikp == KS) {
        ikp = 0;
        if (++ic == chunks) ic = 0;
      }
      if (++wslot == kWideStages) wslot = 0;
    }
    cp_async_commit();
  };
  static_assert(16 * kWideWarpCols % (4 * 32) == 0, "a warp's part is whole 16-byte copies per lane");

  // group 0: the h0 tile (rows past B zero-filled) and stage 0
  for (int i = tid; i < kR * (H / 4); i += kFwdThreads) {
    const int rr = i / (H / 4), c = 4 * (i % (H / 4)), row = r0 + rr;
    cp_async16(hbuf[0] + rr * s + c, row < B ? h0g + (size_t)row * H + c : h0g, row < B);
  }
  for (int q = 0; q < kWideStages - 1; ++q) issue();

  // this thread's B-fragment offsets in the warp's part of a stage: rows
  // 4tig + 0..3 at the column of n-tile j (gate j % 3 of the warp's unit
  // block j / 3)
  int wcol[kNJ];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) wcol[j] = wide_stage_at(4 * tig, (j % 3) * 8 * kUB + (j / 3) * 8 + gid);

  cp_async_wait<0>();  // the h0 tile and the first stages
  int rslot = 0;
  for (int t = 0; t < T; ++t) {
    const size_t base = ((size_t)g * T + t) * B;
    const float* hs = hbuf[t & 1];
    float* hn_s = hbuf[(t & 1) ^ 1];
    const bool last = t == T - 1;
    // the h tile is whole (h0's copies, or every warp's gates of step
    // t - 1), and no warp still reads the buffer this step writes
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      const int uc = uc0 + c;
      // this warp's gi of the chunk (r, z, n of its 16 units: 3 x 64
      // bytes a row) into the L2; read after the product
      for (int i = lane; i < kR * 3; i += 32) {
        const int row = r0 + i / 3;
        if (row < B) prefetch_l2(gi + (base + row) * H3 + (i % 3) * H + uc * kChunk + warp * 8 * kUB);
      }
      float acc[kM][kNJ][4];
#pragma unroll
      for (int m = 0; m < kM; ++m) wide_bias(acc[m], bg, H, uc, warp, tig);

      for (int kp = 0; kp < KS; ++kp) {
        // the warp's part of stage q has landed, and every lane is done
        // with stage q - 1, whose buffer the copy of stage q + kWideStages
        // - 1 takes
        cp_async_wait<kWideStages - 2>();
        __syncwarp();
        issue();
        const float* ws = ring_w + rslot * kWideStageFloats;
        if (++rslot == kWideStages) rslot = 0;

        // A fragments of all kM m-tiles (rows 16m + gid, + 8), split once
        uint32_t ab[kM][2][4], as[kM][2][4];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          const float* hr = hs + (16 * m + gid) * s + kp * 16 + 4 * tig;
          split_a(*reinterpret_cast<const float4*>(hr), *reinterpret_cast<const float4*>(hr + 8 * s),
                  ab[m], as[m]);
        }
        // each B fragment (rows 4tig + 0..3 of the slice, the column of
        // n-tile j) is read and split once and serves all kM m-tiles. The
        // products of kJG n-tiles are issued interleaved, each accumulator
        // taking the order of mma_3xtf32_slice (so the sums are the same):
        // all six n-tiles at kR = 16, two at 32 and 64 (six there take
        // 250-255 registers and measured slower on an H100, PERF.md).
        constexpr int kJG = kM == 1 ? kNJ : 2;
#pragma unroll
        for (int j0 = 0; j0 < kNJ; j0 += kJG) {
          uint32_t bb[kJG][2][2], bs[kJG][2][2];
#pragma unroll
          for (int jj = 0; jj < kJG; ++jj) {
            const float* wc = ws + wcol[j0 + jj];
            split_b(wc[0], wc[kWideWarpStride], wc[2 * kWideWarpStride], wc[3 * kWideWarpStride], bb[jj], bs[jj]);
          }
          float part[kM][kJG][4] = {};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
            for (int jj = 0; jj < kJG; ++jj)
#pragma unroll
              for (int m = 0; m < kM; ++m) mma_tf32(part[m][jj], as[m][ks], bb[jj][ks]);
#pragma unroll
            for (int jj = 0; jj < kJG; ++jj)
#pragma unroll
              for (int m = 0; m < kM; ++m) mma_tf32(part[m][jj], ab[m][ks], bs[jj][ks]);
#pragma unroll
            for (int jj = 0; jj < kJG; ++jj)
#pragma unroll
              for (int m = 0; m < kM; ++m) mma_tf32(part[m][jj], ab[m][ks], bb[jj][ks]);
          }
#pragma unroll
          for (int jj = 0; jj < kJG; ++jj)
#pragma unroll
            for (int m = 0; m < kM; ++m)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[m][j0 + jj][i] += part[m][jj][i];
        }
      }

      // the gates at this thread's positions of every m-tile
      float2 gv[kM][2][kNJ];
#pragma unroll
      for (int m = 0; m < kM; ++m) wide_gi(gv[m], gi + base * H3, B, r0 + 16 * m, H, uc, warp, gid, tig);
#pragma unroll
      for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int lr = 16 * m + gid + 8 * half, row = r0 + lr;
          const int cc = 2 * half;
#pragma unroll
          for (int u = 0; u < kUB; ++u) {
            const int unit = wide_unit(uc, warp, u, tig);
            const float2 hp = *reinterpret_cast<const float2*>(hs + lr * s + unit);
            const float2 gr = gv[m][half][3 * u], gz = gv[m][half][3 * u + 1], gn = gv[m][half][3 * u + 2];
            float2 hn;
            hn.x = gru_gate(gr.x, gz.x, gn.x, acc[m][3 * u][cc], acc[m][3 * u + 1][cc], acc[m][3 * u + 2][cc],
                            hp.x);
            hn.y = gru_gate(gr.y, gz.y, gn.y, acc[m][3 * u][cc + 1], acc[m][3 * u + 1][cc + 1],
                            acc[m][3 * u + 2][cc + 1], hp.y);
            // the next step's tile: a buffer no chunk of this step reads;
            // the next step reads it after its barrier
            if (!last) *reinterpret_cast<float2*>(hn_s + lr * s + unit) = hn;
            if (row < B) {
              *reinterpret_cast<float2*>(y + (base + row) * H + unit) = hn;
              if (last) *reinterpret_cast<float2*>(hT + ((size_t)g * B + row) * H + unit) = hn;
            }
          }
        }
    }
  }
}

// The wide backward's dh stages: W_hh^T for dgh @ W_hh^T, whose B operand
// is rows of W_hh. A warp's part holds the 16 rows (units) of W_hh whose
// dh it forms in one unit chunk, by 48 of the 384 columns (r, z and n) of
// the chunk whose dgh is summed, at a stride of 48 floats: 768 of the 832
// floats of a part of the forward's layout, so both kinds of stage share
// one ring. The B fragments are float4 reads (row 8u + gid, columns 16sl +
// 4tig .. + 3); a quarter-warp holds two rows, 48 floats (16 banks) apart,
// so its eight 16-byte reads fall on 32 banks. A 16-byte copy of 4
// columns stays contiguous and inside the row.
constexpr int kDhStride = kWideWarpCols;
__device__ __forceinline__ int dh_stage_at(int u, int c) { return u * kDhStride + c; }

// the wide backward's dgh tile: one unit chunk's 384 columns (r, z, n) at a
// stride of 400 floats (16 mod 32: conflict-free A loads)
constexpr int kDghStride = 3 * kChunk + 16;

// the backward's dynamic shared memory: the h_prev tile, the dgh tile of
// one unit chunk and the ring
__host__ __device__ __forceinline__ size_t wide_bwd_smem(int H, int rows) {
  return ((size_t)rows * (H + 16) + (size_t)rows * kDghStride + (size_t)kWideStages * kWideStageFloats) *
         sizeof(float);
}

// grid (ceil(B / kR), G), kFwdThreads threads, wide_bwd_smem(H, kR) bytes
// of dynamic shared memory; kR = 16 * kM rows a block. Block (x, g) runs
// row tile x of group g in reverse time. At step t, for each unit chunk uc
// in turn: gh = b_hh + h_prev @ W_hh at the chunk's columns (the forward's
// stages and product), the gates' backward at this thread's positions
// (dgi and dgh_n out, dgh into the tile), then the chunk's share of
// dh_{t-1}, dgh[:, cols(uc)] @ W_hh[:, cols(uc)]^T, over all H units, one
// unit chunk uc' at a time (8 dh stages each). dh_{t-1} is summed in
// device memory at this thread's own positions, so no other thread reads
// it: in dgh_n[t - 1], which step t - 1 reads before it writes its dgh_n
// there, or in dh0 at t = 0. Its sum at a unit of chunk uc' runs over the
// chunks in order, with dh_total * z added when chunk uc' passes its gates:
// the same operations in the same order for a row whatever the row tile.
// The W_hh stages run through the forward's ring in the order (t, uc, the
// chunk's KS gh stages, its KS = 8 * chunks dh stages), warp-private; the
// block meets twice a chunk, for the dgh tile, and once a step, for the
// h_prev tile, which is copied while the last chunk's dh is summed.
template <int kM>
__global__ void __launch_bounds__(kFwdThreads, 1)
gru_bwd_wide_kernel(const float* __restrict__ gi, const float* __restrict__ w_hh,
                    const float* __restrict__ b_hh, const float* __restrict__ h0,
                    const float* __restrict__ y, const float* __restrict__ dy,
                    const float* __restrict__ dhT, float* __restrict__ dgi,
                    float* __restrict__ dh0, float* __restrict__ dgh_n, int T, int B, int H) {
  constexpr int kR = 16 * kM;
  extern __shared__ __align__(16) float smem[];
  const int s = H + 16;  // 16 mod 32: conflict-free A loads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = blockIdx.y, r0 = blockIdx.x * kR;
  const int H3 = 3 * H, KS = H / 16, chunks = H / kChunk;
  const float* w = w_hh + (size_t)g * H * H3;
  const float* bg = b_hh + (size_t)g * H3;
  const float* yg = y + (size_t)g * T * B * H;
  const float* h0g = h0 + (size_t)g * B * H;
  float* hs = smem;                   // (kR, s) h_prev tile
  float* ds = hs + kR * s;            // (kR, kDghStride) dgh tile of one unit chunk
  float* ring = ds + kR * kDghStride;

  // the next stage to copy (this warp's part): its index, its index in the
  // chunk's gh (phase 0) or dh (phase 1) stages, and the chunk
  const long long n_stages = (long long)T * chunks * 2 * KS;
  long long iq = 0;
  int ii = 0, iph = 0, ic = 0, wslot = 0;
  float* ring_w = ring + warp * kWideWarpFloats;
  auto issue = [&]() {
    if (iq < n_stages) {
      float* dst = ring_w + wslot * kWideStageFloats;
      if (iph == 0) {  // slice ii of chunk ic's r, z, n columns: the forward's stage
        const float* src = w + (size_t)(ii * 16) * H3 + ic * kChunk + warp * 8 * kUB;
#pragma unroll
        for (int r = 0; r < 16 * kWideWarpCols / 4 / 32; ++r) {
          const int i = lane + 32 * r;
          const int k = i / (kWideWarpCols / 4), c = 4 * (i % (kWideWarpCols / 4));
          cp_async16(dst + wide_stage_at(k, c), src + (size_t)k * H3 + (c / 16) * H + c % 16, true);
        }
      } else {  // rows of the warp's 16 units of chunk ii / 8, columns 48 (ii % 8) .. + 47 of chunk ic's 384
        const int kq = ii % 8;
        const float* src = w + (size_t)((ii / 8) * kChunk + warp * 8 * kUB) * H3 + ic * kChunk;
#pragma unroll
        for (int r = 0; r < 16 * kWideWarpCols / 4 / 32; ++r) {
          const int i = lane + 32 * r;
          const int u = i / (kWideWarpCols / 4), c = 4 * (i % (kWideWarpCols / 4));
          const int k = 48 * kq + c;  // column k % 128 of gate k / 128
          cp_async16(dst + dh_stage_at(u, c), src + (size_t)u * H3 + (k / kChunk) * H + k % kChunk, true);
        }
      }
      ++iq;
      if (++ii == KS) {
        ii = 0;
        if (++iph == 2) {
          iph = 0;
          if (++ic == chunks) ic = 0;
        }
      }
      if (++wslot == kWideStages) wslot = 0;
    }
    cp_async_commit();
  };
  // the h_prev tile of step t (h0, or y of step t - 1); rows past B zero-filled
  auto load_h = [&](int t) {
    const float* src = t > 0 ? yg + (size_t)(t - 1) * B * H : h0g;
    for (int i = tid; i < kR * (H / 4); i += kFwdThreads) {
      const int rr = i / (H / 4), c = 4 * (i % (H / 4)), row = r0 + rr;
      cp_async16(hs + rr * s + c, row < B ? src + (size_t)row * H + c : src, row < B);
    }
    cp_async_commit();
  };

  load_h(T - 1);
  for (int q = 0; q < kWideStages - 1; ++q) issue();

  // B-fragment offsets of h_prev @ W_hh, as in the forward
  int wcol[kNJ];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) wcol[j] = wide_stage_at(4 * tig, (j % 3) * 8 * kUB + (j / 3) * 8 + gid);

  int rslot = 0;
  for (int t = T - 1; t >= 0; --t) {
    const size_t base = ((size_t)g * T + t) * B;
    // dh_t (dhT, or summed at step t + 1 into dgh_n[t]) and where dh_{t-1}
    // is summed: (B, H) rows
    const float* dh_cur = t == T - 1 ? dhT + (size_t)g * B * H : dgh_n + base * H;
    float* dh_nx = t > 0 ? dgh_n + (base - B) * H : dh0 + (size_t)g * B * H;
    cp_async_wait<0>();
    __syncthreads();  // the h_prev tile has landed
    for (int uc = 0; uc < chunks; ++uc) {
      // this warp's gi, dy and dh_t of the chunk into the L2; read after the product
      for (int i = lane; i < kR * 5; i += 32) {
        const int row = r0 + i / 5, q = i % 5, col = uc * kChunk + warp * 8 * kUB;
        if (row < B)
          prefetch_l2(q < 3 ? gi + (base + row) * H3 + q * H + col
                            : (q == 3 ? dy + (base + row) * H : dh_cur + (size_t)row * H) + col);
      }
      // gh = b_hh + h_prev @ W_hh at the chunk's columns: the forward's product
      float acc[kM][kNJ][4];
#pragma unroll
      for (int m = 0; m < kM; ++m) wide_bias(acc[m], bg, H, uc, warp, tig);
      for (int kp = 0; kp < KS; ++kp) {
        cp_async_wait<kWideStages - 2>();
        __syncwarp();
        issue();
        const float* ws = ring_w + rslot * kWideStageFloats;
        if (++rslot == kWideStages) rslot = 0;
        uint32_t ab[kM][2][4], as[kM][2][4];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          const float* hr = hs + (16 * m + gid) * s + kp * 16 + 4 * tig;
          split_a(*reinterpret_cast<const float4*>(hr), *reinterpret_cast<const float4*>(hr + 8 * s),
                  ab[m], as[m]);
        }
        constexpr int kJG = kM == 1 ? kNJ : 2;
#pragma unroll
        for (int j0 = 0; j0 < kNJ; j0 += kJG) {
          uint32_t bb[kJG][2][2], bs[kJG][2][2];
#pragma unroll
          for (int jj = 0; jj < kJG; ++jj) {
            const float* wc = ws + wcol[j0 + jj];
            split_b(wc[0], wc[kWideWarpStride], wc[2 * kWideWarpStride], wc[3 * kWideWarpStride], bb[jj], bs[jj]);
          }
          float part[kM][kJG][4] = {};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
            for (int jj = 0; jj < kJG; ++jj)
#pragma unroll
              for (int m = 0; m < kM; ++m) mma_tf32(part[m][jj], as[m][ks], bb[jj][ks]);
#pragma unroll
            for (int jj = 0; jj < kJG; ++jj)
#pragma unroll
              for (int m = 0; m < kM; ++m) mma_tf32(part[m][jj], ab[m][ks], bs[jj][ks]);
#pragma unroll
            for (int jj = 0; jj < kJG; ++jj)
#pragma unroll
              for (int m = 0; m < kM; ++m) mma_tf32(part[m][jj], ab[m][ks], bb[jj][ks]);
          }
#pragma unroll
          for (int jj = 0; jj < kJG; ++jj)
#pragma unroll
            for (int m = 0; m < kM; ++m)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[m][j0 + jj][i] += part[m][jj][i];
        }
      }

      // the gates' backward at this thread's positions: dgi and dgh_n out,
      // dgh into the tile, dh_total * z into dh_{t-1}
      float2 gv[kM][2][kNJ];
#pragma unroll
      for (int m = 0; m < kM; ++m) wide_gi(gv[m], gi + base * H3, B, r0 + 16 * m, H, uc, warp, gid, tig);
      __syncthreads();  // every warp is done with the dgh tile of chunk uc - 1
#pragma unroll
      for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int lr = 16 * m + gid + 8 * half, row = r0 + lr;
          const int cc = 2 * half;
#pragma unroll
          for (int u = 0; u < kUB; ++u) {
            const int unit = wide_unit(uc, warp, u, tig), lu = unit - uc * kChunk;
            const float2 hp = *reinterpret_cast<const float2*>(hs + lr * s + unit);
            float2 dht = make_float2(0.f, 0.f);
            if (row < B) {
              const float2 dyv = __ldg(reinterpret_cast<const float2*>(dy + (base + row) * H + unit));
              const float2 dhv = *reinterpret_cast<const float2*>(dh_cur + (size_t)row * H + unit);
              dht = make_float2(dyv.x + dhv.x, dyv.y + dhv.y);
            }
            const float2 xr = gv[m][half][3 * u], xz = gv[m][half][3 * u + 1], xn = gv[m][half][3 * u + 2];
            float2 d_r, d_z, d_n, d_gn, carry;
            gru_gate_bwd(xr.x, xz.x, xn.x, acc[m][3 * u][cc], acc[m][3 * u + 1][cc], acc[m][3 * u + 2][cc],
                         hp.x, dht.x, d_r.x, d_z.x, d_n.x, d_gn.x, carry.x);
            gru_gate_bwd(xr.y, xz.y, xn.y, acc[m][3 * u][cc + 1], acc[m][3 * u + 1][cc + 1],
                         acc[m][3 * u + 2][cc + 1], hp.y, dht.y, d_r.y, d_z.y, d_n.y, d_gn.y, carry.y);
            // rows past B: dht is zero, so every gradient there is zero
            *reinterpret_cast<float2*>(ds + lr * kDghStride + lu) = d_r;
            *reinterpret_cast<float2*>(ds + lr * kDghStride + kChunk + lu) = d_z;
            *reinterpret_cast<float2*>(ds + lr * kDghStride + 2 * kChunk + lu) = d_gn;
            if (row < B) {
              float* dgir = dgi + (base + row) * H3 + unit;
              *reinterpret_cast<float2*>(dgir) = d_r;
              *reinterpret_cast<float2*>(dgir + H) = d_z;
              *reinterpret_cast<float2*>(dgir + 2 * H) = d_n;
              // dgh_n[t] after dh_t was read from it (same thread, same position)
              *reinterpret_cast<float2*>(dgh_n + (base + row) * H + unit) = d_gn;
              float2* at = reinterpret_cast<float2*>(dh_nx + (size_t)row * H + unit);
              if (uc == 0) {
                *at = carry;
              } else {
                const float2 v = *at;
                *at = make_float2(v.x + carry.x, v.y + carry.y);
              }
            }
          }
        }
      __syncthreads();  // the dgh tile of chunk uc is whole
      // every read of the h_prev tile at step t is done: the next one's copy
      // runs under the last chunk's dh product
      if (uc == chunks - 1 && t > 0) load_h(t - 1);

      // dh_{t-1} += dgh[:, cols(uc)] @ W_hh[:, cols(uc)]^T, one unit chunk
      // ucp of dh at a time, on this thread's (row, unit) positions
      for (int ucp = 0; ucp < chunks; ++ucp) {
        // the first of chunk ucp's terms is written, the rest added to the
        // sum so far, read here so that its latency hides under the product
        const bool first = uc == 0 && ucp > 0;
        float2 sum[kM][2][kUB];
#pragma unroll
        for (int m = 0; m < kM; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = r0 + 16 * m + gid + 8 * half;
#pragma unroll
            for (int u = 0; u < kUB; ++u)
              sum[m][half][u] = first || row >= B ? make_float2(0.f, 0.f)
                  : *reinterpret_cast<const float2*>(dh_nx + (size_t)row * H + wide_unit(ucp, warp, u, tig));
          }
        float dacc[kM][kUB][4] = {};
        for (int kq = 0; kq < 8; ++kq) {
          cp_async_wait<kWideStages - 2>();
          __syncwarp();
          issue();
          const float* ws = ring_w + rslot * kWideStageFloats;
          if (++rslot == kWideStages) rslot = 0;
#pragma unroll
          for (int sl = 0; sl < 3; ++sl) {
            const int kp = 3 * kq + sl;  // 16-deep slice of the chunk's 384 columns
            uint32_t ab[kM][2][4], as[kM][2][4];
#pragma unroll
            for (int m = 0; m < kM; ++m) {
              const float* dr = ds + (16 * m + gid) * kDghStride + kp * 16 + 4 * tig;
              split_a(*reinterpret_cast<const float4*>(dr),
                      *reinterpret_cast<const float4*>(dr + 8 * kDghStride), ab[m], as[m]);
            }
            uint32_t bb[kUB][2][2], bs[kUB][2][2];
#pragma unroll
            for (int u = 0; u < kUB; ++u) {
              const float4 wv = *reinterpret_cast<const float4*>(ws + dh_stage_at(8 * u + gid, 16 * sl + 4 * tig));
              split_b(wv.x, wv.y, wv.z, wv.w, bb[u], bs[u]);
            }
            float part[kM][kUB][4] = {};
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
              for (int u = 0; u < kUB; ++u)
#pragma unroll
                for (int m = 0; m < kM; ++m) mma_tf32(part[m][u], as[m][ks], bb[u][ks]);
#pragma unroll
              for (int u = 0; u < kUB; ++u)
#pragma unroll
                for (int m = 0; m < kM; ++m) mma_tf32(part[m][u], ab[m][ks], bs[u][ks]);
#pragma unroll
              for (int u = 0; u < kUB; ++u)
#pragma unroll
                for (int m = 0; m < kM; ++m) mma_tf32(part[m][u], ab[m][ks], bb[u][ks]);
            }
#pragma unroll
            for (int u = 0; u < kUB; ++u)
#pragma unroll
              for (int m = 0; m < kM; ++m)
#pragma unroll
                for (int i = 0; i < 4; ++i) dacc[m][u][i] += part[m][u][i];
          }
        }
#pragma unroll
        for (int m = 0; m < kM; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = r0 + 16 * m + gid + 8 * half;
            if (row >= B) continue;
#pragma unroll
            for (int u = 0; u < kUB; ++u) {
              const float2 d = make_float2(dacc[m][u][2 * half], dacc[m][u][2 * half + 1]);
              const float2 v = sum[m][half][u];
              *reinterpret_cast<float2*>(dh_nx + (size_t)row * H + wide_unit(ucp, warp, u, tig)) =
                  first ? d : make_float2(v.x + d.x, v.y + d.y);
            }
          }
      }
    }
  }
}

using BwdWideKernel = decltype(&gru_bwd_wide_kernel<1>);

// ---------------------------------------------------------------------------
// Backward, kernel 2: dW_hh = sum_k h_prev[k]^T dgh[k], a long-K product
// (wgmma, 3xTF32, fp32 stages by TMA), on the pipeline grouped_dw_kernel
// shares
// ---------------------------------------------------------------------------

constexpr int kDwK = 32;                   // rows of k a stage: one 128-byte row of TF32 in B
constexpr int kDwM = 128, kDwN = 192;      // a block's tile of dW_hh (H x 3H)
constexpr int kDwBox = 32;                 // columns of a TMA box: 128 bytes, the swizzle's span
constexpr int kDwBoxFloats = kDwK * kDwBox;             // 1024 floats, 4 KB
constexpr int kDwHBoxes = kDwM / kDwBox, kDwGBoxes = kDwN / kDwBox;  // 4 + 6 boxes a stage
constexpr int kDwStageFloats = (kDwHBoxes + kDwGBoxes) * kDwBoxFloats;
constexpr int kDwStageBytes = kDwStageFloats * 4;      // 40 KB
constexpr int kDwStages = 3;                           // the fp32 ring
constexpr int kDwSplitFloats = kDwN * kDwK;            // one TF32 part of B: 192 rows n x 32 k
constexpr int kDwConsumers = 256;                      // two warpgroups: 64 rows of the tile each
constexpr int kDwThreads = kDwConsumers + 128;         // and a producer warpgroup (one thread issues)
constexpr int kDwTasks = kDwN * kDwK / 4 / kDwConsumers;  // split tasks a thread: 6 (n, 4 k)
constexpr size_t kDwBarOffset = (size_t)(kDwStages * kDwStageFloats + 4 * kDwSplitFloats) * 4;
constexpr size_t kDwSmem = kDwBarOffset + 2 * kDwStages * 8 + 1024;  // + slack to align to 1024
// the most stages a run of grouped_dw_kernel sums in its accumulator before
// it is added into the partial (ops/kernel_lib.py DW_MAX_STAGES)
constexpr int kGdwMaxRun = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// a box of a 3-d tensor map (coordinates innermost first) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// the wgmma descriptor of a K-major operand in 128-byte-swizzled rows (8-row
// groups 1024 bytes apart), starting at `p`
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3ffff) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
// d (64 x 192, f32) += a (64 x 8, TF32, registers) * b (8 x 192, TF32,
// K-major in shared memory at desc_b), one warpgroup; with scale_d 0,
// d = a * b
__device__ __forceinline__ void wgmma_tf32_m64n192k8(float (&d)[96], const uint32_t (&a)[4], uint64_t desc_b,
                                                     int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kDwConsumers) : "memory"); }

// Offset (floats) of element (row k, column c) of a 32 x 32 TMA box under
// CU_TENSOR_MAP_SWIZZLE_128B: 16-byte chunk c / 4 of row k sits at chunk
// (c / 4) ^ (k % 8).
__device__ __forceinline__ int dw_box_at(int k, int c) { return k * kDwBox + ((((c >> 2) ^ k) & 7) << 2) + (c & 3); }

// A row of the tile (warpgroup wg, warp wi of it, fragment row gid + 8 *
// half) -> its unit, 0..127. Fragment rows gid and gid + 4 land 16 units
// apart, so the A-fragment reads (rows k = tig, tig + 4 of a box) are
// conflict-free under the box's swizzle.
__device__ __forceinline__ int dw_unit(int wg, int wi, int gid, int half) {
  return 64 * wg + 32 * (wi >> 1) + (gid & 3) + 4 * (2 * half + (wi & 1)) + 16 * (gid >> 2);
}

// The long-K pipeline of gru_dw_kernel and grouped_dw_kernel: dW = A^T B
// over K rows, A's M columns and B's N columns of each row brought in by
// TMA. Grid (ceil(M / kDwM) * ceil(N / kDwN), P, G), kDwThreads threads,
// kDwSmem bytes of dynamic shared memory. Block (tile, p, g) sums stages
// [p * spb, (p + 1) * spb) of kDwK rows for its kDwM x kDwN tile of dW[g]
// into partials[g, p]: dW (M x N, row-major), then, with column sums, B's
// N column sums. Every block has at least one stage (the host checks the
// split). The tiles run fastest in the grid, so the blocks in flight
// together read the same rows of A and B.
//
// Rows, the kernel's policy, supplies what differs between the kernels:
// - stages(), the stages of K; fetch(st, s, m0, n0, g, bar), the TMA of
//   stage s's boxes of the tile (A's in the first kDwHBoxes, B's after
//   them) into the fp32 stage st, completing on bar, whose bytes it sets;
//   rows and columns past the data read as zeros;
// - kColumnSums: the split pass also sums each column of B over the
//   stage's valid(s) rows, in the blocks of the first row of tiles, and
//   the partial ends with those sums (the GRU's db_hh);
// - kRuns: a block sums its stages in runs of equal, even length (a run
//   starts on fragment set 0), at most kGdwMaxRun, each begun by a product
//   with scale_d 0 and added into the partial at its end, the first run
//   storing it. Without it, one run into an accumulator zeroed first.
template <class Rows>
__device__ __forceinline__ void dw_pipeline(const Rows& rows, float* __restrict__ partials, int M, int N, int spb) {
  extern __shared__ uint8_t dw_smem_raw[];
  float* smem = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(dw_smem_raw) + 1023) & ~(uintptr_t)1023);
  float* ring = smem;                                      // kDwStages fp32 stages
  float* split = smem + kDwStages * kDwStageFloats;        // [2 buffers][big, small]
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(smem) + kDwBarOffset);
  uint64_t* empty = full + kDwStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.y, g = blockIdx.z;
  const int tiles_n = (N + kDwN - 1) / kDwN;
  const int m0 = (blockIdx.x / tiles_n) * kDwM, n0 = (blockIdx.x % tiles_n) * kDwN;
  const int s0 = p * spb, ns = max(0, min(rows.stages(), s0 + spb) - s0);

  if (tid == 0) {
    for (int i = 0; i < kDwStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kDwConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kDwConsumers / 32) {
    // producer: one thread starts every stage's boxes; the warpgroup gives
    // its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kDwConsumers) {
      for (int s = 0; s < ns; ++s) {
        const int slot = s % kDwStages;
        if (s >= kDwStages) mbar_wait(&empty[slot], (s / kDwStages - 1) & 1);
        rows.fetch(ring + slot * kDwStageFloats, s0 + s, m0, n0, g, &full[slot]);
      }
    }
    return;
  }

  // consumers: warpgroup wg forms rows [64 wg, 64 wg + 64) of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2, wi = warp & 3, gid = lane >> 2, tig = lane & 3;
  // A-fragment offsets in a stage's A boxes, k8 step 0: a0 (row gid, k tig),
  // a1 (row gid + 8, k tig), a2 (row gid, k tig + 4), a3 (row gid + 8, k tig + 4)
  int a_off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = dw_unit(wg, wi, gid, i & 1), k = tig + 4 * (i >> 1);
    a_off[i] = (u / kDwBox) * kDwBoxFloats + dw_box_at(k, u % kDwBox);
  }
  float acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;
  float db[kDwTasks];
#pragma unroll
  for (int i = 0; i < kDwTasks; ++i) db[i] = 0.f;

  // the split pass of stage s: each fp32 B value of the stage is read once,
  // split into its TF32 parts, and written K-major (row n, 32 k) with the
  // 128-byte swizzle the wgmma descriptor names; task t of warp w covers
  // column n = 32 (p / 8) + lane, rows 4 (p % 8) .. + 3, p = 6w + t. With
  // column sums, those of the stage's valid rows go to db.
  auto split_stage = [&](int s) {
    const int slot = s % kDwStages;
    mbar_wait(&full[slot], (s / kDwStages) & 1);
    const float* bsrc = ring + slot * kDwStageFloats + kDwHBoxes * kDwBoxFloats;
    float* big = split + (s & 1) * 2 * kDwSplitFloats;
    float* small = big + kDwSplitFloats;
#pragma unroll
    for (int t = 0; t < kDwTasks; ++t) {
      const int task = kDwTasks * warp + t, cg = task >> 3, kq = task & 7, n = kDwBox * cg + lane;
      uint32_t vb[4], vs[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * kq + e;
        const float v = bsrc[cg * kDwBoxFloats + dw_box_at(k, lane)];
        if constexpr (Rows::kColumnSums) db[t] += k < rows.valid(s0 + s) ? v : 0.f;
        split_tf32(v, vb[e], vs[e]);
      }
      const int at = n * kDwK + ((kq ^ (n & 7)) << 2);
      *reinterpret_cast<uint4*>(big + at) = make_uint4(vb[0], vb[1], vb[2], vb[3]);
      *reinterpret_cast<uint4*>(small + at) = make_uint4(vs[0], vs[1], vs[2], vs[3]);
    }
    // the generic-proxy writes become visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // the A fragments of stage s (k8 steps 0..3), split into TF32 parts
  using Frags = uint32_t[4][4];
  auto load_a = [&](int s, Frags& ab, Frags& as) {
    const float* asrc = ring + (s % kDwStages) * kDwStageFloats;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(asrc[a_off[i] + 8 * kDwBox * j], ab[j][i], as[j][i]);
  };
  // stage s of the run [r0, r1): its products from its A fragments (cur),
  // while the next stage is split and its A fragments are read into nxt:
  // the fp32 stage s + 1 is released as soon as it is read, and the
  // products wait only on the barrier that hands over the split buffers.
  // With runs, the run's first product overwrites the accumulator (scale_d
  // 0), so that no other instruction writes it between the products.
  auto step = [&](int s, int r0, int r1, Frags& cur_b, Frags& cur_s, Frags& nxt_b, Frags& nxt_s) {
    const float* big = split + (s & 1) * 2 * kDwSplitFloats;
    const float* small = big + kDwSplitFloats;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // k8 steps: 32 bytes along each 128-byte row
      wgmma_tf32_m64n192k8(acc, cur_s[j], wgmma_desc_sw128(big + 8 * j), !Rows::kRuns || j > 0 || s > r0);
      wgmma_tf32_m64n192k8(acc, cur_b[j], wgmma_desc_sw128(small + 8 * j));
      wgmma_tf32_m64n192k8(acc, cur_b[j], wgmma_desc_sw128(big + 8 * j));
    }
    wgmma_commit();
    if (s + 1 < r1) {
      split_stage(s + 1);
      load_a(s + 1, nxt_b, nxt_s);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(s + 1) % kDwStages]);
    }
    wgmma_wait_all();
    // the A fragments stay live (unchanged) until the products that read them are done
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile("" ::"r"(cur_b[j][0]), "r"(cur_b[j][1]), "r"(cur_b[j][2]), "r"(cur_b[j][3]), "r"(cur_s[j][0]),
                   "r"(cur_s[j][1]), "r"(cur_s[j][2]), "r"(cur_s[j][3]));
    consumers_sync();  // both warpgroups are done with buffer s & 1 and have split s + 1
  };

  auto partial = [&] {
    return partials + ((size_t)g * gridDim.y + p) * ((size_t)M * N + (Rows::kColumnSums ? N : 0));
  };
  // the run [r0, r1): its stages summed in the accumulator, which is then
  // stored into the partial, or added where an earlier run has stored, one
  // half of the tile's rows at a time. Between runs only the accumulator is
  // live: the next run's first stage is split and read after the add.
  uint32_t ab0[4][4], as0[4][4], ab1[4][4], as1[4][4];
  auto sum_run = [&](int r0, int r1) {
    split_stage(r0);
    load_a(r0, ab0, as0);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[r0 % kDwStages]);
    consumers_sync();
    for (int s = r0; s < r1; s += 2) {  // two stages a turn: the fragment sets swap by name, not by index
      step(s, r0, r1, ab0, as0, ab1, as1);
      if (s + 1 < r1) step(s + 1, r0, r1, ab1, as1, ab0, as0);
    }
    float* out = partial();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + dw_unit(wg, wi, gid, half);
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const int c = n0 + 8 * j + 2 * tig;
        if (r < M && c < N) {  // N % 4 == 0: c + 1 < N too
          float2* at = reinterpret_cast<float2*>(out + (size_t)r * N + c);
          float2 v = make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
          if (Rows::kRuns && r0 > 0) {
            const float2 o = *at;
            v = make_float2(o.x + v.x, o.y + v.y);
          }
          *at = v;
        }
      }
      asm volatile("" ::: "memory");  // one half's reads in flight at a time
    }
  };
  if constexpr (Rows::kRuns) {
    const int runs = max(1, (ns + kGdwMaxRun - 1) / kGdwMaxRun);
    const int run = ((ns + runs - 1) / runs + 1) & ~1;
    for (int r0 = 0; r0 < ns; r0 += run) sum_run(r0, min(ns, r0 + run));
  } else {
    sum_run(0, ns);
  }

  if constexpr (Rows::kColumnSums) {
    if (m0 == 0) {  // the tasks' sums, added in a fixed order (k quads 0..7)
      float* sums = split;  // no wgmma reads the split buffers any more
#pragma unroll
      for (int t = 0; t < kDwTasks; ++t) sums[(kDwTasks * warp + t) * 32 + lane] = db[t];
      consumers_sync();
      if (tid < kDwN) {
        float sum = 0.f;
#pragma unroll
        for (int kq = 0; kq < 8; ++kq) sum += sums[((tid >> 5) * 8 + kq) * 32 + (tid & 31)];
        partial()[(size_t)M * N + n0 + tid] = sum;
      }
    }
  }
}

// gru_dw_kernel's rows: h_prev (A) comes in two segments, h0[g] (B rows)
// and y[g] rows 0 .. (T - 1)B - 1, each cut into stages of kDwK rows (the
// last one of each ragged: the tensor maps end there and TMA fills the rest
// with zeros); a stage never straddles them. dgh (B) = [dgi[..., :2H] |
// dgh_n] on the same rows (dgi's and dgh_n's rows of y's segment start at
// B). The partial is [dW_hh (H x 3H) | db_hh (3H)].
struct GruDwRows {
  static constexpr bool kColumnSums = true, kRuns = false;
  const CUtensorMap *h0, *y, *dgi, *dghn;
  int B, H, s_h0, ky;  // h0's stages, y's rows
  __device__ int stages() const { return s_h0 + (ky + kDwK - 1) / kDwK; }
  __device__ int valid(int s) const {
    return s < s_h0 ? min(kDwK, B - s * kDwK) : min(kDwK, ky - (s - s_h0) * kDwK);
  }
  __device__ void fetch(float* st, int s, int m0, int n0, int g, uint64_t* bar) const {
    mbar_expect_tx(bar, kDwStageBytes);
    const bool in_h0 = s < s_h0;
    const int row = in_h0 ? s * kDwK : (s - s_h0) * kDwK;  // row in its segment
    const int drow = in_h0 ? row : B + row;                 // row of dgh
#pragma unroll
    for (int j = 0; j < kDwHBoxes; ++j) tma_load_3d(st + j * kDwBoxFloats, in_h0 ? h0 : y, m0 + kDwBox * j, row, g, bar);
#pragma unroll
    for (int j = 0; j < kDwGBoxes; ++j) {
      const int col = n0 + kDwBox * j;
      float* dst = st + (kDwHBoxes + j) * kDwBoxFloats;
      if (col < 2 * H)
        tma_load_3d(dst, dgi, col, drow, g, bar);
      else
        tma_load_3d(dst, dghn, col - 2 * H, drow, g, bar);
    }
  }
};

// grid ((H / kDwM) * (3H / kDwN), P, G): dw_pipeline over the ceil(B / kDwK)
// + ceil((T - 1)B / kDwK) stages of h_prev and dgh
__global__ void __launch_bounds__(kDwThreads, 1)
gru_dw_kernel(const __grid_constant__ CUtensorMap h0_map, const __grid_constant__ CUtensorMap y_map,
              const __grid_constant__ CUtensorMap dgi_map, const __grid_constant__ CUtensorMap dghn_map,
              float* __restrict__ partials, int T, int B, int H, int spb) {
  const GruDwRows rows{&h0_map, &y_map, &dgi_map, &dghn_map, B, H, (B + kDwK - 1) / kDwK, (T - 1) * B};
  dw_pipeline(rows, partials, H, 3 * H, spb);
}

// ---------------------------------------------------------------------------
// Reduction of the backward's partials
// ---------------------------------------------------------------------------

// out[g, e] = sum_{p < P} partials[g, p, e], in order p = 0, 1, ...
__global__ void gru_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                  int P, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  if (e >= E) return;
  const float* p = partials + (size_t)g * P * E + e;
  float s = 0.f;
  for (int i = 0; i < P; ++i) s += p[(size_t)i * E];
  out[(size_t)g * E + e] = s;
}

// ---------------------------------------------------------------------------
// Weight gradients of the grouped f32 products: dW[g] = x[g]^T dy[g]
// ---------------------------------------------------------------------------
//
// grouped_dw_kernel, grouped_dw_ffma_kernel and grouped_dw_reduce_kernel
// replace no TPU kernel: XLA forms these products there. They take the
// backward of ops/matmul.py's f32 grouped product x (G, K, M) @ w (G, M, N)
// (every f32 Linear layer and GRU input projection of the port): the
// weight gradient dW[g] (M x N) = sum over the K rows of x[g, k]^T dy[g, k],
// with a tiny M x N and a long K, (T+1)B rows in an update (212,992 at
// B=8192). cuBLAS ran it as a strided-batched FFMA GEMM of 32 x 32 tiles
// that does not split K: a few dozen blocks, each walking all of K in
// serial 8-deep steps, at about 2% of the bound below (PERF.md).
// What bounds them on an H100: the bytes of x and dy, each read once (872 MB
// at the GRU input projection, 128 x 384, G=2, K=212,992: 0.26 ms at 3.35
// TB/s) and, for a wide product, the 3xTF32 operations (0.25 ms there at
// 495 TFLOP/s). Design:
// - K is split over P blocks a tile (ops/grouped_dw.py grouped_dw_tiling,
//   a cost model like dw_tiling's, the partials kept under 16 MB), each
//   summing its rows into a partial of its own (P = 1: straight into dW);
// - grouped_dw_reduce_kernel sums the partials in a fixed order (no
//   atomics: two calls are bitwise equal), bound by bytes. Unlike
//   gru_reduce_kernel's one chain of P loads an entry, it splits P eight
//   ways, as a small dW has few entries for many partials (15 x 128 split
//   196 ways is 3,840 chains of 196 loads). A name of its own keeps this
//   work out of the GRU kernels' time, which readers match by name;
// - grouped_dw_kernel takes M and N that are multiples of 4 (rows TMA can
//   map: 16-byte strides): the long-K pipeline gru_dw_kernel runs
//   (dw_pipeline), with A = x^T and B = dy, one tensor map each. A block
//   sums its stages in runs of equal length, at most kGdwMaxRun, each added
//   into the block's partial at its end. So the error the accumulator
//   gathers (about 2.4e-7 of the largest entry a stage, gru_dw_kernel's
//   note) stays within gru_dw_kernel's bound however many rows a block
//   sums, and the partials stay few (under 16 MB). A run's end costs about
//   24 us on an H100 (the add, and a stage split and read outside the
//   pipeline): runs of 32 stages took 0.544 ms at 128 x 384, K=212,992, one
//   run 0.398 ms. The tile's rows and columns past M and N are not stored;
// - grouped_dw_ffma_kernel takes any M and N, among them the 15-wide
//   observations (60-byte rows) and the 6-wide Q-value gradients (24-byte
//   rows) that TMA cannot map. Exact FFMA, bound by bytes: the tile's
//   columns of 32 rows of x and dy are copied by cp.async (16 bytes where
//   the width is a multiple of 4, else 4) into a ring of three zero-padded
//   stages; each thread sums a 4 x 4 tile of dW over its slice of a
//   stage's rows, and the slices' sums are added in a fixed order at the
//   end. Tiles (bm, bn) of powers of two, at most 4096 entries, shaped to
//   the product (ops/grouped_dw.py ffma_tile): 16 x 128 for 15 x 128, 128
//   x 8 for 128 x 6.

// grouped_dw_kernel's rows: x[g] (A) and dy[g] (B), K rows each, cut into
// stages of kDwK rows (the last one ragged: the tensor maps end there and
// TMA fills the rest with zeros); boxes wholly past M or N are not loaded.
// The partial is dW (M x N).
struct LinearDwRows {
  static constexpr bool kColumnSums = false, kRuns = true;
  const CUtensorMap *x, *dy;
  int K, M, N;
  __device__ int stages() const { return (K + kDwK - 1) / kDwK; }
  __device__ void fetch(float* st, int s, int m0, int n0, int g, uint64_t* bar) const {
    // the boxes of the tile that hold columns of x and of dy
    const int xb = min(kDwHBoxes, (M - m0 + kDwBox - 1) / kDwBox);
    const int yb = min(kDwGBoxes, (N - n0 + kDwBox - 1) / kDwBox);
    mbar_expect_tx(bar, (xb + yb) * kDwBoxFloats * 4);
    const int row = s * kDwK;
    for (int j = 0; j < xb; ++j) tma_load_3d(st + j * kDwBoxFloats, x, m0 + kDwBox * j, row, g, bar);
    for (int j = 0; j < yb; ++j) tma_load_3d(st + (kDwHBoxes + j) * kDwBoxFloats, dy, n0 + kDwBox * j, row, g, bar);
  }
};

// grid (ceil(M / kDwM) * ceil(N / kDwN), P, G): dw_pipeline over the
// ceil(K / kDwK) stages of x and dy
__global__ void __launch_bounds__(kDwThreads, 1)
grouped_dw_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap dy_map,
                  float* __restrict__ partials, int K, int M, int N, int spb) {
  dw_pipeline(LinearDwRows{&x_map, &dy_map, K, M, N}, partials, M, N, spb);
}

constexpr int kFfThreads = 256;
constexpr int kFfRows = 32;   // rows of K a stage of grouped_dw_ffma_kernel
constexpr int kFfStages = 3;  // its ring: two stages in flight while one is summed

// 4 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

// rows [k0, k0 + kFfRows) and columns [c0, c0 + 2^lb) of a row-major (K, C)
// matrix into dst (kFfRows rows of 2^lb floats), zeros outside the matrix:
// 16-byte copies where C % 4 == 0 (each wholly inside or outside it), else
// 4-byte copies
__device__ __forceinline__ void ffma_stage(float* dst, const float* __restrict__ src, int K, int C, int k0, int c0,
                                           int lb) {
  if ((C & 3) == 0) {
    const int lq = lb - 2;
    for (int i = threadIdx.x; i < (kFfRows << lq); i += kFfThreads) {
      const int r = k0 + (i >> lq), c = c0 + ((i & ((1 << lq) - 1)) << 2);
      const bool ok = r < K && c < C;
      cp_async16(dst + 4 * i, ok ? src + (size_t)r * C + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < (kFfRows << lb); i += kFfThreads) {
      const int r = k0 + (i >> lb), c = c0 + (i & ((1 << lb) - 1));
      const bool ok = r < K && c < C;
      cp_async4(dst + i, ok ? src + (size_t)r * C + c : src, ok);
    }
  }
}

// grid (ceil(M / bm) * ceil(N / bn), P, G), kFfThreads threads, bm = 2^lbm,
// bn = 2^lbn (each >= 4, bm * bn <= 16 * kFfThreads). Thread t owns the 4 x 4
// entries at rows 4 tm.., columns 4 tn.. of the tile, with tn = t % (bn / 4),
// tm = t / (bn / 4) % (bm / 4), and sums rows slice, slice + slices, ... of
// each stage, slice = t / (bm bn / 16). Block (tile, p, g) sums stages [p *
// spb, (p + 1) * spb) of kFfRows rows into partials[g, p] (M x N).
__global__ void __launch_bounds__(kFfThreads)
grouped_dw_ffma_kernel(const float* __restrict__ x, const float* __restrict__ dy, float* __restrict__ partials,
                       int K, int M, int N, int lbm, int lbn, int spb) {
  extern __shared__ float4 ffma_smem_raw[];
  float* smem = reinterpret_cast<float*>(ffma_smem_raw);
  const int bm = 1 << lbm, bn = 1 << lbn, tns = bn >> 2, per_slice = (bm >> 2) * tns;
  const int slices = kFfThreads / per_slice;
  const int tid = threadIdx.x, at = tid % per_slice, slice = tid / per_slice, tm = at / tns, tn = at % tns;
  const int p = blockIdx.y, g = blockIdx.z;
  const int tiles_n = (N + bn - 1) >> lbn;
  const int m0 = (blockIdx.x / tiles_n) << lbm, n0 = (blockIdx.x % tiles_n) << lbn;
  const int n_stages = (K + kFfRows - 1) / kFfRows;
  const int s0 = p * spb, ns = max(0, min(n_stages, s0 + spb) - s0);
  const float* xg = x + (size_t)g * K * M;
  const float* yg = dy + (size_t)g * K * N;
  const int stage = kFfRows * (bm + bn);
  // stage s into its slot of the ring, as one group of copies (an empty
  // group past the block's stages, so that every turn waits alike)
  auto load = [&](int s) {
    if (s < ns) {
      float* st = smem + (s % kFfStages) * stage;
      const int k0 = (s0 + s) * kFfRows;
      ffma_stage(st, xg, K, M, k0, m0, lbm);
      ffma_stage(st + kFfRows * bm, yg, K, N, k0, n0, lbn);
    }
    cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < kFfStages - 1; ++s) load(s);
  for (int s = 0; s < ns; ++s) {
    load(s + kFfStages - 1);  // into the slot stage s - 1 left
    cp_async_wait<kFfStages - 1>();
    __syncthreads();
    const float* xs = smem + (s % kFfStages) * stage + 4 * tm;
    const float* ys = smem + (s % kFfStages) * stage + kFfRows * bm + 4 * tn;
    for (int r = slice; r < kFfRows; r += slices) {
      const float4 a = *reinterpret_cast<const float4*>(xs + (r << lbm));
      const float4 b = *reinterpret_cast<const float4*>(ys + (r << lbn));
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the slot is read no more before the next copy into it
  }
  cp_async_wait<0>();  // the empty groups
  // the slices' sums, added in order 0, 1, ... through shared memory, which
  // no stage uses any more
  if (slice > 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) smem[((slice - 1) * 16 + 4 * i + j) * per_slice + at] = acc[i][j];
  }
  __syncthreads();
  if (slice > 0) return;
  for (int o = 1; o < slices; ++o)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += smem[((o - 1) * 16 + 4 * i + j) * per_slice + at];
  float* out = partials + ((size_t)g * gridDim.y + p) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + 4 * tm + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 4 * tn + j;
      if (r < M && c < N) out[(size_t)r * N + c] = acc[i][j];
    }
  }
}

// the FFMA kernel's dynamic shared memory (bytes) at a tile: the ring, or
// the slices' sums where they take more
__host__ __device__ constexpr size_t ffma_smem(int bm, int bn) {
  return (size_t)(kFfStages * kFfRows * (bm + bn) > (kFfThreads - bm * bn / 16) * 16
                      ? kFfStages * kFfRows * (bm + bn)
                      : (kFfThreads - bm * bn / 16) * 16) *
         sizeof(float);
}

constexpr int kRedRows = 8;  // the ways grouped_dw_reduce_kernel splits P

// out[g, e] = sum over p < P of partials[g, p, e] in a fixed order: thread
// row r of a block (32 entries x kRedRows rows) sums p = r, r + kRedRows, ...
// in order, and the rows' sums are added in order r = 0, 1, ...
__global__ void __launch_bounds__(32 * kRedRows)
grouped_dw_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out, int P, int E) {
  __shared__ float sums[kRedRows][32];
  const int lane = threadIdx.x, r = threadIdx.y, e = blockIdx.x * 32 + lane, g = blockIdx.y;
  float s = 0.f;
  if (e < E) {
    const float* p = partials + (size_t)g * P * E + e;
    for (int i = r; i < P; i += kRedRows) s += p[(size_t)i * E];
  }
  sums[r][lane] = s;
  __syncthreads();
  if (r == 0 && e < E) {
    float t = sums[0][lane];
#pragma unroll
    for (int i = 1; i < kRedRows; ++i) t += sums[i][lane];
    out[(size_t)g * E + e] = t;
  }
}

// ---------------------------------------------------------------------------
// Products of the grouped f32 Linear layers: y[g] = x[g] @ B[g] (+ b[g])
// ---------------------------------------------------------------------------
//
// grouped_mm_kernel and grouped_mm_ffma_kernel replace no TPU kernel: XLA
// forms these products there. They take the forward and the input gradient
// of ops/matmul.py's f32 grouped Linear, x (G, R, K) @ B (G, K, N) + b
// (G, N): B = w (G, K, N) in the forward, with the bias added in the
// epilogue; B = w^T for the input gradient dX = dy @ w^T (w (G, N, K) read
// transposed, no bias). R is the layer's rows, (T+1)B in an update and the
// envs in a rollout step (212,992 and 524,288 in the LBF benchmark cells), K
// and N the layer's widths (15, 128, 384, 6, ...). cuBLAS ran them as FFMA
// GEMMs (TF32 is off for the process), each followed by a broadcast add of
// the bias that read and wrote the output again (PERF.md). What bounds them
// on an H100: the bytes of x read once and y written once (872 MB at the
// GRU input projection, 128 -> 384, G=2, R=212,992: 0.26 ms at 3.35 TB/s)
// and the 3xTF32 operations (0.25 ms there at 495 TFLOP/s). Design:
// - grouped_mm_kernel: B and b are tiny, so a block stages its tile of N
//   columns of B (BN = 64 or 128, ops/grouped_mm.py mm_variant, all of K
//   zero-padded to k-blocks of 32) once, split into TF32 big and small
//   parts, K-major in 128-byte-swizzled rows, into shared memory, and keeps
//   it for every row tile it forms. Where K x BN outgrows shared memory (the
//   QMIX mixer's 1,660-wide state) B comes in chunks of K: every tile's
//   share of one chunk, then the next chunk's added into y;
// - the grid is persistent: blocks of three warpgroups (two with 128
//   columns: three would not fit their registers), each walking 64-row
//   tiles of its group on its own (no barrier after the staging). A
//   warpgroup reads its x rows from device memory straight into registers
//   (wgmma's A-from-registers form: the rows of K = 15 or 166 are not
//   16-byte aligned, so TMA cannot map them) and splits them there. The k
//   order inside a 16-deep slice is permuted in A and B alike, so that a
//   thread's A values of a slice are four consecutive floats of a row (one
//   16-byte load where K % 4 == 0, two 8-byte or four 4-byte loads else);
//   loads run two k-blocks ahead across tile boundaries, so one tile's
//   epilogue overlaps the next tile's loads. The column tiles of a
//   group read the same rows at about the same time, the second from the
//   L2 (x loads marked evict-first ran slower);
// - per k8 step three m64nBNk8 wgmma: small * big and big * small into a
//   correction accumulator, big * big into the main one; the tile's first
//   products overwrite them (scale_d 0). The tensor cores truncate each
//   sum into the accumulator, so one chain of all three at y's magnitude
//   gathered 2.7x the error of cuBLAS's f32 GEMM (1.0e-6 against 3.7e-7 of
//   the largest entry at the GRU input projection, G=2, R=212,992, on an
//   H100) and moved the QMIX mixer's gradients past the benchmark's limit
//   on some seeds; the split chains read 3.8e-7. Their registers cost the
//   128-column blocks a warpgroup: 0.752 ms there against 0.585 with one
//   accumulator and three warpgroups (64-column blocks of three: 0.818);
// - the epilogue adds b (staged with B) to the accumulator and stores the
//   tile once, masking the ragged row and column edges. No atomics: two
//   calls are bitwise equal.
// - grouped_mm_ffma_kernel takes the thin products (N <= 32: the 6- and
//   18-wide Q-value layers), bound by bytes: exact FFMA, one row a thread,
//   x in stages of 32 k copied by cp.async into a ring of two (rows 36
//   floats apart: conflict-free float4 reads), B (zero-padded to a multiple
//   of 4 columns) and b in shared memory, read as broadcast float4.

// warpgroups a block of grouped_mm_kernel with NC 64-column chunks: three
// where their registers fit (more loads in flight), else two
__host__ __device__ constexpr int mm_groups(int nc) { return nc == 1 ? 3 : 2; }
constexpr int kMmRows = 64;                  // rows of a warpgroup's tile: one m64 product
constexpr int kMmKBlock = 32;                // k of a staged 128-byte row of B
constexpr int kMmChunk = 64;                 // columns of one m64n64k8 product
constexpr int kMmMaxChunks = 2;              // a block's columns: up to 128

// the kernel's dynamic shared memory (bytes) for K x BN of B: big and small
// parts, the bias, 1 KB of slack to align the parts to 1024 bytes
__host__ __device__ constexpr size_t mm_smem(int K, int bn) {
  return (size_t)(2 * ((K + kMmKBlock - 1) / kMmKBlock) * kMmKBlock * bn + bn) * sizeof(float) + 1024;
}

// d (64 x 64, f32) += a (64 x 8, TF32, registers) * b (8 x 64, TF32, K-major
// in shared memory at desc_b), one warpgroup; with scale_d 0, d = a * b
__device__ __forceinline__ void wgmma_tf32_m64n64k8(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}
// d (64 x 128) += a * b, as wgmma_tf32_m64n64k8
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_wait_one() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }
// the accumulator's registers stay where the asynchronous products write them
template <int NC>
__device__ __forceinline__ void mm_fence_acc(float (&acc)[32 * NC]) {
#pragma unroll
  for (int i = 0; i < 32 * NC; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}
// d (64 x 64 NC) += a * b: one m64n64k8 or m64n128k8 wgmma
template <int NC>
__device__ __forceinline__ void mm_wgmma(float (&d)[32 * NC], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  if constexpr (NC == 1) wgmma_tf32_m64n64k8(d, a, desc_b, scale_d);
  if constexpr (NC == 2) wgmma_tf32_m64n128k8(d, a, desc_b, scale_d);
}

// The float offset, in a block's staged part of B, of B(k, n): k-block k /
// 32, row n of 32 floats (128 bytes), 16-byte chunk swizzled by n % 8 (the
// descriptor's 128-byte swizzle). Inside a 16-deep slice the k order is
// permuted: logical column c of k8 step st holds k = 4 (c % 4) + 2 st + c / 4,
// so a thread's A values of a slice (columns tig, tig + 4 of both steps)
// are k = 4 tig .. 4 tig + 3.
__device__ __forceinline__ int mm_b_at(int k, int n, int bn) {
  const int r = k & 15, l = (k & 16) | (((r >> 1) & 1) << 3) | ((r & 1) << 2) | (r >> 2);
  return (k >> 5) * bn * kMmKBlock + n * kMmKBlock + ((((l >> 2) ^ n) & 7) << 2) + (l & 3);
}

// four consecutive floats x[row, k .. k + 3] (zeros past R or K), by the
// widest loads the row's alignment allows (VEC floats: 4 needs K % 4 == 0, 2
// needs K % 2 == 0)
template <int VEC>
__device__ __forceinline__ void mm_load4(float* v, const float* __restrict__ row, bool in, int k, int K) {
  if (VEC == 4) {
    const float4 q = in && k < K ? __ldg(reinterpret_cast<const float4*>(row + k)) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if (VEC == 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 q = in && k + 2 * h < K ? __ldg(reinterpret_cast<const float2*>(row + k + 2 * h))
                                           : make_float2(0.f, 0.f);
      v[2 * h] = q.x, v[2 * h + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = in && k + i < K ? __ldg(row + k + i) : 0.f;
  }
}

// grid (blocks, ceil(N / (64 NC)), G), 128 mm_groups(NC) threads, mm_smem(min(K,
// KC), 64 NC) bytes of dynamic shared memory. B(k, n) = w[g, k, n] (trans 0:
// w is (G, K, N)) or w[g, n, k] (trans 1: w is (G, N, K)); bias (G, N) or
// null. Block (i, j, g) forms columns [64 NC j, 64 NC (j + 1)) of y[g] for
// the 64-row tiles i * mm_groups(NC) + wg, stepping by gridDim.x * mm_groups(NC).
// K is taken in chunks of KC rows of B (a multiple of 32; one chunk unless B
// outgrows shared memory, as the QMIX mixer's 1,660-wide state does): the
// block stages a chunk, its warpgroups form every tile's share, the first
// chunk's epilogue writes acc + b and each later one adds acc to y.
template <int NC, int VEC>
__global__ void __launch_bounds__(128 * mm_groups(NC), 1)
grouped_mm_kernel(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                  float* __restrict__ y, int R, int K, int N, int KC, int trans) {
  constexpr int BN = kMmChunk * NC, GROUPS = mm_groups(NC), THREADS = 128 * GROUPS;
  extern __shared__ uint8_t mm_smem_raw[];
  float* big = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(mm_smem_raw) + 1023) & ~(uintptr_t)1023);
  const int kcap = (min(K, KC) + kMmKBlock - 1) / kMmKBlock * kMmKBlock;  // staged rows of B
  float* small = big + kcap * BN;
  float* sb = small + kcap * BN;
  const int tid = threadIdx.x, g = blockIdx.z, n0 = blockIdx.y * BN;
  const float* wg_ = w + (size_t)g * K * N;
  const int wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int tiles = (R + kMmRows - 1) / kMmRows, first = blockIdx.x * GROUPS + wg;
  const int stride = gridDim.x * GROUPS;
  const float* xg = x + (size_t)g * R * K;
  float* yg = y + (size_t)g * R * N;
  for (int n = tid; n < BN; n += THREADS) sb[n] = bias != nullptr && n0 + n < N ? bias[(size_t)g * N + n0 + n] : 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kn = min(KC, K - k0), nkb = (kn + kMmKBlock - 1) / kMmKBlock, kp = nkb * kMmKBlock;
    const int steps = 2 * ((kn + 15) / 16);  // k8 steps: whole 16-deep slices
    if (k0 > 0) __syncthreads();             // every warpgroup is done with the last chunk of B
    // the chunk of B's tile, split: rows k0 .. k0 + kn
    for (int i = tid; i < kp * BN; i += THREADS) {
      const int k = trans ? i % kp : i / BN, n = trans ? i / kp : i % BN;
      const float v = k < kn && n0 + n < N ? wg_[trans ? (size_t)(n0 + n) * K + k0 + k : (size_t)(k0 + k) * N + n0 + n]
                                           : 0.f;
      uint32_t vb, vs;
      split_tf32(v, vb, vs);
      const int at = mm_b_at(k, n, BN);
      big[at] = __uint_as_float(vb);
      small[at] = __uint_as_float(vs);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (first >= tiles) continue;

    // the warpgroup's stream of (tile, k-block): position p
    auto tile_of = [&](int p) { return first + (p / nkb) * stride; };
    // the A values of position p: rows gid and gid + 8 of the warp's 16,
    // both slices of the k-block, four consecutive k each
    auto load = [&](int p, float (&raw)[16]) {
      const int t = tile_of(p), kb = p % nkb;
      if (t >= tiles) return;
      const int r0 = t * kMmRows + 16 * wi + gid;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + 8 * half;
          mm_load4<VEC>(raw + 8 * h + 4 * half, xg + (size_t)r * K, r < R, k0 + kb * kMmKBlock + 16 * h + 4 * tig,
                        K);
        }
    };
    using Frags = uint32_t[4][4];
    // k8 step j of the k-block: a0 (row gid, column tig), a1 (gid + 8, tig),
    // a2 (gid, tig + 4), a3 (gid + 8, tig + 4); column tig + 4 c' of step st
    // is k = 4 tig + 2 st + c' of the slice
    auto split = [&](const float (&raw)[16], Frags& fb, Frags& fs) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(raw[8 * (j >> 1) + 4 * (i & 1) + 2 * (j & 1) + (i >> 1)], fb[j][i], fs[j][i]);
    };
    // big * big in acc, the two correction products in corr, whose chain of
    // truncated sums sits about 2^-11 below y's magnitude (the design note)
    float acc[32 * NC], corr[32 * NC];
#pragma unroll
    for (int i = 0; i < 32 * NC; ++i) acc[i] = corr[i] = 0.f;

    // position p's products from (cfb, cfs), whose raw values (craw) are
    // then reloaded with position p + 2's; at a tile's last k-block its
    // epilogue; then position p + 1's fragments into (nfb, nfs) from nraw.
    // False at the stream's end.
    auto step = [&](int p, float (&craw)[16], const float (&nraw)[16], Frags& cfb, Frags& cfs, Frags& nfb,
                    Frags& nfs) {
      const int t = tile_of(p), kb = p % nkb;
      mm_fence_acc<NC>(acc);
      mm_fence_acc<NC>(corr);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * kb + j < steps) {
          const float* bb = big + kb * BN * kMmKBlock + 8 * j;
          const float* bs = small + kb * BN * kMmKBlock + 8 * j;
          mm_wgmma<NC>(corr, cfs[j], wgmma_desc_sw128(bb), kb > 0 || j > 0);
          mm_wgmma<NC>(corr, cfb[j], wgmma_desc_sw128(bs), 1);
          mm_wgmma<NC>(acc, cfb[j], wgmma_desc_sw128(bb), kb > 0 || j > 0);
        }
      }
      wgmma_commit();
      mm_fence_acc<NC>(acc);
      mm_fence_acc<NC>(corr);
      load(p + 2, craw);
      if (kb == nkb - 1) {
        wgmma_wait_all();
        mm_fence_acc<NC>(acc);
        mm_fence_acc<NC>(corr);
        const int r0 = t * kMmRows + 16 * wi + gid;
#pragma unroll
        for (int j = 0; j < 8 * NC; ++j) {
          const int cl = 8 * j + 2 * tig, col = n0 + cl;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = r0 + 8 * half;
            if (r >= R || col >= N) continue;
            float* at = yg + (size_t)r * N + col;
            const bool two = col + 1 < N;
            // the first chunk adds the bias, a later one the sum so far
            const float p0 = k0 == 0 ? sb[cl] : at[0], p1 = k0 == 0 ? sb[cl + 1] : two ? at[1] : 0.f;
            const int i0 = 4 * j + 2 * half;
            const float v0 = (acc[i0] + corr[i0]) + p0, v1 = (acc[i0 + 1] + corr[i0 + 1]) + p1;
            if ((N & 1) == 0) {
              *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
            } else {
              at[0] = v0;
              if (two) at[1] = v1;
            }
          }
        }
      } else {
        wgmma_wait_one();
      }
      // the fragments of position p - 1 (nfb, nfs) stay unchanged until the
      // products that read them are done
#pragma unroll
      for (int j = 0; j < 4; ++j)
        asm volatile("" ::"r"(nfb[j][0]), "r"(nfb[j][1]), "r"(nfb[j][2]), "r"(nfb[j][3]), "r"(nfs[j][0]),
                     "r"(nfs[j][1]), "r"(nfs[j][2]), "r"(nfs[j][3]));
      if (tile_of(p + 1) >= tiles) {
        wgmma_wait_all();
        return false;
      }
      split(nraw, nfb, nfs);
      return true;
    };

    float raw0[16], raw1[16];
    uint32_t fb0[4][4], fs0[4][4], fb1[4][4], fs1[4][4];
    load(0, raw0);
    load(1, raw1);
    split(raw0, fb0, fs0);
    for (int p = 0;; p += 2) {  // two positions a turn: the register sets swap by name, not by index
      if (!step(p, raw0, raw1, fb0, fs0, fb1, fs1)) break;
      if (!step(p + 1, raw1, raw0, fb1, fs1, fb0, fs0)) break;
    }
  }
}

constexpr int kMmfThreads = 256;              // rows a block of grouped_mm_ffma_kernel: one a thread
constexpr int kMmfK = 32;                     // k of a stage
constexpr int kMmfStride = kMmfK + 4;         // a staged row's floats: conflict-free float4 reads
constexpr int kMmfStages = 2;

// the FFMA kernel's dynamic shared memory (bytes): the ring, then B (K
// padded to stages, NP columns) and the bias
__host__ __device__ constexpr size_t mm_ffma_smem(int K, int np) {
  return (size_t)(kMmfStages * kMmfThreads * kMmfStride + ((K + kMmfK - 1) / kMmfK) * kMmfK * np + np) *
         sizeof(float);
}

// grid (ceil(R / kMmfThreads), 1, G), kMmfThreads threads, mm_ffma_smem(K,
// 4 NV) bytes; N <= 4 NV. B and bias as grouped_mm_kernel's. Thread t forms
// row blockIdx.x * kMmfThreads + t of y[g].
template <int NV>
__global__ void __launch_bounds__(kMmfThreads)
grouped_mm_ffma_kernel(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                       float* __restrict__ y, int R, int K, int N, int trans) {
  constexpr int NP = 4 * NV;
  extern __shared__ float4 mmf_smem_raw[];
  float* ring = reinterpret_cast<float*>(mmf_smem_raw);
  float* sw = ring + kMmfStages * kMmfThreads * kMmfStride;
  const int nst = (K + kMmfK - 1) / kMmfK, kp = nst * kMmfK;
  float* sb = sw + kp * NP;
  const int tid = threadIdx.x, g = blockIdx.z, row0 = blockIdx.x * kMmfThreads;
  const float* xg = x + (size_t)g * R * K;
  const int rows = min(kMmfThreads, R - row0);
  // stage s: rows row0.. of k [32 s, 32 s + 32), zeros past R and K
  auto load = [&](int s) {
    if (s < nst) {
      float* st = ring + (s % kMmfStages) * kMmfThreads * kMmfStride;
      const int k0 = s * kMmfK;
      if ((K & 3) == 0) {
        for (int i = tid; i < kMmfThreads * (kMmfK / 4); i += kMmfThreads) {
          const int r = i >> 3, k = k0 + 4 * (i & 7);
          const bool ok = r < rows && k < K;
          cp_async16(st + r * kMmfStride + 4 * (i & 7), ok ? xg + (size_t)(row0 + r) * K + k : xg, ok);
        }
      } else {
        for (int i = tid; i < kMmfThreads * kMmfK; i += kMmfThreads) {
          const int r = i >> 5, k = k0 + (i & 31);
          const bool ok = r < rows && k < K;
          cp_async4(st + r * kMmfStride + (i & 31), ok ? xg + (size_t)(row0 + r) * K + k : xg, ok);
        }
      }
    }
    cp_async_commit();
  };
  load(0);
  const float* wg_ = w + (size_t)g * K * N;
  for (int i = tid; i < kp * NP; i += kMmfThreads) {
    const int k = i / NP, n = i % NP;
    sw[i] = k < K && n < N ? wg_[trans ? (size_t)n * K + k : (size_t)k * N + n] : 0.f;
  }
  for (int n = tid; n < NP; n += kMmfThreads) sb[n] = bias != nullptr && n < N ? bias[(size_t)g * N + n] : 0.f;
  float acc[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) acc[n] = 0.f;
  for (int s = 0; s < nst; ++s) {
    load(s + 1);
    cp_async_wait<1>();
    __syncthreads();
    const float* xs = ring + (s % kMmfStages) * kMmfThreads * kMmfStride + tid * kMmfStride;
    const float* ws = sw + s * kMmfK * NP;
#pragma unroll 2
    for (int kq = 0; kq < kMmfK / 4; ++kq) {
      const float4 a = *reinterpret_cast<const float4*>(xs + 4 * kq);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 b = *reinterpret_cast<const float4*>(ws + (4 * kq + e) * NP + 4 * v);
          acc[4 * v] = fmaf(av[e], b.x, acc[4 * v]);
          acc[4 * v + 1] = fmaf(av[e], b.y, acc[4 * v + 1]);
          acc[4 * v + 2] = fmaf(av[e], b.z, acc[4 * v + 2]);
          acc[4 * v + 3] = fmaf(av[e], b.w, acc[4 * v + 3]);
        }
      }
    }
    __syncthreads();  // the slot is read no more before the next copy into it
  }
  cp_async_wait<0>();
  if (tid >= rows) return;
  float* out = y + ((size_t)g * R + row0 + tid) * N;
#pragma unroll
  for (int n = 0; n < NP; n += 2) {
    if (n >= N) break;
    const float v0 = acc[n] + sb[n], v1 = acc[n + 1] + sb[n + 1];
    if ((N & 1) == 0) {
      *reinterpret_cast<float2*>(out + n) = make_float2(v0, v1);
    } else {
      out[n] = v0;
      if (n + 1 < N) out[n + 1] = v1;
    }
  }
}

}  // namespace

extern "C" {

int gru_max_hidden() { return kMaxH; }
int gru_fwd_rows() { return kFwdRows; }
int gru_dw_chunk() { return kDwK; }
int gru_dw_tiles(int H) { return (H / kDwM) * (3 * H / kDwN); }

// the sizes the kernels take: H = kH (resident W_hh), or the wide kernels
static bool wide_hidden(int H) { return H > kH && H <= kMaxH && H % kChunk == 0; }

// Each launcher returns cudaGetLastError() after its launch (0 = success).
// blocks_per_group: the persistent grid's blocks for each group. Pointers
// 16-byte aligned.
int gru_fwd(const float* gi, const float* w_hh, const float* b_hh, const float* h0, float* y,
            float* hT, int G, int T, int B, int H, int blocks_per_group, void* stream) {
  if (H != kH || G < 1 || T < 1 || B < 1 || blocks_per_group < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(gru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gru_fwd_kernel<<<dim3(blocks_per_group, G), kFwdThreads, kFwdSmem, s>>>(gi, w_hh, b_hh, h0, y, hT,
                                                                          T, B);
  return (int)cudaGetLastError();
}

int gru_bwd(const float* gi, const float* w_hh, const float* b_hh, const float* h0,
            const float* y, const float* dy, const float* dhT, float* dgi, float* dh0,
            float* dgh_n, int G, int T, int B, int H, int blocks_per_group, void* stream) {
  if (H != kH || G < 1 || T < 1 || B < 1 || blocks_per_group < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kBwdSmem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gru_bwd_kernel<<<dim3(blocks_per_group, G), kFwdThreads, kBwdSmem, s>>>(
      gi, w_hh, b_hh, h0, y, dy, dhT, dgi, dh0, dgh_n, T, B);
  return (int)cudaGetLastError();
}

// the wide forward's shared memory at a row tile (bytes)
int gru_fwd_wide_smem(int T, int H, int rows) { return (int)wide_fwd_smem(T, H, rows); }

// the wide forward: grid (ceil(B / rows), units, G), rows in {16, 32, 64},
// units 1 or (T == 1 only) H / 128
int gru_fwd_wide(const float* gi, const float* w_hh, const float* b_hh, const float* h0, float* y,
                 float* hT, int G, int T, int B, int H, int rows, int units, void* stream) {
  if (!wide_hidden(H) || G < 1 || T < 1 || B < 1 || !(units == 1 || (T == 1 && units == H / kChunk)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wide_fwd_smem(T, H, rows);
  auto kernel = rows == 16 ? gru_fwd_wide_kernel<1> : rows == 32 ? gru_fwd_wide_kernel<2>
              : rows == 64 ? gru_fwd_wide_kernel<4> : nullptr;
  if (kernel == nullptr || smem > kSmemPerBlock) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3((B + rows - 1) / rows, units, G), kFwdThreads, smem, s>>>(gi, w_hh, b_hh, h0, y, hT, T, B, H);
  return (int)cudaGetLastError();
}

// the wide backward's shared memory at a row tile (bytes)
int gru_bwd_wide_smem(int H, int rows) { return (int)wide_bwd_smem(H, rows); }

// the wide backward's instance for a row tile, with its attribute set for
// `smem` bytes of dynamic shared memory; an error when there is none
static cudaError_t bwd_wide_instance(int H, int rows, BwdWideKernel* kernel, size_t* smem) {
  *smem = wide_bwd_smem(H, rows);
  *kernel = rows == 16 ? gru_bwd_wide_kernel<1> : rows == 32 ? gru_bwd_wide_kernel<2> : nullptr;
  if (!wide_hidden(H) || *kernel == nullptr || *smem > kSmemPerBlock) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// blocks of the wide backward an SM holds at once at a row tile, as the
// runtime computes it (negative: a CUDA error)
int gru_bwd_wide_blocks_per_sm(int H, int rows) {
  BwdWideKernel kernel;
  size_t smem;
  cudaError_t e = bwd_wide_instance(H, rows, &kernel, &smem);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kFwdThreads, smem);
  return e == cudaSuccess ? n : -(int)e;
}

// the wide backward: grid (ceil(B / rows), G), rows in {16, 32}
int gru_bwd_wide(const float* gi, const float* w_hh, const float* b_hh, const float* h0,
                 const float* y, const float* dy, const float* dhT, float* dgi, float* dh0,
                 float* dgh_n, int G, int T, int B, int H, int rows, void* stream) {
  if (G < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  BwdWideKernel kernel;
  size_t smem;
  cudaError_t e = bwd_wide_instance(H, rows, &kernel, &smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3((B + rows - 1) / rows, G), kFwdThreads, smem, s>>>(gi, w_hh, b_hh, h0, y, dy, dhT, dgi, dh0,
                                                                   dgh_n, T, B, H);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (no link against libcuda); null where it is missing
static PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a (G, rows, cols) f32 tensor whose groups lie group_stride floats apart,
// read in 32 x 32 boxes under the 128-byte swizzle; rows past `rows` and
// columns past `cols` read as zeros
static bool dw_tensor_map(CUtensorMap* map, const float* base, int cols, int rows, int G, long long group_stride) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)G};
  cuuint64_t strides[2] = {(cuuint64_t)cols * 4, (cuuint64_t)group_stride * 4};
  cuuint32_t box[3] = {kDwBox, kDwK, 1}, elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

extern "C++" {  // a template cannot have C linkage

// One operand of a long-K kernel: a (G, rows, cols) f32 tensor whose groups
// lie group_stride floats apart
struct DwOperand {
  const float* base;
  int cols, rows;
  long long group_stride;
};

// The launch of a long-K kernel (dw_pipeline): the operands' tensor maps,
// kDwSmem bytes of dynamic shared memory, and kernel(maps..., rest...) on
// grid (tiles, P, G) on the stream
template <class Kernel, size_t NM, class... Rest>
int dw_launch(Kernel kernel, const DwOperand (&ops)[NM], int G, int tiles, int P, void* stream, Rest... rest) {
  std::array<CUtensorMap, NM> maps;
  for (size_t i = 0; i < NM; ++i)
    if (!dw_tensor_map(&maps[i], ops[i].base, ops[i].cols, ops[i].rows, G, ops[i].group_stride))
      return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDwSmem);
  if (e != cudaSuccess) return (int)e;
  std::apply([&](const auto&... m) {
    kernel<<<dim3(tiles, P, G), kDwThreads, kDwSmem, static_cast<cudaStream_t>(stream)>>>(m..., rest...);
  }, maps);
  return (int)cudaGetLastError();
}

}  // extern "C++"

int gru_dw_smem() { return (int)kDwSmem; }

// the weight gradient's stages of kDwK rows over K = T * B: those of h0's
// rows, then those of y's first (T - 1) * B
int gru_dw_stages(int T, int B) { return (B + kDwK - 1) / kDwK + ((T - 1) * B + kDwK - 1) / kDwK; }

// P blocks per tile of dW_hh, each summing `rows` / gru_dw_chunk() stages
// (rows a multiple of gru_dw_chunk(), no block without one); partials (G,
// P, H * 3H + 3H)
int gru_dw(const float* h0, const float* y, const float* dgi, const float* dgh_n, float* partials,
           int G, int T, int B, int H, int P, int rows, void* stream) {
  if (!(H == kH || wide_hidden(H)) || G < 1 || T < 1 || B < 1 || P < 1 || rows < 1 || rows % kDwK)
    return (int)cudaErrorInvalidValue;
  const int spb = rows / kDwK, stages = gru_dw_stages(T, B);
  if ((long long)P * spb < stages || (long long)(P - 1) * spb >= stages) return (int)cudaErrorInvalidValue;
  const long long K = (long long)T * B;
  return dw_launch(gru_dw_kernel,
                   {{h0, H, B, (long long)B * H}, {y, H, T > 1 ? (T - 1) * B : 1, K * H},
                    {dgi, 3 * H, (int)K, K * 3 * H}, {dgh_n, H, (int)K, K * H}},
                   G, gru_dw_tiles(H), P, stream, partials, T, B, H, spb);
}

int gru_reduce(const float* partials, float* out, int G, int P, int E, void* stream) {
  if (G < 1 || P < 1 || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gru_reduce_kernel<<<dim3((E + 255) / 256, G), 256, 0, s>>>(partials, out, P, E);
  return (int)cudaGetLastError();
}

// P blocks a split, each summing `stages` of `rows` rows of K (no block
// without one): the host's check of a split of K
static bool split_ok(int K, int rows, int P, int stages) {
  const int n_stages = (K + rows - 1) / rows;
  return P >= 1 && stages >= 1 && (long long)P * stages >= n_stages && (long long)(P - 1) * stages < n_stages;
}

int grouped_dw_max_run() { return kGdwMaxRun; }
int grouped_dw_ffma_rows() { return kFfRows; }
int grouped_dw_ffma_stages() { return kFfStages; }
int grouped_dw_reduce_rows() { return kRedRows; }
int grouped_dw_ffma_smem(int bm, int bn) { return (int)ffma_smem(bm, bn); }

// x (G, K, M), dy (G, K, N), M and N multiples of 4, 16-byte aligned: the
// wgmma kernel on grid (ceil(M / 128) * ceil(N / 192), P, G), each block
// summing `stages` stages of gru_dw_chunk() rows; partials (G, P, M, N)
int grouped_dw(const float* x, const float* dy, float* partials, int G, int K, int M, int N, int P, int stages,
               void* stream) {
  if (G < 1 || K < 1 || M < 1 || N < 1 || M % 4 || N % 4 || !split_ok(K, kDwK, P, stages))
    return (int)cudaErrorInvalidValue;
  const int tiles = ((M + kDwM - 1) / kDwM) * ((N + kDwN - 1) / kDwN);
  return dw_launch(grouped_dw_kernel, {{x, M, K, (long long)K * M}, {dy, N, K, (long long)K * N}}, G, tiles, P,
                   stream, partials, K, M, N, stages);
}

// x (G, K, M), dy (G, K, N), 16-byte aligned: the FFMA kernel at tiles of
// bm x bn (powers of two >= 4, bm * bn <= 4096) on grid (ceil(M / bm) *
// ceil(N / bn), P, G), each block summing `stages` stages of
// grouped_dw_ffma_rows() rows; partials (G, P, M, N)
int grouped_dw_ffma(const float* x, const float* dy, float* partials, int G, int K, int M, int N, int bm, int bn,
                    int P, int stages, void* stream) {
  const bool pow2 = bm >= 4 && bn >= 4 && !(bm & (bm - 1)) && !(bn & (bn - 1));
  if (G < 1 || K < 1 || M < 1 || N < 1 || !pow2 || bm * bn > 16 * kFfThreads || !split_ok(K, kFfRows, P, stages))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ffma_smem(bm, bn);
  cudaError_t e = cudaFuncSetAttribute(grouped_dw_ffma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  grouped_dw_ffma_kernel<<<dim3(tiles, P, G), kFfThreads, smem, s>>>(x, dy, partials, K, M, N, __builtin_ctz(bm),
                                                                      __builtin_ctz(bn), stages);
  return (int)cudaGetLastError();
}

int grouped_dw_reduce(const float* partials, float* out, int G, int P, int E, void* stream) {
  if (G < 1 || P < 1 || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  grouped_dw_reduce_kernel<<<dim3((E + 31) / 32, G), dim3(32, kRedRows), 0, s>>>(partials, out, P, E);
  return (int)cudaGetLastError();
}

int grouped_mm_smem(int K, int bn) { return (int)mm_smem(K, bn); }
int grouped_mm_ffma_smem(int K, int np) { return (int)mm_ffma_smem(K, np); }
int grouped_mm_rows() { return kMmRows; }
int grouped_mm_groups(int chunks) { return mm_groups(chunks); }
int grouped_mm_ffma_rows() { return kMmfThreads; }

// x (G, R, K), w (G, K, N) (trans 0) or (G, N, K) (trans 1), bias (G, N) or
// null, y (G, R, N), 16-byte aligned: the wgmma kernel with columns of
// `chunks` x 64 a block (1 or 2), K in chunks of kc rows of B (a multiple of
// 32), on grid (blocks, ceil(N / (64 chunks)), G)
int grouped_mm(const float* x, const float* w, const float* bias, float* y, int G, int R, int K, int N, int trans,
               int chunks, int kc, int blocks, void* stream) {
  if (G < 1 || R < 1 || K < 1 || N < 1 || chunks < 1 || chunks > kMmMaxChunks || blocks < 1 || kc < 1 ||
      kc % kMmKBlock)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mm_smem(min(K, kc), kMmChunk * chunks);
  if (smem > kSmemPerBlock) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const float*, const float*, const float*, float*, int, int, int, int, int);
  static const Kernel kernels[kMmMaxChunks][3] = {
      {grouped_mm_kernel<1, 1>, grouped_mm_kernel<1, 2>, grouped_mm_kernel<1, 4>},
      {grouped_mm_kernel<2, 1>, grouped_mm_kernel<2, 2>, grouped_mm_kernel<2, 4>}};
  const Kernel kernel = kernels[chunks - 1][K % 4 == 0 ? 2 : K % 2 == 0 ? 1 : 0];
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int bn = kMmChunk * chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(blocks, (N + bn - 1) / bn, G), 128 * mm_groups(chunks), smem, s>>>(x, w, bias, y, R, K, N, kc,
                                                                                trans);
  return (int)cudaGetLastError();
}

// the same product by the FFMA kernel, N <= np (a multiple of 4, at most
// 32: the columns staged), on grid (ceil(R / grouped_mm_ffma_rows()), 1, G)
int grouped_mm_ffma(const float* x, const float* w, const float* bias, float* y, int G, int R, int K, int N,
                    int trans, int np, void* stream) {
  if (G < 1 || R < 1 || K < 1 || N < 1 || N > np || np % 4 || np > 32) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const float*, const float*, const float*, float*, int, int, int, int);
  static const Kernel kernels[8] = {grouped_mm_ffma_kernel<1>, grouped_mm_ffma_kernel<2>, grouped_mm_ffma_kernel<3>,
                                    grouped_mm_ffma_kernel<4>, grouped_mm_ffma_kernel<5>, grouped_mm_ffma_kernel<6>,
                                    grouped_mm_ffma_kernel<7>, grouped_mm_ffma_kernel<8>};
  const Kernel kernel = kernels[np / 4 - 1];
  const size_t smem = mm_ffma_smem(K, np);
  if (smem > kSmemPerBlock) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3((R + kMmfThreads - 1) / kMmfThreads, 1, G), kMmfThreads, smem, s>>>(x, w, bias, y, R, K, N, trans);
  return (int)cudaGetLastError();
}

}  // extern "C"
