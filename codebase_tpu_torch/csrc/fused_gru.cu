// Fused GRU recurrence over a whole sequence, forward and backward, for
// Hopper (sm_90a). Built by nvcc into a shared library with a plain C
// interface and loaded with ctypes (codebase_tpu_torch/ops/fused_gru.py).
//
// Replaces the TPU kernels of codebase_tpu/ops/fused_gru.py:
//   gru_fwd_kernel    <- _fwd_kernel (body :80-102, launched by
//                        _fused_gru_fwd_impl :225-264)
//   gru_bwd_kernel    <- _bwd_kernel (body :105-168, launched by
//                        _fused_gru_bwd :274-332): the reverse-time recurrence
//   gru_dw_kernel     <- its dW_hh/db_hh products (:160-165), taken out of
//                        the recurrence as one long-K product
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
// and db_hh[g] = sum_k dgh[k] over the K = T * B rows (26,624 at the update
// shape). Bound on an H100 by bytes and operations alike (h_prev and dgh,
// 109 MB at the update shape: 0.033 ms at 3.35 TB/s; one 3xTF32 product:
// 0.032 ms at the TF32 peak); in practice by mma.sync issue and the TF32
// splits, as the recurrence. Design: each block takes a 64 x 192 tile of
// dW_hh and one share of K (about one block per SM over groups and tiles);
// 64-row chunks of h_prev and dgh go global -> shared with cp.async through
// a ring of three buffers; 8 warps of 32 x 48, 3xTF32, each 16-deep slice of
// k in a fresh accumulator added to f32 running sums, so the error does not
// grow with K. Each block writes its partial sums; no atomics. ptxas gives
// it 255 registers and spills 24 bytes; with the slice loop not unrolled it
// needs 177 and spills nothing, but measured 7% slower, as did 32-row chunks.
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
// can have, so these kernels read it from global memory (the L2, 50 MB,
// holds it: 30 MB for the ten copies of the MMM2 update at G=10) at every
// step, straight into the registers of the MMA fragments. What bounds them
// on an H100: that L2 stream (each 16-row tile reads all of W_hh per step:
// at G=10 T=121 B=256, 160 tiles x 3 MB a step) and the 3xTF32 mma.sync
// work of the tile, each of the same order. Design (simple first; a
// cluster split of W_hh over DSMEM is the redesign):
// - one block per 16-row tile of a group, all T steps (no persistent
//   grid: W_hh is not staged, so there is nothing to amortise);
// - the hidden units are walked in chunks of 128 (8 warps x 2 unit blocks
//   of 8, the H=128 kernels' warp ownership): one thread's accumulators
//   hold r, z and n of the same (row, unit), so the gates stay in registers;
// - B fragments: four scalar loads of W_hh[16kp + 4tig + i, 8nt + gid]
//   (every 32-byte sector read is used), the k order inside a 16-deep slice
//   permuted as in the H=128 kernels;
// - forward: the h tile is double-buffered in shared memory (stride H + 16,
//   16 mod 32: conflict-free A loads), since every chunk reads all of h;
// - backward: the h_prev tile and the dgh tile (16 x 3H, stride 3H + 16) in
//   shared memory; dh is carried between steps in dh0 itself, each thread
//   reading and writing only its own positions; dgh @ W_hh^T reads W_hh by
//   rows as float4 (W_hh[unit, 16kp + 4tig + 0..3]).
// gru_dw_kernel serves every H: its 64 x 192 tiles of dW_hh number
// (H / 64) * (3H / 192), 4 at H=128, 64 at H=512. It is built twice: with
// H fixed at 128 (index arithmetic folded at compile time; H at run time
// measured 6-10% slower there on an H100) and with H taken at run time.
//
// Rows past the batch edge are masked inside the kernels; there is no
// padding of time or batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 128;       // hidden size of the resident-W_hh kernels
constexpr int kH3 = 3 * kH;
constexpr int kMaxH = 896;    // the wide kernels' largest H: the backward's tiles fill shared memory

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
// Wide variants (256 <= H <= kMaxH, H % 128 == 0): W_hh read from the L2
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

// grid (ceil(B / 16), G), kFwdThreads threads, 2 * 16 * (H + 16) floats of
// dynamic shared memory: block x of group g runs row tile x over all T
// steps.
__global__ void __launch_bounds__(kFwdThreads, 2)
gru_fwd_wide_kernel(const float* __restrict__ gi, const float* __restrict__ w_hh,
                    const float* __restrict__ b_hh, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ hT, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int s = H + 16;  // 16 mod 32
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = blockIdx.y, r0 = blockIdx.x * kFwdRows;
  const int H3 = 3 * H, chunks = H / kChunk;
  const float* w = w_hh + (size_t)g * H * H3;
  const float* bg = b_hh + (size_t)g * H3;
  float* hbuf[2] = {smem, smem + kFwdRows * s};
  load_tile_wide(hbuf[0], s, h0 + (size_t)g * B * H, B, r0, H);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t base = ((size_t)g * T + t) * B;
    const float* hs = hbuf[t & 1];
    float* hn_s = hbuf[(t & 1) ^ 1];
    const bool last = t == T - 1;
    for (int uc = 0; uc < chunks; ++uc) {
      float2 gv[2][kNJ];
      wide_gi(gv, gi + base * H3, B, r0, H, uc, warp, gid, tig);
      float acc[kNJ][4];
      wide_bias(acc, bg, H, uc, warp, tig);
      wide_product(acc, hs, s, w, H, uc, warp, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lr = gid + 8 * half, row = r0 + lr;
        const int c = 2 * half;
#pragma unroll
        for (int u = 0; u < kUB; ++u) {
          const int unit = wide_unit(uc, warp, u, tig);
          const float2 hp = *reinterpret_cast<const float2*>(hs + lr * s + unit);
          const float2 gr = gv[half][3 * u], gz = gv[half][3 * u + 1], gn = gv[half][3 * u + 2];
          float2 hn;
          hn.x = gru_gate(gr.x, gz.x, gn.x, acc[3 * u][c], acc[3 * u + 1][c], acc[3 * u + 2][c], hp.x);
          hn.y = gru_gate(gr.y, gz.y, gn.y, acc[3 * u][c + 1], acc[3 * u + 1][c + 1],
                          acc[3 * u + 2][c + 1], hp.y);
          // the next step's tile: a buffer no chunk of this step reads
          *reinterpret_cast<float2*>(hn_s + lr * s + unit) = hn;
          if (row < B) {
            *reinterpret_cast<float2*>(y + (base + row) * H + unit) = hn;
            if (last) *reinterpret_cast<float2*>(hT + ((size_t)g * B + row) * H + unit) = hn;
          }
        }
      }
    }
    __syncthreads();  // the next step's tile is complete; every read of this one is done
  }
}

// grid (ceil(B / 16), G), kFwdThreads threads, 16 * (4H + 32) floats of
// dynamic shared memory: block x of group g runs row tile x in reverse
// time. Writes dgi, dgh_n and dh0, which carries dh between steps.
__global__ void __launch_bounds__(kFwdThreads, 1)
gru_bwd_wide_kernel(const float* __restrict__ gi, const float* __restrict__ w_hh,
                    const float* __restrict__ b_hh, const float* __restrict__ h0,
                    const float* __restrict__ y, const float* __restrict__ dy,
                    const float* __restrict__ dhT, float* __restrict__ dgi,
                    float* __restrict__ dh0, float* __restrict__ dgh_n, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int s = H + 16, ds_s = 3 * H + 16;  // both 16 mod 32
  float* hs = smem;                         // (16, s) h_prev tile
  float* ds = smem + kFwdRows * s;          // (16, ds_s) dgh tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = blockIdx.y, r0 = blockIdx.x * kFwdRows;
  const int H3 = 3 * H, chunks = H / kChunk;
  const float* w = w_hh + (size_t)g * H * H3;
  const float* bg = b_hh + (size_t)g * H3;
  const float* yg = y + (size_t)g * T * B * H;
  const float* h0g = h0 + (size_t)g * B * H;
  float* dhg = dh0 + (size_t)g * B * H;  // dh at this thread's positions
  for (int uc = 0; uc < chunks; ++uc)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + gid + 8 * half;
#pragma unroll
      for (int u = 0; u < kUB; ++u) {
        const size_t at = (size_t)row * H + wide_unit(uc, warp, u, tig);
        if (row < B)
          *reinterpret_cast<float2*>(dhg + at) =
              __ldg(reinterpret_cast<const float2*>(dhT + (size_t)g * B * H + at));
      }
    }
  load_tile_wide(hs, s, T > 1 ? yg + (size_t)(T - 2) * B * H : h0g, B, r0, H);
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const size_t base = ((size_t)g * T + t) * B;
    // the gates' backward, chunk by chunk: dgi and dgh_n out, dgh into the
    // tile, dh_total * z (the direct path to dh_{t-1}) into dh0
    for (int uc = 0; uc < chunks; ++uc) {
      float2 gv[2][kNJ];
      wide_gi(gv, gi + base * H3, B, r0, H, uc, warp, gid, tig);
      float acc[kNJ][4];
      wide_bias(acc, bg, H, uc, warp, tig);
      wide_product(acc, hs, s, w, H, uc, warp, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lr = gid + 8 * half, row = r0 + lr;
        const int c = 2 * half;
#pragma unroll
        for (int u = 0; u < kUB; ++u) {
          const int unit = wide_unit(uc, warp, u, tig);
          const float2 hp = *reinterpret_cast<const float2*>(hs + lr * s + unit);
          float2 dht = make_float2(0.f, 0.f);
          if (row < B) {
            const float2 dyv = __ldg(reinterpret_cast<const float2*>(dy + (base + row) * H + unit));
            const float2 dhv = *reinterpret_cast<const float2*>(dhg + (size_t)row * H + unit);
            dht = make_float2(dyv.x + dhv.x, dyv.y + dhv.y);
          }
          const float2 xr = gv[half][3 * u], xz = gv[half][3 * u + 1], xn = gv[half][3 * u + 2];
          float2 d_r, d_z, d_n, d_gn, carry;
          gru_gate_bwd(xr.x, xz.x, xn.x, acc[3 * u][c], acc[3 * u + 1][c], acc[3 * u + 2][c], hp.x,
                       dht.x, d_r.x, d_z.x, d_n.x, d_gn.x, carry.x);
          gru_gate_bwd(xr.y, xz.y, xn.y, acc[3 * u][c + 1], acc[3 * u + 1][c + 1],
                       acc[3 * u + 2][c + 1], hp.y, dht.y, d_r.y, d_z.y, d_n.y, d_gn.y, carry.y);
          // rows past B: dht is zero, so every gradient there is zero
          *reinterpret_cast<float2*>(ds + lr * ds_s + unit) = d_r;
          *reinterpret_cast<float2*>(ds + lr * ds_s + H + unit) = d_z;
          *reinterpret_cast<float2*>(ds + lr * ds_s + 2 * H + unit) = d_gn;
          if (row < B) {
            float* dgir = dgi + (base + row) * H3 + unit;
            *reinterpret_cast<float2*>(dgir) = d_r;
            *reinterpret_cast<float2*>(dgir + H) = d_z;
            *reinterpret_cast<float2*>(dgir + 2 * H) = d_n;
            *reinterpret_cast<float2*>(dgh_n + (base + row) * H + unit) = d_gn;
            *reinterpret_cast<float2*>(dhg + (size_t)row * H + unit) = carry;
          }
        }
      }
    }
    __syncthreads();  // the dgh tile is complete; every read of the h_prev tile is done
    if (t > 0) load_tile_wide(hs, s, t > 1 ? yg + (size_t)(t - 2) * B * H : h0g, B, r0, H);

    // dh_{t-1} = dh_total * z + dgh @ W_hh^T, on the same (row, unit)
    // positions as the gates: B fragments W_hh[unit, 16kp + 4tig + 0..3]
    for (int uc = 0; uc < chunks; ++uc) {
      float dacc[kUB][4] = {};
      const float* wr[kUB];
#pragma unroll
      for (int u = 0; u < kUB; ++u)
        wr[u] = w + (size_t)(uc * kChunk + (warp * kUB + u) * 8 + gid) * H3 + 4 * tig;
#pragma unroll 2
      for (int kp = 0; kp < H3 / 16; ++kp) {
        const float4 lo = *reinterpret_cast<const float4*>(ds + gid * ds_s + kp * 16 + 4 * tig);
        const float4 hi = *reinterpret_cast<const float4*>(ds + (gid + 8) * ds_s + kp * 16 + 4 * tig);
        uint32_t ab[2][4], as[2][4];
        split_a(lo, hi, ab, as);
#pragma unroll
        for (int u = 0; u < kUB; ++u) {
          const float4 wv = __ldg(reinterpret_cast<const float4*>(wr[u] + kp * 16));
          uint32_t bb[2][2], bs[2][2];
          split_b(wv.x, wv.y, wv.z, wv.w, bb, bs);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32_slice(part, ab, as, bb, bs);
#pragma unroll
          for (int i = 0; i < 4; ++i) dacc[u][i] += part[i];
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + gid + 8 * half;
#pragma unroll
        for (int u = 0; u < kUB; ++u) {
          float2* at = reinterpret_cast<float2*>(dhg + (size_t)row * H + wide_unit(uc, warp, u, tig));
          if (row < B) {
            const float2 carry = *at;
            *at = make_float2(carry.x + dacc[u][2 * half], carry.y + dacc[u][2 * half + 1]);
          }
        }
      }
    }
    __syncthreads();  // the next h_prev tile has landed; every read of the dgh tile is done
  }
}

// ---------------------------------------------------------------------------
// Backward, kernel 2: dW_hh = sum_k h_prev[k]^T dgh[k], a long-K product
// (tensor cores, 3xTF32)
// ---------------------------------------------------------------------------

constexpr int kDwK = 64;              // rows of k per staged chunk
constexpr int kDwM = 64, kDwN = 192;  // a block's tile of dW_hh (H x 3H)
constexpr int kDwHS = kDwM + 8;       // staged row strides, 8 mod 32: the
constexpr int kDwGS = kDwN + 8;       // scalar fragment loads are conflict-free
constexpr int kDwStage = kDwK * (kDwHS + kDwGS);
constexpr int kDwStages = 3;          // chunks in flight: a ring of staged buffers
constexpr size_t kDwSmem = kDwStages * kDwStage * sizeof(float);

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

// grid (P, (H / kDwM) * (3H / kDwN), G), kFwdThreads threads, kDwSmem
// bytes of dynamic shared memory. kHc: the hidden size fixed at compile
// time (kH: the H=128 instance, whose index arithmetic folds to shifts),
// or 0 to take it from h_size at run time (the wide sizes). Block (p, tile, g) sums rows [p * rows, (p + 1) * rows) of
// k over T * B for its kDwM x kDwN tile of dW_hh[g], and writes them into
// partials[g, p] (laid out [dW_hh (H x 3H) | db_hh (3H)]); the blocks of the
// first row of tiles also sum db_hh over their columns. Row k of h_prev is
// h0[g, k] for k < B, else row k - B of y[g] (time-major over (T, B)); row k
// of dgh is [dgi[g, k, :2H] | dgh_n[g, k]].
template <int kHc>
__global__ void __launch_bounds__(kFwdThreads, 1)
gru_dw_kernel(const float* __restrict__ h0, const float* __restrict__ y,
              const float* __restrict__ dgi, const float* __restrict__ dgh_n,
              float* __restrict__ partials, int T, int B, int h_size, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int H = kHc ? kHc : h_size;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int p = blockIdx.x, g = blockIdx.z;
  const int H3 = 3 * H, tiles_n = H3 / kDwN;
  const int m0 = (blockIdx.y / tiles_n) * kDwM, n0 = (blockIdx.y % tiles_n) * kDwN;
  const int K = T * B;
  const int k0 = p * rows, k1 = min(K, k0 + rows);
  const int n_chunks = k1 > k0 ? (k1 - k0 + kDwK - 1) / kDwK : 0;
  const float* h0g = h0 + (size_t)g * B * H;
  const float* yg = y + (size_t)g * T * B * H;
  const float* dgig = dgi + (size_t)g * K * H3;
  const float* dgng = dgh_n + (size_t)g * K * H;

  // chunk c (rows k0 + c * kDwK, ...) into buf: h_prev rows at stride kDwHS, then dgh rows
  auto stage = [&](int c, float* buf) {
    const int kc = k0 + c * kDwK;
    for (int i = tid; i < kDwK * kDwM / 4; i += kFwdThreads) {
      const int rr = i / (kDwM / 4), q = i % (kDwM / 4), k = kc + rr;
      const bool ok = k < k1;
      const float* row = k < B ? h0g + (size_t)k * H : yg + (size_t)(k - B) * H;
      cp_async16(buf + rr * kDwHS + 4 * q, ok ? row + m0 + 4 * q : h0g, ok);
    }
    float* gs = buf + kDwK * kDwHS;
    for (int i = tid; i < kDwK * kDwN / 4; i += kFwdThreads) {
      const int rr = i / (kDwN / 4), q = i % (kDwN / 4), k = kc + rr, col = n0 + 4 * q;
      const bool ok = k < k1;
      const float* src = col < 2 * H ? dgig + (size_t)k * H3 + col : dgng + (size_t)k * H + col - 2 * H;
      cp_async16(gs + rr * kDwGS + 4 * q, ok ? src : dgig, ok);
    }
  };

  const int wm = warp / 4, wn = warp % 4;  // warp tile: 32 rows of m x 48 columns of n
  const bool do_db = m0 == 0 && tid < kDwN;
  float acc[2][6][4] = {};
  float db = 0.f;  // column n0 + tid of db_hh
  // a ring of kDwStages buffers: chunks c + 1 .. c + kDwStages - 1 load
  // while chunk c is summed
#pragma unroll
  for (int c = 0; c < kDwStages - 1; ++c) {
    if (c < n_chunks) stage(c, smem + c * kDwStage);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    const int cn = c + kDwStages - 1;
    if (cn < n_chunks) stage(cn, smem + (cn % kDwStages) * kDwStage);
    cp_async_commit();
    const float* hsb = smem + (c % kDwStages) * kDwStage;
    const float* gsb = hsb + kDwK * kDwHS;
    // each 16-deep slice of k in a fresh accumulator, added to acc in f32
#pragma unroll
    for (int sl = 0; sl < kDwK / 16; ++sl) {
      float part[2][6][4] = {};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int kk = sl * 16 + ks * 8;
        // A = h_prev^T: a0 (m gid, k tig), a1 (m gid + 8, k tig), a2/a3 at k tig + 4
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* a = hsb + (kk + tig) * kDwHS + wm * 32 + mi * 16 + gid;
          split_tf32(a[0], ab[mi][0], as[mi][0]);
          split_tf32(a[8], ab[mi][1], as[mi][1]);
          split_tf32(a[4 * kDwHS], ab[mi][2], as[mi][2]);
          split_tf32(a[4 * kDwHS + 8], ab[mi][3], as[mi][3]);
        }
        // B = dgh: b0 (k tig, n gid), b1 (k tig + 4, n gid)
        uint32_t bb[6][2], bs[6][2];
#pragma unroll
        for (int ni = 0; ni < 6; ++ni) {
          const float* b = gsb + (kk + tig) * kDwGS + wn * 48 + ni * 8 + gid;
          split_tf32(b[0], bb[ni][0], bs[ni][0]);
          split_tf32(b[4 * kDwGS], bb[ni][1], bs[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 6; ++ni) {
            mma_tf32(part[mi][ni], as[mi], bb[ni]);
            mma_tf32(part[mi][ni], ab[mi], bs[ni]);
            mma_tf32(part[mi][ni], ab[mi], bb[ni]);
          }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 6; ++ni)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mi][ni][i] += part[mi][ni][i];
    }
    if (do_db) {
#pragma unroll 8
      for (int rr = 0; rr < kDwK; ++rr) db += gsb[rr * kDwGS + tid];
    }
  }

  float* out = partials + ((size_t)g * gridDim.x + p) * ((size_t)H * H3 + H3);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 6; ++ni) {
      const int m = m0 + wm * 32 + mi * 16 + gid, n = n0 + wn * 48 + ni * 8 + 2 * tig;
      *reinterpret_cast<float2*>(out + (size_t)m * H3 + n) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(out + (size_t)(m + 8) * H3 + n) = make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  if (do_db) out[(size_t)H * H3 + n0 + tid] = db;
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

// the wide variants: one block per 16-row tile of each group
int gru_fwd_wide(const float* gi, const float* w_hh, const float* b_hh, const float* h0, float* y,
                 float* hT, int G, int T, int B, int H, void* stream) {
  if (!wide_hidden(H) || G < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * kFwdRows * (H + 16) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(gru_fwd_wide_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gru_fwd_wide_kernel<<<dim3((B + kFwdRows - 1) / kFwdRows, G), kFwdThreads, smem, s>>>(
      gi, w_hh, b_hh, h0, y, hT, T, B, H);
  return (int)cudaGetLastError();
}

int gru_bwd_wide(const float* gi, const float* w_hh, const float* b_hh, const float* h0,
                 const float* y, const float* dy, const float* dhT, float* dgi, float* dh0,
                 float* dgh_n, int G, int T, int B, int H, void* stream) {
  if (!wide_hidden(H) || G < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kFwdRows * (4 * H + 32) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(gru_bwd_wide_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gru_bwd_wide_kernel<<<dim3((B + kFwdRows - 1) / kFwdRows, G), kFwdThreads, smem, s>>>(
      gi, w_hh, b_hh, h0, y, dy, dhT, dgi, dh0, dgh_n, T, B, H);
  return (int)cudaGetLastError();
}

// P blocks per tile of dW_hh, each summing `rows` rows of k (a multiple of
// gru_dw_chunk()); partials (G, P, H * 3H + 3H)
int gru_dw(const float* h0, const float* y, const float* dgi, const float* dgh_n, float* partials,
           int G, int T, int B, int H, int P, int rows, void* stream) {
  if (!(H == kH || wide_hidden(H)) || G < 1 || T < 1 || B < 1 || P < 1 || rows < 1 || rows % kDwK ||
      (long long)P * rows < (long long)T * B)
    return (int)cudaErrorInvalidValue;
  auto kernel = H == kH ? gru_dw_kernel<kH> : gru_dw_kernel<0>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDwSmem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(P, gru_dw_tiles(H), G), kFwdThreads, kDwSmem, s>>>(h0, y, dgi, dgh_n, partials, T, B, H,
                                                                   rows);
  return (int)cudaGetLastError();
}

int gru_reduce(const float* partials, float* out, int G, int P, int E, void* stream) {
  if (G < 1 || P < 1 || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gru_reduce_kernel<<<dim3((E + 255) / 256, G), 256, 0, s>>>(partials, out, P, E);
  return (int)cudaGetLastError();
}

}  // extern "C"
