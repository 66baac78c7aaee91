// Fused GRU recurrence over a whole sequence, forward and backward, for
// Hopper (sm_90a). Built by nvcc into a shared library with a plain C
// interface and loaded with ctypes (codebase_tpu_torch/ops/fused_gru.py).
//
// Replaces the TPU kernels of codebase_tpu/ops/fused_gru.py:
//   gru_fwd_kernel    <- _fwd_kernel (body :80-102, launched by
//                        _fused_gru_fwd_impl :225-264)
//   gru_bwd_kernel    <- _bwd_kernel (body :105-168, launched by
//                        _fused_gru_bwd :274-332)
//   gru_reduce_kernel <- the in-order dW_hh/db_hh accumulation of
//                        _bwd_kernel (:123-126, :160-167), which on the TPU is
//                        race-free only because grid steps run in order.
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
// gru_bwd_kernel. Bound by FP32 FMA issue at H = 128 (three products per
// step on CUDA cores) and, at the update shape, by the serial chain:
// - one block of H threads per (group, tile of BT batch rows); thread j
//   owns hidden unit j and reads W_hh through the L2;
// - it rematerialises the gates from h_prev = h0 || y[:-1] and gi (the TPU
//   design's trade of flops for bytes) and walks time in reverse;
// - dW_hh = sum_t h_prev^T dgh and db_hh are summed per block in shared
//   memory (each thread owns columns j, H+j, 2H+j, so there is no race) and
//   written as per-block partials into a scratch buffer.
//
// gru_reduce_kernel. Bound by bytes: it reads the P partials once (25.8 MB
// at the update shape, 0.0077 ms at 3.35 TB/s). One thread per column sums
// its P values in order p = 0, 1, ...: deterministic, no atomics. Read from
// HBM on an H100 (80GB HBM3, 700 W) it runs at about two thirds of that
// rate, as torch.sum does; 16-byte loads with more of them in flight were
// measured 4% faster there and not kept.
//
// Rows past the batch edge are masked inside the kernels; there is no
// padding of time or batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 128;       // hidden size the kernels are built for
constexpr int kH3 = 3 * kH;
constexpr int kThreads = kH;  // backward: one thread per hidden unit
constexpr int kBwdTile = 16;  // batch rows per backward tile

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

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

// An h0 tile in registers: float4 i = threadIdx.x + k * kFwdThreads holds
// row i / 32, columns 4 * (i % 32) .. +3; rows past B are zero.
__device__ __forceinline__ void load_h0_tile(float4 (&v)[kH0Vecs], const float* __restrict__ h0,
                                             int g, int B, int r0) {
#pragma unroll
  for (int k = 0; k < kH0Vecs; ++k) {
    const int i = threadIdx.x + k * kFwdThreads;
    const int row = r0 + i / 32;
    v[k] = row < B ? __ldg(reinterpret_cast<const float4*>(h0 + ((size_t)g * B + row) * kH) + i % 32)
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

// grid (blocks per group, G), kFwdThreads threads, kFwdSmem bytes of dynamic
// shared memory. Block x of group g walks the row tiles x, x + gridDim.x, ...
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
  load_h0_tile(h0v, h0, g, B, tile * kFwdRows);
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
      if (last && next < n_tiles) load_h0_tile(h0v, h0, g, B, next * kFwdRows);

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
// Backward (CUDA cores)
// ---------------------------------------------------------------------------

// (ar, az, an)[r] = tile[r, :] @ W[:, {j, H+j, 2H+j}] for BT rows
template <int BT>
__device__ __forceinline__ void gates_matmul(const float* tile, const float* __restrict__ w,
                                             int j, float (&ar)[BT], float (&az)[BT],
                                             float (&an)[BT]) {
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    ar[r] = 0.f;
    az[r] = 0.f;
    an[r] = 0.f;
  }
#pragma unroll 1
  for (int k = 0; k < kH; k += 4) {
    float wr[4], wz[4], wn[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wk = w + (k + kk) * kH3;
      wr[kk] = __ldg(wk + j);
      wz[kk] = __ldg(wk + kH + j);
      wn[kk] = __ldg(wk + 2 * kH + j);
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(tile + r * kH + k);
      ar[r] = fmaf(v.x, wr[0], ar[r]);
      ar[r] = fmaf(v.y, wr[1], ar[r]);
      ar[r] = fmaf(v.z, wr[2], ar[r]);
      ar[r] = fmaf(v.w, wr[3], ar[r]);
      az[r] = fmaf(v.x, wz[0], az[r]);
      az[r] = fmaf(v.y, wz[1], az[r]);
      az[r] = fmaf(v.z, wz[2], az[r]);
      az[r] = fmaf(v.w, wz[3], az[r]);
      an[r] = fmaf(v.x, wn[0], an[r]);
      an[r] = fmaf(v.y, wn[1], an[r]);
      an[r] = fmaf(v.z, wn[2], an[r]);
      an[r] = fmaf(v.w, wn[3], an[r]);
    }
  }
}

// grid (P, G) with P blocks per group; each block walks tiles
// blockIdx.x, blockIdx.x + P, ... and writes one partial row
// [dW_hh (H*3H) | db_hh (3H)] into partials[g, blockIdx.x].
// Dynamic shared memory: dW (H*3H) + h_prev tile (BT*H) + dgh tile (BT*3H).
template <int BT>
__global__ void __launch_bounds__(kThreads)
gru_bwd_kernel(const float* __restrict__ gi, const float* __restrict__ w_hh,
               const float* __restrict__ w_hh_t, const float* __restrict__ b_hh,
               const float* __restrict__ h0, const float* __restrict__ y,
               const float* __restrict__ dy, const float* __restrict__ dhT,
               float* __restrict__ dgi, float* __restrict__ dh0,
               float* __restrict__ partials, int T, int B) {
  extern __shared__ __align__(16) float smem[];
  float* dw_s = smem;                 // (H, 3H)
  float* hp_s = dw_s + kH * kH3;      // (BT, H)
  float* dg_s = hp_s + BT * kH;       // (BT, 3H)
  const int j = threadIdx.x;
  const int g = blockIdx.y;
  const int P = gridDim.x;
  const int n_tiles = (B + BT - 1) / BT;
  const float* w = w_hh + (size_t)g * kH * kH3;
  const float* wt = w_hh_t + (size_t)g * kH3 * kH;
  const float br = b_hh[g * kH3 + j];
  const float bz = b_hh[g * kH3 + kH + j];
  const float bn = b_hh[g * kH3 + 2 * kH + j];

  // thread j touches only dW columns j, H+j, 2H+j (kThreads * 3 == 3H)
  for (int i = j; i < kH * kH3; i += kThreads) dw_s[i] = 0.f;
  float db_r = 0.f, db_z = 0.f, db_n = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += P) {
    const int r0 = tile * BT;
    float dh[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const int row = r0 + r;
      dh[r] = row < B ? dhT[((size_t)g * B + row) * kH + j] : 0.f;
    }
    for (int t = T - 1; t >= 0; --t) {
      const size_t base = ((size_t)g * T + t) * B;
      // h_prev tile: h0 at t == 0, else y[t-1]
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const int row = r0 + r;
        float v = 0.f;
        if (row < B)
          v = t == 0 ? h0[((size_t)g * B + row) * kH + j]
                     : y[(((size_t)g * T + t - 1) * B + row) * kH + j];
        hp_s[r * kH + j] = v;
      }
      __syncthreads();

      float ar[BT], az[BT], an[BT];
      gates_matmul<BT>(hp_s, w, j, ar, az, an);

      float carry[BT];  // dh_total * z, the direct path to dh_{t-1}
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const int row = r0 + r;
        float d_r = 0.f, d_z = 0.f, d_gn = 0.f, c = 0.f;
        if (row < B) {
          const float* gir = gi + (base + row) * kH3;
          const float ghn = an[r] + bn;
          const float rg = sigmoid_f(gir[j] + (ar[r] + br));
          const float zg = sigmoid_f(gir[kH + j] + (az[r] + bz));
          const float ng = tanhf(gir[2 * kH + j] + rg * ghn);
          const float hp = hp_s[r * kH + j];
          const float dht = dy[(base + row) * kH + j] + dh[r];
          const float dn = dht * (1.f - zg);
          const float dz = dht * (hp - ng);
          const float dpre_n = dn * (1.f - ng * ng);
          const float drr = dpre_n * ghn;
          d_r = drr * rg * (1.f - rg);
          d_z = dz * zg * (1.f - zg);
          d_gn = dpre_n * rg;
          c = dht * zg;
          float* dgir = dgi + (base + row) * kH3;
          dgir[j] = d_r;
          dgir[kH + j] = d_z;
          dgir[2 * kH + j] = dpre_n;
        }
        ar[r] = d_r;  // reuse the registers for dgh
        az[r] = d_z;
        an[r] = d_gn;
        carry[r] = c;
        dg_s[r * kH3 + j] = d_r;
        dg_s[r * kH3 + kH + j] = d_z;
        dg_s[r * kH3 + 2 * kH + j] = d_gn;
        db_r += d_r;
        db_z += d_z;
        db_n += d_gn;
      }

      // dW[k, {j, H+j, 2H+j}] += sum_r h_prev[r, k] * dgh[r, {...}]
#pragma unroll 2
      for (int k = 0; k < kH; ++k) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float hk = hp_s[r * kH + k];
          s0 = fmaf(hk, ar[r], s0);
          s1 = fmaf(hk, az[r], s1);
          s2 = fmaf(hk, an[r], s2);
        }
        dw_s[k * kH3 + j] += s0;
        dw_s[k * kH3 + kH + j] += s1;
        dw_s[k * kH3 + 2 * kH + j] += s2;
      }
      __syncthreads();  // the dgh tile is complete

      // dh_{t-1}[r, j] = dh_total * z + dgh[r, :] @ W_hh[j, :]^T
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.f;
#pragma unroll 1
      for (int c = 0; c < kH3; c += 4) {
        float wv[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) wv[cc] = __ldg(wt + (c + cc) * kH + j);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(dg_s + r * kH3 + c);
          acc[r] = fmaf(v.x, wv[0], acc[r]);
          acc[r] = fmaf(v.y, wv[1], acc[r]);
          acc[r] = fmaf(v.z, wv[2], acc[r]);
          acc[r] = fmaf(v.w, wv[3], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) dh[r] = carry[r] + acc[r];
      __syncthreads();  // before the next step overwrites the tiles
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const int row = r0 + r;
      if (row < B) dh0[((size_t)g * B + row) * kH + j] = dh[r];
    }
  }

  float* out = partials + ((size_t)g * P + blockIdx.x) * (kH * kH3 + kH3);
  for (int i = j; i < kH * kH3; i += kThreads) out[i] = dw_s[i];
  out[kH * kH3 + j] = db_r;
  out[kH * kH3 + kH + j] = db_z;
  out[kH * kH3 + 2 * kH + j] = db_n;
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

int gru_kernel_hidden() { return kH; }
int gru_fwd_rows() { return kFwdRows; }
int gru_bwd_tile() { return kBwdTile; }

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

int gru_bwd(const float* gi, const float* w_hh, const float* w_hh_t, const float* b_hh,
            const float* h0, const float* y, const float* dy, const float* dhT, float* dgi,
            float* dh0, float* partials, int G, int T, int B, int H, int blocks_per_group,
            void* stream) {
  if (H != kH || G < 1 || T < 1 || B < 1 || blocks_per_group < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kH * kH3 + kBwdTile * kH + kBwdTile * kH3) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(gru_bwd_kernel<kBwdTile>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gru_bwd_kernel<kBwdTile><<<dim3(blocks_per_group, G), kThreads, smem, s>>>(
      gi, w_hh, w_hh_t, b_hh, h0, y, dy, dhT, dgi, dh0, partials, T, B);
  return (int)cudaGetLastError();
}

int gru_reduce(const float* partials, float* out, int G, int P, int E, void* stream) {
  if (G < 1 || P < 1 || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gru_reduce_kernel<<<dim3((E + 255) / 256, G), 256, 0, s>>>(partials, out, P, E);
  return (int)cudaGetLastError();
}

}  // extern "C"
