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
// What bounds them on an H100: at the slice's shapes (H = 128) both are
// bound by FP32 FMA issue, not by bytes: each step does 2*B*H*3H flops per
// group against 4*(3H + H) bytes per row (~96 flops per byte, above the
// ~20 flops/byte where 67 TFLOP/s FP32 meets 3.35 TB/s). At the update shape
// (G=2, T=26, B=1024) the serial chain over T adds latency: only G*B/BT
// blocks can work at once, each walking all T steps.
//
// What the design does about it (a simple, correct first version):
// - one block of H threads per (group, tile of BT batch rows); thread j owns
//   hidden unit j, so it computes the three gate pre-activations of column
//   j for all BT rows and applies the gate itself: no second pass;
// - the carry h stays on chip for all T steps (registers for the thread's
//   own column, a BT x H shared-memory tile that all threads read as float4
//   broadcasts for the matmul);
// - W_hh is read from global memory with __ldg; at 192 KB per group it
//   stays in the 50 MB L2. Staging it in shared memory, TF32/bf16 wgmma and
//   clusters are later work;
// - the backward rematerialises the gates from h_prev = h0 || y[:-1] and gi
//   (the TPU design's trade of flops for bytes) and walks time in reverse;
// - dW_hh = sum_t h_prev^T dgh and db_hh are summed per block in shared
//   memory (each thread owns columns j, H+j, 2H+j, so there is no race),
//   written as per-block partials into a scratch buffer, and summed by
//   gru_reduce_kernel in a fixed order: deterministic, no atomics.
// Rows past the batch edge are masked inside the kernels; there is no
// padding of time or batch.

#include <cuda_runtime.h>

namespace {

constexpr int kH = 128;       // hidden size the kernels are built for
constexpr int kH3 = 3 * kH;
constexpr int kThreads = kH;  // one thread per hidden unit
constexpr int kBwdTile = 16;  // batch rows per backward tile

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

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

// grid (ceil(B / BT), G), block kH threads
template <int BT>
__global__ void __launch_bounds__(kThreads)
gru_fwd_kernel(const float* __restrict__ gi, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ hT, int T, int B) {
  __shared__ __align__(16) float hs[BT * kH];
  const int j = threadIdx.x;
  const int g = blockIdx.y;
  const int r0 = blockIdx.x * BT;
  const float* w = w_hh + (size_t)g * kH * kH3;
  const float br = b_hh[g * kH3 + j];
  const float bz = b_hh[g * kH3 + kH + j];
  const float bn = b_hh[g * kH3 + 2 * kH + j];

  float h_own[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    const int row = r0 + r;
    const float v = row < B ? h0[((size_t)g * B + row) * kH + j] : 0.f;
    h_own[r] = v;
    hs[r * kH + j] = v;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float ar[BT], az[BT], an[BT];
    gates_matmul<BT>(hs, w, j, ar, az, an);
    __syncthreads();  // every thread has read this step's h tile
    const size_t base = ((size_t)g * T + t) * B;
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const int row = r0 + r;
      if (row < B) {
        const float* gir = gi + (base + row) * kH3;
        const float rg = sigmoid_f(gir[j] + (ar[r] + br));
        const float zg = sigmoid_f(gir[kH + j] + (az[r] + bz));
        const float ng = tanhf(gir[2 * kH + j] + rg * (an[r] + bn));
        const float hn = (1.f - zg) * ng + zg * h_own[r];
        h_own[r] = hn;
        hs[r * kH + j] = hn;
        y[(base + row) * kH + j] = hn;
      }
    }
    __syncthreads();  // the new h tile is complete
  }
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    const int row = r0 + r;
    if (row < B) hT[((size_t)g * B + row) * kH + j] = h_own[r];
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
int gru_bwd_tile() { return kBwdTile; }

// Each launcher returns cudaGetLastError() after its launch (0 = success).
int gru_fwd(const float* gi, const float* w_hh, const float* b_hh, const float* h0, float* y,
            float* hT, int G, int T, int B, int H, int tile, void* stream) {
  if (H != kH || G < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 32) {
    gru_fwd_kernel<32><<<dim3((B + 31) / 32, G), kThreads, 0, s>>>(gi, w_hh, b_hh, h0, y, hT, T, B);
  } else if (tile == 8) {
    gru_fwd_kernel<8><<<dim3((B + 7) / 8, G), kThreads, 0, s>>>(gi, w_hh, b_hh, h0, y, hT, T, B);
  } else {
    return (int)cudaErrorInvalidValue;
  }
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
