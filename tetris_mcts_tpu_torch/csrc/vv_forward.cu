// The VV net's forward straight from bit-packed boards, hand-written for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (tetris_mcts_tpu_torch/ops/build.py, ops/vv_forward.py).
//
// Replaces the Pallas TPU kernel of tetris_mcts_tpu/ops/vv_forward.py
// (`_kernel` -> `_forward_block`, launched by `vv_forward_packed`):
//
//   packed u32[20] -> image {0, 1 locked, -1 piece}   (the piece bit wins)
//   -> conv 3x3 1->32 + ReLU   20x10 -> 18x8
//   -> conv 3x3 32->32 + ReLU  18x8  -> 16x6
//   -> conv 3x3 32->32 + ReLU  16x6  -> 14x4
//   -> FC 1792 -> 256 + ReLU -> FC 256 -> 2 -> sigmoid * ubound + lbound
//
// Weights are the port's VVNet (models/nets.py) as they are: conv weights
// OIHW, fc weights (out, in), and fc1's input in the NCHW flatten order
// (c, y, x) that `params_from_jax` gives them.
//
// What bounds it on this card: operations. A board takes 1,901,568
// multiply-adds (3.8 MFLOP) and moves 80 bytes in and 8 out; the weights
// (1.9 MB) are read from L2 by every block. Design, the simple one: one
// block of 256 threads per tile of kTile boards. The block stages the conv2
// and conv3 weights in shared memory, transposed to [c_in][tap][c_out] so
// the 32 lanes of a warp (one output channel each) read consecutive words,
// and runs each board of its tile through the conv ladder in two shared
// ping-pong buffers (HWC layout: a warp reads one activation, broadcast).
// Only each board's 1792 conv3 outputs are kept; FC1 then runs across the
// tile, a warp per output unit with its lanes striding the 1792 inputs, so
// each fc1 weight is read once per tile and not once per board. Float32
// throughout, outside the tensor cores. Built without --fmad=false: its
// contract is a tolerance, not bit-exactness (ops/build.py).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tmt_vv {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4;  // boards per block
constexpr int kC = 32;    // conv channels
constexpr int kH0 = 20, kW0 = 10;
constexpr int kH1 = 18, kW1 = 8;
constexpr int kH2 = 16, kW2 = 6;
constexpr int kH3 = 14, kW3 = 4;
constexpr int kFeat = kC * kH3 * kW3;  // 1792
constexpr int kHid = 256;
constexpr int kOut = 2;

// shared memory, in floats
constexpr int kSmW = kC * 9 * kC;        // one transposed 32->32 conv kernel
constexpr int kSmW1 = 9 * kC;            // transposed conv1 kernel
constexpr int kSmImg = kH0 * kW0;
constexpr int kSmA1 = kH1 * kW1 * kC;
constexpr int kSmA2 = kH2 * kW2 * kC;
constexpr int kSmFloats = 2 * kSmW + kSmW1 + kSmImg + kSmA1 + kSmA2 +
                          kTile * kFeat + kTile * kHid;
constexpr int kSmBytes = kSmFloats * 4;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One 3x3 VALID conv, 32 -> 32 channels, + bias + ReLU, on HWC buffers:
// out[(y * Wo + x) * 32 + c]. wT is [c_in][tap][c_out].
__device__ __forceinline__ void conv32(const float* in, int Wi, float* out,
                                       int Ho, int Wo, const float* wT,
                                       const float* __restrict__ bias) {
  const int c = threadIdx.x & 31;
  const float bc = bias[c];
  for (int o = threadIdx.x; o < Ho * Wo * kC; o += kThreads) {
    const int p = o >> 5;
    const int y = p / Wo, x = p - (p / Wo) * Wo;
    float acc = bc;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        const float* a = in + ((y + dy) * Wi + (x + dx)) * kC;
        const float* w = wT + (dy * 3 + dx) * kC + c;
        for (int ci = 0; ci < kC; ++ci) acc += a[ci] * w[ci * 9 * kC];
      }
    out[o] = fmaxf(acc, 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
vv_forward_kernel(const uint32_t* __restrict__ packed, int n,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ w3, const float* __restrict__ b3,
                  const float* __restrict__ wf1, const float* __restrict__ bf1,
                  const float* __restrict__ wf2, const float* __restrict__ bf2,
                  const float* __restrict__ ubound,
                  const float* __restrict__ lbound, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* w2T = sm;
  float* w3T = w2T + kSmW;
  float* w1T = w3T + kSmW;
  float* img = w1T + kSmW1;
  float* a1 = img + kSmImg;
  float* a2 = a1 + kSmA1;
  float* feat = a2 + kSmA2;    // [kTile][1792], (c, y, x) order
  float* hid = feat + kTile * kFeat;  // [kTile][256]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int board0 = blockIdx.x * kTile;

  // weights: OIHW (co, ci, dy, dx) -> [ci][dy * 3 + dx][co]
  for (int i = tid; i < kSmW; i += kThreads) {
    const int co = i / (kC * 9), r = i - co * (kC * 9);  // r = ci * 9 + tap
    w2T[r * kC + co] = w2[i];
    w3T[r * kC + co] = w3[i];
  }
  for (int i = tid; i < kSmW1; i += kThreads) {
    const int co = i / 9, tap = i - co * 9;
    w1T[tap * kC + co] = w1[i];
  }

  for (int t = 0; t < kTile; ++t) {
    const int bd = board0 + t;
    float* f = feat + t * kFeat;
    if (bd >= n) {  // ragged edge: a zero board, never written out
      for (int i = tid; i < kFeat; i += kThreads) f[i] = 0.0f;
      continue;
    }
    __syncthreads();  // weights staged; img and a1 free again
    for (int i = tid; i < kSmImg; i += kThreads) {
      const int r = i / kW0, col = i - r * kW0;
      const uint32_t w = packed[(size_t)bd * kH0 + r];
      const float locked = (float)((w >> col) & 1u);
      img[i] = ((w >> (col + 10)) & 1u) ? -1.0f : locked;
    }
    __syncthreads();
    {  // conv1: 1 -> 32
      const int c = tid & 31;
      const float bc = b1[c];
      for (int o = tid; o < kSmA1; o += kThreads) {
        const int p = o >> 5;
        const int y = p / kW1, x = p - (p / kW1) * kW1;
        float acc = bc;
        for (int dy = 0; dy < 3; ++dy)
          for (int dx = 0; dx < 3; ++dx)
            acc += img[(y + dy) * kW0 + x + dx] * w1T[(dy * 3 + dx) * kC + c];
        a1[o] = fmaxf(acc, 0.0f);
      }
    }
    __syncthreads();
    conv32(a1, kW1, a2, kH2, kW2, w2T, b2);
    __syncthreads();
    // conv3 straight into the kept features, NCHW flatten (c, y, x)
    {
      const int c = tid & 31;
      const float bc = b3[c];
      for (int o = tid; o < kH3 * kW3 * kC; o += kThreads) {
        const int p = o >> 5;
        const int y = p / kW3, x = p - (p / kW3) * kW3;
        float acc = bc;
        for (int dy = 0; dy < 3; ++dy)
          for (int dx = 0; dx < 3; ++dx) {
            const float* a = a2 + ((y + dy) * kW2 + (x + dx)) * kC;
            const float* w = w3T + (dy * 3 + dx) * kC + c;
            for (int ci = 0; ci < kC; ++ci) acc += a[ci] * w[ci * 9 * kC];
          }
        f[c * (kH3 * kW3) + p] = fmaxf(acc, 0.0f);
      }
    }
  }
  __syncthreads();

  // FC1 across the tile: warp per output unit, lanes stride the inputs
  for (int j = warp; j < kHid; j += kWarps) {
    const float* wr = wf1 + (size_t)j * kFeat;
    float acc[kTile];
    for (int t = 0; t < kTile; ++t) acc[t] = 0.0f;
    for (int k = lane; k < kFeat; k += 32) {
      const float w = wr[k];
      for (int t = 0; t < kTile; ++t) acc[t] += w * feat[t * kFeat + k];
    }
    for (int t = 0; t < kTile; ++t) {
      const float s = warp_sum(acc[t]);
      if (lane == 0) hid[t * kHid + j] = fmaxf(s + bf1[j], 0.0f);
    }
  }
  __syncthreads();

  // FC2 + sigmoid * ubound + lbound: warp per (board, output)
  for (int q = warp; q < kTile * kOut; q += kWarps) {
    const int t = q / kOut, o = q - t * kOut;
    const int bd = board0 + t;
    float acc = 0.0f;
    for (int k = lane; k < kHid; k += 32) acc += wf2[o * kHid + k] * hid[t * kHid + k];
    acc = warp_sum(acc);
    if (lane == 0 && bd < n) {
      const float z = acc + bf2[o];
      out[(size_t)bd * kOut + o] = 1.0f / (1.0f + expf(-z)) * ubound[o] + lbound[o];
    }
  }
}

}  // namespace tmt_vv

using namespace tmt_vv;

extern "C" {

// out (n, 2) float32 = [value, variance] per board.
int vv_forward(const void* packed, const void* w1, const void* b1,
               const void* w2, const void* b2, const void* w3, const void* b3,
               const void* wf1, const void* bf1, const void* wf2,
               const void* bf2, const void* ubound, const void* lbound,
               void* out, int n, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      vv_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmBytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + kTile - 1) / kTile;
  vv_forward_kernel<<<grid, kThreads, kSmBytes, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, n, (const float*)w1, (const float*)b1,
      (const float*)w2, (const float*)b2, (const float*)w3, (const float*)b3,
      (const float*)wf1, (const float*)bf1, (const float*)wf2,
      (const float*)bf2, (const float*)ubound, (const float*)lbound,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
