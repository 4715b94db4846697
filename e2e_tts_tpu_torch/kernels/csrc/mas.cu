// Width-1 monotonic alignment search (MAS) for NVIDIA Hopper (sm_90a).
//
// Replaces: the JAX package's `_mas_single` (e2e_tts_tpu/ops/mas.py:21-77),
// a `lax.scan` over mel frames vmapped over the batch, which the training step
// runs once per step on the aligner's soft attention.  In eager PyTorch the
// scan would be a Python loop of several launches per frame; here one launch
// does the whole batch.
//
// What it computes, for each utterance b with text_len tl and mel_len ml
// (clamped to [0, L] and [0, T]), on log_attn (B, T, L) float32:
//   la[i][j]   = j < tl ? log_attn[i][j] : -1e30
//   p_0[j]     = j == 0 ? la[0][0] : -1e30
//   p_i[j]     = la[i][j] + max(p_{i-1}[j-1], p_{i-1}[j])     (1 <= i < ml)
//   left_i[j]  = p_{i-1}[j-1] >= p_{i-1}[j]                   (p_{i-1}[-1] = -1e30)
// then a backtrack from (ml - 1, tl - 1) that steps left where left_i is set,
// a one-hot per valid frame, frame 0 anchored to phoneme 0, columns >= tl
// zeroed.  Every step is one float add and an exact max, so the result is
// bit-equal to the plain version (kernels/mas.py `mas_plain`) and to JAX.
// A negative column in the backtrack (possible only when log_attn itself
// holds -1e30 sentinels in column 0) indexes `left` from the end, as JAX's
// gather does, and writes no one-hot.
//
// What bounds it: a dependency chain of ml frames.  The arithmetic (one add
// and one max per cell) and the bytes (log_attn read once, the 0/1 map written
// once) are microseconds at training shapes; the serial depth is the cost.
// Design against that:
//   - one block per utterance, the text axis across its threads (up to 1024,
//     more columns per thread past that), one __syncthreads a frame between
//     two score rows in shared memory;
//   - log_attn is staged into shared memory CHUNK frames at a time by
//     cp.async, the next chunk in flight while this one is consumed, so no
//     frame waits on device memory;
//   - the `left` bits (T x L bits, 32 KB at T = 1024, L = 256) are made by a
//     warp ballot and kept in shared memory;
//   - one thread backtracks over the bits into a column per frame, then the
//     whole block writes the 0/1 map, coalesced.
// Frames at or past mel_len cost nothing.
//
// C entry point: mas_f32(log_attn, text_lens, mel_lens, out, B, T, L, stream)
// returns the CUDA error of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "stage.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int CHUNK = 16;  // frames of log_attn staged per cp.async group

__global__ void mas_kernel(const float* __restrict__ log_attn, const int* __restrict__ text_lens,
                           const int* __restrict__ mel_lens, float* __restrict__ out, int T, int L,
                           int words) {
  extern __shared__ float smem[];
  float* stage = smem;                     // [2][CHUNK * L]
  float* rows = stage + 2 * CHUNK * L;     // [2][L]
  int* path = reinterpret_cast<int*>(rows + 2 * L);           // [T]
  uint32_t* bits = reinterpret_cast<uint32_t*>(path + T);     // [T][words]

  const int b = blockIdx.x;
  const float* la = log_attn + static_cast<size_t>(b) * T * L;
  float* o = out + static_cast<size_t>(b) * T * L;
  const int tl = min(max(text_lens[b], 0), L);
  const int ml = min(max(mel_lens[b], 0), T);
  const int lane = threadIdx.x & 31;

  // forward max-plus recurrence over frames 0 .. ml-1
  const int n_chunks = (ml + CHUNK - 1) / CHUNK;
  if (n_chunks > 0) stage_frames(stage, la, 0, min(CHUNK, ml), L);
  for (int c = 0; c < n_chunks; ++c) {
    const int lo = c * CHUNK, hi = min(lo + CHUNK, ml);
    if (c + 1 < n_chunks) {
      stage_frames(stage + ((c + 1) & 1) * CHUNK * L, la, hi, min(hi + CHUNK, ml), L);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* chunk = stage + (c & 1) * CHUNK * L;
    for (int i = lo; i < hi; ++i) {
      const float* a = chunk + (i - lo) * L;
      float* cur = rows + (i & 1) * L;
      if (i == 0) {
        for (int j = threadIdx.x; j < L; j += blockDim.x)
          cur[j] = (j == 0 && tl > 0) ? a[0] : NEG_INF;
      } else {
        const float* prev = rows + ((i - 1) & 1) * L;
        // the loop bound is the same for every thread: all lanes reach the ballot
        for (int j0 = 0; j0 < L; j0 += blockDim.x) {
          const int j = j0 + threadIdx.x;
          bool left = false;
          if (j < L) {
            const float stay = prev[j];
            const float shifted = j > 0 ? prev[j - 1] : NEG_INF;
            left = shifted >= stay;
            const float best = left ? shifted : stay;
            cur[j] = (j < tl ? a[j] : NEG_INF) + best;
          }
          const uint32_t word = __ballot_sync(0xffffffffu, left);
          const int w = (j0 + threadIdx.x - lane) >> 5;
          if (lane == 0 && w < words) bits[static_cast<size_t>(i) * words + w] = word;
        }
      }
      __syncthreads();
    }
  }

  // backtrack from (ml - 1, tl - 1): one thread, over the bits in shared memory
  if (threadIdx.x == 0) {
    int cur = tl - 1;
    for (int i = T - 1; i >= ml; --i) path[i] = -1;
    for (int i = ml - 1; i >= 0; --i) {
      path[i] = cur;
      if (i > 0) {
        int idx = cur < 0 ? cur + L : cur;  // a negative column reads from the end
        idx = min(max(idx, 0), L - 1);
        if ((bits[static_cast<size_t>(i) * words + (idx >> 5)] >> (idx & 31)) & 1u) --cur;
      }
    }
  }
  __syncthreads();

  // the 0/1 map: the backtracked column of each valid frame, (0, 0) anchored
  for (int i = 0; i < T; ++i) {
    const int col = i < ml ? path[i] : -1;
    float* oi = o + static_cast<size_t>(i) * L;
    for (int j = threadIdx.x; j < L; j += blockDim.x)
      oi[j] = (j < tl && (j == col || (i == 0 && j == 0 && ml > 0))) ? 1.0f : 0.0f;
  }
}

size_t shared_bytes(int T, int L) {
  const int words = (L + 31) / 32;
  return sizeof(float) * (2 * CHUNK * L + 2 * L) + sizeof(int) * T +
         sizeof(uint32_t) * static_cast<size_t>(T) * words;
}

}  // namespace

extern "C" {

// bytes of shared memory one block needs at (T, L); the wrapper checks it
// against the card's limit before launching
long long mas_shared_bytes(int T, int L) { return static_cast<long long>(shared_bytes(T, L)); }

int mas_f32(const float* log_attn, const int* text_lens, const int* mel_lens, float* out, int B,
            int T, int L, void* stream) {
  if (B <= 0 || T <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(T, L);
  cudaError_t err =
      cudaFuncSetAttribute(mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = std::min(1024, ((L + 31) / 32) * 32);
  mas_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      log_attn, text_lens, mel_lens, out, T, L, (L + 31) / 32);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
