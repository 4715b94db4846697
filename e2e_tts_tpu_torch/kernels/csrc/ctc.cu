// Forward-sum CTC over the fixed 1..K lattice, forward and backward, for
// NVIDIA Hopper (sm_90a).
//
// Replaces: the JAX package's `_forward_single` (e2e_tts_tpu/ops/ctc.py:30-79),
// a `lax.scan` of `_logsumexp3` over mel frames, vmapped over the batch, and
// the reverse scan that autodiff makes of it.  The training step runs the
// forward every step and the backward every train step; in eager PyTorch each
// would be a Python loop of several launches per frame.
//
// Inputs: log_probs (B, T, C) float32, C = K + 1 (class 0 the blank, the
// caller's masked log-softmax), key_lens (the text lengths) and query_lens
// (the mel lengths), clamped to [0, K] and [0, T].  The lattice has S = 2K + 1
// states, even s the blank, odd s the label (s + 1) / 2.
//   alpha_0[s] = s < 2 ? lp[0][s] : -1e30        (frame 0 is read even at query_len 0)
//   alpha_t[s] = lse3(alpha_{t-1}[s], alpha_{t-1}[s-1], s odd ? alpha_{t-1}[s-2] : -1e30)
//                + lp[t][class(s)]                (1 <= t < query_len; later frames hold)
//   total      = logaddexp(alpha_Tf[2k], alpha_Tf[2k-1]),  Tf = max(query_len, 1) - 1
//   loss       = -total / k, or 0 where k = 0, total <= -5e29 or the loss is not finite
// with lse3 exactly as JAX's `_logsumexp3` (the max floored at -1e30).
// Backward: beta_Tf = 0 at the two accepting states, -1e30 elsewhere;
//   beta_{t-1}[r] = lse3(beta_t[r] + e_t[r], beta_t[r+1] + e_t[r+1],
//                        r odd ? beta_t[r+2] + e_t[r+2] : -1e30),  e_t[s] = lp[t][class(s)]
// and d loss / d lp[t][c] = -(g / k) * sum over s of class c of exp(alpha_t[s] + beta_t[s] - total)
// for t <= Tf (0 past it, and 0 for a row whose loss was zeroed).
//
// What bounds it: the dependency chain of query_len frames.  The work (a
// three-way log-sum-exp per state and frame) and the bytes (log_probs read,
// alpha/beta and the gradient written) are tens of microseconds at training
// shapes.  Design against the chain:
//   - one block per utterance, the states across its threads, one
//     __syncthreads a frame between two state rows in shared memory;
//   - log_probs staged into shared memory CHUNK frames at a time by cp.async,
//     the next chunk in flight while this one is consumed;
//   - no frame past query_len is visited;
//   - the forward keeps alpha (B, T, S) in device memory for the backward
//     (25 MB at B = 32, T = 768, K = 128) instead of recomputing it: the
//     memory is small beside the step's activations, and the backward's chain
//     is then one recursion, not two;
//   - the backward's chain computes beta only; the occupancies
//     exp(alpha + beta - total) and their sum over the blank states, which
//     have no chain, run in a second kernel over a (B, frames) grid, a warp a
//     frame, summed in a fixed order (no atomics: the same bits every run).
//
// C entry points (each returns the CUDA error of its launches, 0 on success):
//   ctc_fwd_f32(log_probs, key_lens, query_lens, alpha, total, loss, B, T, C, stream)
//   ctc_bwd_f32(grad_loss, log_probs, key_lens, query_lens, alpha, total, beta, grad, B, T, C, stream)

#include <cuda_runtime.h>

#include <algorithm>

#include "stage.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int CHUNK = 16;        // frames of log_probs staged per cp.async group
constexpr int GRAD_WARPS = 8;    // warps of a block of the gradient kernel
constexpr int GRAD_FRAMES = 32;  // frames of a block of the gradient kernel

// JAX's _logsumexp3: the max floored at -1e30, exp/log in full precision
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, NEG_INF);
  return ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
}

__device__ __forceinline__ int state_class(int s) { return (s & 1) ? (s + 1) >> 1 : 0; }

struct Row {
  int k;      // key length (labels), clamped to [0, C - 1]
  int last;   // Tf: the last frame the recursion reaches
};

__device__ __forceinline__ Row row_of(const int* key_lens, const int* query_lens, int b, int T, int C) {
  Row r;
  r.k = min(max(key_lens[b], 0), C - 1);
  r.last = max(min(max(query_lens[b], 0), T), 1) - 1;
  return r;
}

// a row whose loss the forward kept (JAX: isfinite(loss) & total > NEG_INF / 2)
__device__ __forceinline__ bool kept(float total, int k) {
  if (k < 1) return false;
  const float loss = -total / static_cast<float>(k);
  return isfinite(loss) && total > NEG_INF / 2;
}

__global__ void ctc_alpha_kernel(const float* __restrict__ log_probs, const int* __restrict__ key_lens,
                                 const int* __restrict__ query_lens, float* __restrict__ alpha,
                                 float* __restrict__ total_out, float* __restrict__ loss_out, int T,
                                 int C) {
  extern __shared__ float smem[];
  const int S = 2 * C - 1;
  float* stage = smem;                 // [2][CHUNK * C]
  float* rows = stage + 2 * CHUNK * C;  // [2][S]
  const int b = blockIdx.x;
  const Row r = row_of(key_lens, query_lens, b, T, C);
  const float* lp = log_probs + static_cast<size_t>(b) * T * C;
  float* al = alpha + static_cast<size_t>(b) * T * S;

  const int n_frames = r.last + 1;
  const int n_chunks = (n_frames + CHUNK - 1) / CHUNK;
  stage_frames(stage, lp, 0, min(CHUNK, n_frames), C);
  for (int c = 0; c < n_chunks; ++c) {
    const int lo = c * CHUNK, hi = min(lo + CHUNK, n_frames) - 1;
    if (c + 1 < n_chunks) {
      stage_frames(stage + ((c + 1) & 1) * CHUNK * C, lp, hi + 1, min(hi + 1 + CHUNK, n_frames), C);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* chunk = stage + (c & 1) * CHUNK * C;
    for (int t = lo; t <= hi; ++t) {
      const float* e = chunk + (t - lo) * C;
      float* cur = rows + (t & 1) * S;
      const float* prev = rows + ((t - 1) & 1) * S;
      float* at = al + static_cast<size_t>(t) * S;
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        float v;
        if (t == 0) {
          v = s < 2 ? e[s] : NEG_INF;
        } else {
          const float x = prev[s];
          const float y = s >= 1 ? prev[s - 1] : NEG_INF;
          const float z = ((s & 1) && s >= 2) ? prev[s - 2] : NEG_INF;
          v = lse3(x, y, z) + e[state_class(s)];
        }
        cur[s] = v;
        at[s] = v;
      }
      __syncthreads();
    }
  }

  if (threadIdx.x == 0) {
    const float* fin = rows + (r.last & 1) * S;
    float total = NEG_INF, loss = 0.0f;
    if (r.k >= 1) {
      const float fb = fin[2 * r.k], fl = fin[2 * r.k - 1];
      const float m = fmaxf(fb, fl);
      total = m + logf(expf(fb - m) + expf(fl - m));
      if (kept(total, r.k)) loss = -total / static_cast<float>(r.k);
    }
    total_out[b] = total;
    loss_out[b] = loss;
  }
}

__global__ void ctc_beta_kernel(const float* __restrict__ log_probs, const int* __restrict__ key_lens,
                                const int* __restrict__ query_lens, const float* __restrict__ total,
                                float* __restrict__ beta, int T, int C) {
  extern __shared__ float smem[];
  const int S = 2 * C - 1;
  float* stage = smem;                 // [2][CHUNK * C]
  float* rows = stage + 2 * CHUNK * C;  // [2][S]
  const int b = blockIdx.x;
  const Row r = row_of(key_lens, query_lens, b, T, C);
  if (!kept(total[b], r.k)) return;  // its gradient is 0: the gradient kernel writes it
  const float* lp = log_probs + static_cast<size_t>(b) * T * C;
  float* be = beta + static_cast<size_t>(b) * T * S;

  {
    float* cur = rows + (r.last & 1) * S;
    float* bt = be + static_cast<size_t>(r.last) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float v = (s == 2 * r.k || s == 2 * r.k - 1) ? 0.0f : NEG_INF;
      cur[s] = v;
      bt[s] = v;
    }
  }
  __syncthreads();

  // steps t = last .. 1 each read lp[t] and write beta_{t-1}; chunks walk down
  const int n_steps = r.last;
  const int n_chunks = (n_steps + CHUNK - 1) / CHUNK;
  if (n_chunks > 0) stage_frames(stage, lp, max(1, r.last - CHUNK + 1), r.last + 1, C);
  for (int c = 0; c < n_chunks; ++c) {
    const int hi = r.last - c * CHUNK, lo = max(1, hi - CHUNK + 1);
    if (c + 1 < n_chunks) {
      stage_frames(stage + ((c + 1) & 1) * CHUNK * C, lp, max(1, lo - CHUNK), lo, C);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* chunk = stage + (c & 1) * CHUNK * C;
    for (int t = hi; t >= lo; --t) {
      const float* e = chunk + (t - lo) * C;
      const float* next = rows + (t & 1) * S;  // beta_t
      float* cur = rows + ((t - 1) & 1) * S;   // beta_{t-1}
      float* bt = be + static_cast<size_t>(t - 1) * S;
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        const float x = next[s] + e[state_class(s)];
        const float y = s + 1 < S ? next[s + 1] + e[state_class(s + 1)] : NEG_INF;
        const float z = ((s & 1) && s + 2 < S) ? next[s + 2] + e[state_class(s + 2)] : NEG_INF;
        const float v = lse3(x, y, z);
        cur[s] = v;
        bt[s] = v;
      }
      __syncthreads();
    }
  }
}

__global__ void ctc_grad_kernel(const float* __restrict__ grad_loss, const int* __restrict__ key_lens,
                                const int* __restrict__ query_lens, const float* __restrict__ alpha,
                                const float* __restrict__ beta, const float* __restrict__ total,
                                float* __restrict__ grad, int T, int C) {
  const int S = 2 * C - 1;
  const int b = blockIdx.x;
  const Row r = row_of(key_lens, query_lens, b, T, C);
  const float tot = total[b];
  const bool keep = kept(tot, r.k);
  const float scale = keep ? -grad_loss[b] / static_cast<float>(r.k) : 0.0f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = static_cast<int>(blockIdx.y) * GRAD_FRAMES;
  const int t_end = min(T, t0 + GRAD_FRAMES);
  for (int t = t0 + warp; t < t_end; t += GRAD_WARPS) {
    float* g = grad + (static_cast<size_t>(b) * T + t) * C;
    if (!keep || t > r.last) {
      for (int c = lane; c < C; c += 32) g[c] = 0.0f;
      continue;
    }
    const float* a = alpha + (static_cast<size_t>(b) * T + t) * S;
    const float* be = beta + (static_cast<size_t>(b) * T + t) * S;
    for (int c = 1 + lane; c < C; c += 32) {
      const int s = 2 * c - 1;
      g[c] = scale * expf(a[s] + be[s] - tot);
    }
    float blank = 0.0f;
    for (int c = lane; c < C; c += 32) blank += expf(a[2 * c] + be[2 * c] - tot);
    for (int off = 16; off > 0; off >>= 1) blank += __shfl_xor_sync(0xffffffffu, blank, off);
    if (lane == 0) g[0] = scale * blank;
  }
}

size_t shared_bytes(int C) { return sizeof(float) * (2 * CHUNK * C + 2 * (2 * C - 1)); }

int threads_for(int S) { return std::min(1024, ((S + 31) / 32) * 32); }

}  // namespace

extern "C" {

long long ctc_shared_bytes(int C) { return static_cast<long long>(shared_bytes(C)); }

int ctc_fwd_f32(const float* log_probs, const int* key_lens, const int* query_lens, float* alpha,
                float* total, float* loss, int B, int T, int C, void* stream) {
  if (B <= 0 || T <= 0 || C < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(ctc_alpha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_alpha_kernel<<<B, threads_for(2 * C - 1), smem, static_cast<cudaStream_t>(stream)>>>(
      log_probs, key_lens, query_lens, alpha, total, loss, T, C);
  return static_cast<int>(cudaGetLastError());
}

int ctc_bwd_f32(const float* grad_loss, const float* log_probs, const int* key_lens,
                const int* query_lens, const float* alpha, const float* total, float* beta,
                float* grad, int B, int T, int C, void* stream) {
  if (B <= 0 || T <= 0 || C < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(ctc_beta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ctc_beta_kernel<<<B, threads_for(2 * C - 1), smem, s>>>(log_probs, key_lens, query_lens, total,
                                                           beta, T, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (T + GRAD_FRAMES - 1) / GRAD_FRAMES);
  ctc_grad_kernel<<<grid, 32 * GRAD_WARPS, 0, s>>>(grad_loss, key_lens, query_lens, alpha, beta,
                                                   total, grad, T, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
