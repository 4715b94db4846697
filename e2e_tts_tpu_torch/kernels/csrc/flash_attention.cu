// Length-masked flash attention, forward only, float32, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of e2e_tts_tpu/kernels/flash_attention.py
// (_flash_fwd_kernel, launched by _fwd_impl): out = softmax(q k^T / sqrt(D)) v
// over (BH, T, D), where the keys at or past kv_lens[bh] score -1e30, with an
// online softmax (float32 running max, sum and accumulator) over key tiles.
//
// What bounds it on the H100: at the decoder's shapes (BH = 16, T up to 2048,
// D = 192) one call does 4*BH*T^2*D flops on 4*BH*T*D*4 bytes of q/k/v/out,
// about 2,000 flops a byte, so it is bound by operations, not memory.  The
// float32 path has no tensor cores (TF32 would break the 2e-5 bar), so the
// ceiling is the non-tensor FP32 FMA rate.
//
// What the design does about it: each thread block owns one (bh, 64-row query
// tile) and loops over 32-row key/value tiles itself (the TPU grid's
// sequential axis becomes this loop).  The query tile is read from device
// memory once and kept in shared memory; key and value tiles are staged
// through shared memory.  Both products are register-tiled: a thread computes
// a 4 x 2 block of scores and a 4 x (4*NC4) block of the output, reading
// shared memory with 16-byte loads whose row strides keep the banks apart, so
// the loop issues several FMAs per shared load.  Tiles that lie wholly past
// kv_len are skipped; they contribute exactly zero to the online softmax.
// A row with kv_len = 0 sees no tile and comes out 0 (finite), never NaN.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, loaded with ctypes; the launch returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 32;       // key/value rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int PLD = BKV + 4;  // row stride of the probability tile (floats)
constexpr float MASKED = -1e30f;

// Row stride (floats) for q/k/v tiles of width dp (a multiple of 4): a
// multiple of 4 for 16-byte loads, with an odd count of 16-byte units so
// that lanes reading consecutive rows fall in different banks.
__host__ __device__ inline int row_stride(int dp) {
    return ((dp / 4) % 2 == 0) ? dp + 4 : dp + 8;
}

inline size_t smem_bytes(int dp) {
    const int ld = row_stride(dp);
    return sizeof(float) * (size_t)(BQ * ld + 2 * BKV * ld + BQ * PLD);
}

// Copy rows [row0, row0 + nrows) of a (T, D) matrix into a (nrows, ld) tile,
// zero-filling rows past T and columns D..dp-1, multiplied by `scale`.
__device__ inline void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                 int row0, int nrows, int T, int D, int dp, int ld,
                                 float scale) {
    for (int idx = threadIdx.x; idx < nrows * dp; idx += THREADS) {
        const int r = idx / dp;
        const int c = idx - r * dp;
        const int t = row0 + r;
        float x = 0.f;
        if (t < T && c < D) x = src[(size_t)t * D + c] * scale;
        dst[r * ld + c] = x;
    }
}

// NC4: 16-byte column groups of the output each thread holds, per 64
// columns of dp (dp <= 64 * NC4).
template <int NC4>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ kv_lens,
              float* __restrict__ out, int T, int D, int dp, float scale) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int ld = row_stride(dp);
    float* qs = smem;               // (BQ, ld), pre-scaled
    float* ks = qs + BQ * ld;       // (BKV, ld)
    float* vs = ks + BKV * ld;      // (BKV, ld)
    float* ps = vs + BKV * ld;      // (BQ, PLD)

    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * BQ;
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    const size_t base = (size_t)bh * T * D;
    int kv_len = kv_lens[bh];
    kv_len = kv_len < 0 ? 0 : (kv_len > T ? T : kv_len);

    load_tile(qs, q + base, q0, BQ, T, D, dp, ld, scale);

    // this thread's rows: ty*4 + i; score columns: tx + 16*j;
    // output columns: (c*16 + tx)*4 + e
    float acc[4][NC4 * 4];
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = MASKED;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC4 * 4; ++c) acc[i][c] = 0.f;
    }

    const int n_tiles = (kv_len + BKV - 1) / BKV;
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int kv0 = tile * BKV;
        __syncthreads();  // previous tile's ks/vs/ps are no longer read
        load_tile(ks, k + base, kv0, BKV, T, D, dp, ld, 1.f);
        load_tile(vs, v + base, kv0, BKV, T, D, dp, ld, 1.f);
        __syncthreads();

        // s = (q * scale) k^T on a 4 x 2 register block
        float s[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
        for (int d = 0; d < dp; d += 4) {
            float4 qv[4], kv[2];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                qv[i] = *reinterpret_cast<const float4*>(&qs[(ty * 4 + i) * ld + d]);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * ld + d]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
                    s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
                    s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
                    s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
                }
        }

        // mask, then the online-softmax update; the 16 threads sharing a row
        // (same ty, lanes tx = 0..15 of one half-warp) reduce by xor shuffles,
        // which leave every lane with the same value
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
                if (kv0 + tx + 16 * j >= kv_len) s[i][j] = MASKED;
            float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float p0 = expf(s[i][0] - m_new);
            const float p1 = expf(s[i][1] - m_new);
            float sum = p0 + p1;
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            const float alpha = expf(m[i] - m_new);
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < NC4 * 4; ++c) acc[i][c] *= alpha;
            ps[(ty * 4 + i) * PLD + tx] = p0;
            ps[(ty * 4 + i) * PLD + tx + 16] = p1;
        }
        __syncthreads();

        // acc += p v on a 4 x (4*NC4) register block
        for (int kk = 0; kk < BKV; kk += 4) {
            float4 pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                pv[i] = *reinterpret_cast<const float4*>(&ps[(ty * 4 + i) * PLD + kk]);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float* vrow = &vs[(kk + u) * ld];
#pragma unroll
                for (int c = 0; c < NC4; ++c) {
                    const int col = (c * 16 + tx) * 4;
                    if (col < dp) {
                        const float4 vv = *reinterpret_cast<const float4*>(&vrow[col]);
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                                          : u == 2 ? pv[i].z : pv[i].w;
                            acc[i][c * 4 + 0] = fmaf(p, vv.x, acc[i][c * 4 + 0]);
                            acc[i][c * 4 + 1] = fmaf(p, vv.y, acc[i][c * 4 + 1]);
                            acc[i][c * 4 + 2] = fmaf(p, vv.z, acc[i][c * 4 + 2]);
                            acc[i][c * 4 + 3] = fmaf(p, vv.w, acc[i][c * 4 + 3]);
                        }
                    }
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int t = q0 + ty * 4 + i;
        if (t >= T) continue;
        const float inv = 1.f / fmaxf(l[i], 1e-20f);
        float* orow = out + base + (size_t)t * D;
#pragma unroll
        for (int c = 0; c < NC4; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = (c * 16 + tx) * 4 + e;
                if (col < D) orow[col] = acc[i][c * 4 + e] * inv;
            }
    }
}

template <int NC4>
cudaError_t launch(const float* q, const float* k, const float* v, const int* kv_lens,
                   float* out, int BH, int T, int D, int dp, float scale,
                   cudaStream_t stream) {
    const size_t bytes = smem_bytes(dp);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<NC4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((T + BQ - 1) / BQ, BH);
    flash_fwd_f32<NC4><<<grid, THREADS, bytes, stream>>>(q, k, v, kv_lens, out, T, D, dp,
                                                          scale);
    return cudaGetLastError();
}

}  // namespace

// q, k, v, out: contiguous (BH, T, D) float32 on the device; kv_lens: (BH,)
// int32 on the device.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                       const void* kv_lens, void* out, int BH, int T,
                                       int D, void* stream) {
    if (BH <= 0 || T <= 0 || D <= 0 || D > 256 || BH > 65535)
        return (int)cudaErrorInvalidValue;
    const int dp = (D + 3) / 4 * 4;
    const float scale = (float)(1.0 / sqrt((double)D));
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    const auto* lens = static_cast<const int*>(kv_lens);
    auto* of = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch ((dp + 63) / 64) {
        case 1: return (int)launch<1>(qf, kf, vf, lens, of, BH, T, D, dp, scale, s);
        case 2: return (int)launch<2>(qf, kf, vf, lens, of, BH, T, D, dp, scale, s);
        case 3: return (int)launch<3>(qf, kf, vf, lens, of, BH, T, D, dp, scale, s);
        default: return (int)launch<4>(qf, kf, vf, lens, of, BH, T, D, dp, scale, s);
    }
}
