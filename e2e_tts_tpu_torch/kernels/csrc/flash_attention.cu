// Length-masked flash attention, forward only, for Hopper (sm_90a): a float32
// form with both products on the tensor cores in 3xTF32, and a 16-bit form
// (bfloat16 or float16 in and out) with both products on the tensor cores in
// the input's type.
//
// Replaces the Pallas kernel of e2e_tts_tpu/kernels/flash_attention.py
// (_flash_fwd_kernel, launched by _fwd_impl): out = softmax(q k^T / sqrt(D)) v
// over (BH, T, D), where the keys at or past kv_lens[bh] score -1e30, with an
// online softmax (float32 running max, sum and accumulator) over key tiles.
//
// What bounds it on the H100: 4*D*kv_len^2 flops a head against 16*D*kv_len
// bytes of valid q/k/v/out rows, hundreds of flops a byte, so operations.  The
// output must match float32 attention within 2e-5, which one TF32 product
// (10-bit mantissa) misses by 100x; so each operand x is split in registers
// into big = tf32(x) and small = tf32(x - big), and every m16n8k8 fragment
// product is issued three times (big*big + big*small + small*big, f32
// accumulate, small*small dropped).  The ceiling is then a third of the TF32
// tensor rate, against 67 TFLOP/s of float32 FMA.  An mma.sync result comes
// back several issue slots after the product starts, so a warp alone on an SM
// sub-partition leaves the tensor core idle between dependent products: the
// kernel needs 8 warps an SM and independent products in flight.  At
// serving shapes (BH = 4, T up to 1152, most rows padding) there are few
// query rows, and one warp's serial loop over the key tiles sets the time.
//
// What the design does about it:
// - mma.sync (not wgmma): each operand tile sits in shared memory once, in
//   f32, and is split at fragment load.  wgmma reads a tf32 B operand only
//   K-major from shared memory (P v would need transposed V tiles) and would
//   need split copies of every operand, more than 227 KB at D = 192.
// - FA2-style warps: a warp owns 16 query rows; its score tile and its
//   16 x D output accumulator live in registers; row max and sum reduce over
//   the 4 lanes that share a row; exp2f of (s - max) times log2(e)/sqrt(D),
//   so the scale touches only the difference.
// - The tensor core truncates its f32 sums.  A running accumulator fed
//   product after product drifts toward zero, past the 2e-5 bar on serving
//   activations at T = 1152, so each 8-wide slice of q k^T and each tile's
//   p v goes into a fresh accumulator that is added in f32.
// - Products are issued over 4 independent accumulators at a time.
// - The score accumulator (m16n8: lane holds keys 2c, 2c+1) feeds P v as the
//   A fragment (m16n8k8: lane holds k = c, c+4) without a shuffle: within
//   each 8-key slice, k position c stands for key 2c and c+4 for key 2c+1, and
//   the V fragment reads its rows in the same order.
// - K/V tiles of 32 rows arrive in a two-stage ring by cp.async (16 bytes a
//   thread where D % 4 == 0, 4 bytes otherwise), so tile j+1 loads while tile
//   j is multiplied.  Row stride dp + 4 floats (dp = D rounded up to 8) keeps
//   the q, k and v fragment loads free of bank conflicts.  Rows at or past
//   kv_len arrive as zeros; only the keys past kv_len in the last tile are
//   masked.
// - No work past kv_len: the key loop ends at ceil(kv_len / 32); a block, or a
//   query group, whose first row is at or past kv_len writes zeros to its rows
//   and runs no key loop.  A head with kv_len = 0 comes out 0.
// - A block has up to 8 warps.  The launch gives it the most 16-row query
//   groups (8, 4, 2, 1) that still leave BH * ceil(T / rows) blocks for every
//   SM and fit in shared memory.  The warps left over split each group's
//   32-key tiles (2 or 4 warps a group, 16 or 8 keys each), each with its own
//   online softmax, merged through shared memory after the loop.  So serving's
//   few query rows still get 4 warps a group and 8 warps a block.
// - Where the blocks are still few against what the card holds at once, each
//   head's key tiles are cut into up to 8 parts (grid z), each part a block
//   that writes its unnormalised softmax state (o, max, sum) to a workspace
//   the caller allocates; a second small kernel, flash_merge, combines the
//   parts of each valid row.  The launch plan (groups, warps, parts) is made
//   once per (device, BH, T, D), from T and not from kv_len, which stays on
//   the device.
//
// The 16-bit form (flash_fwd_16, a template on the element type) computes
// what the Pallas kernel computes on 16-bit blocks: it upcasts q, k and v,
// keeps the scores, the online softmax and the accumulator in float32, and
// rounds once, at the output.  Its bound on the H100 is the dense bf16/fp16
// tensor rate (989 TFLOP/s), 6x the 3xTF32 one.  The differences from the
// float32 form:
// - Both products are mma.sync m16n8k16 on 16-bit operands with float32
//   accumulators.  A product of two 16-bit values is exact in float32, so
//   q k^T needs one product (no split).
// - p is a float32 in [0, 1]; rounded to 16 bits it would add ~2^-9
//   relative error before the output's own rounding, and far more where the
//   rows of v cancel (outputs near 0, whose 16-bit ulp is tiny).  So p is
//   split into three 16-bit parts, p = p0 + p1 + p2 to float32 accuracy
//   (float16 after scaling p by 2^15, so that its parts stay normal), and
//   p v is three products, the small parts first.  Two parts (~2^-17 for
//   bfloat16) leave outputs near 0 several of their ulps off.
// - Tiles hold 64 keys (a k16 step of p v takes two 8-key slices of the
//   score accumulator, whose registers are the A fragment as they lie), 2 to
//   8 slices a warp.  Shared memory holds the 16-bit values, row stride
//   dp + 8 (dp = D rounded up to 16), so the 32-bit fragment loads of q and k
//   are free of bank conflicts; v's B fragments come by ldmatrix.trans.
// - Fresh accumulators, the key split and flash_merge (writing 16 bits) as
//   in the float32 form; the workspace stays float32.
// Where D % 8 == 0 the launch plan takes a second 16-bit kernel instead,
// flash_fwd_16_sm90 (flash_attention_sm90.cuh): TMA-fed tiles, wgmma, a
// producer warpgroup (one lane starts the copies) and consumer warpgroups,
// with the same arithmetic.
// flash_fwd_16 stays for D % 8 != 0, whose rows TMA cannot address.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no -lcuda: cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint).  Interface: plain C, loaded with ctypes:
// flash_attention_workspace_floats (and _16) say how much workspace a call
// needs, flash_attention_kernel_16 which 16-bit kernel the plan takes,
// flash_attention_fwd_f32 (and flash_attention_fwd_16) launch and return
// cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

constexpr int BKV = 32;             // key/value rows per tile
constexpr int STAGES = 2;           // K/V tiles in the ring
constexpr int MAX_WARPS = 8;        // warps a block
constexpr int MIN_SPLIT_TILES = 4;  // key tiles a part takes at least
constexpr int MAX_SPLIT = 8;        // parts of a head's key tiles, at most
// blocks a key split aims at, per block the card holds at once: more than
// one wave's worth, because serving pads most rows and their blocks return
// at once (tuned on an H100 at the serving and decoder shapes)
constexpr double SPLIT_LOAD = 2.5;
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, to a 10-bit
// mantissa) of a finite x, in two integer instructions: ptxas expands the cvt
// itself into a longer sequence on sm_90, and the split is on the hot path
__device__ __forceinline__ uint32_t tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to about 2^-22 relative, both exact in TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
    big = tf32(x);
    small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[n] += a b[n] for N fragments of B in 3xTF32: the two cross terms, then
// big*big, each pass over all N so that consecutive products are independent
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[N][4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[N][2],
                                           const uint32_t (&bs)[N][2]) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(c[n], ab, bs[n][0], bs[n][1]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(c[n], as, bb[n][0], bb[n][1]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(c[n], ab, bb[n][0], bb[n][1]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int nbytes) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(nbytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int nbytes) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src), "r"(nbytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Start copying rows [row0, row0 + nrows) of a (T, D) matrix into an
// (nrows, ld) tile; rows at or past `lim` and columns D..dp-1 are zero-filled.
// Warps take rows, lanes take 16-byte (or 4-byte) columns.
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const float* __restrict__ src,
                                          int row0, int nrows, int lim, int D, int dp, int ld,
                                          bool vec) {
    const int nwarps = blockDim.x >> 5, lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < nrows; r += nwarps) {
        const bool row_ok = row0 + r < lim;
        const float* s = src + (size_t)(row_ok ? row0 + r : 0) * D;
        float* d = dst + r * ld;
        if (vec) {  // D % 4 == 0 and 16-byte aligned rows
            for (int c = lane * 4; c < dp; c += 128) {
                const bool ok = row_ok && c < D;
                cp_async16(d + c, ok ? s + c : src, ok ? 16 : 0);
            }
        } else {
            for (int c = lane; c < dp; c += 32) {
                const bool ok = row_ok && c < D;
                cp_async4(d + c, ok ? s + c : src, ok ? 4 : 0);
            }
        }
    }
}

// DT: 8-column tiles of the output (dp <= 8 * DT); NT: 8-key slices of each
// 32-key tile a warp takes (4 / NT warps share a query group's tile)
template <int DT, int NT>
__global__ void __launch_bounds__(32 * MAX_WARPS)
flash_fwd_3xtf32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ kv_lens,
                 float* __restrict__ out, float* __restrict__ part, int T, int D, int dp,
                 float scale_log2, int vec) {  // keep in step with launch()
    constexpr int KS = 4 / NT;  // warps of a query group
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int ld = dp + 4;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;  // fragment row group
    const int tg = lane & 3;  // thread in group
    const int wq = warp / KS;           // this warp's 16-row query group
    const int wk = warp - wq * KS;      // and its keys of each tile: wk*NT*8 ..
    const int bq = 16 * (blockDim.x >> 5) / KS;
    float* qs = smem;                   // (bq, ld)
    float* kvs = qs + bq * ld;          // STAGES x [K (BKV, ld), V (BKV, ld)]

    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * bq;
    const int r0 = q0 + wq * 16;  // this warp's first query row
    const size_t base = (size_t)bh * T * D;
    int kv_len = kv_lens[bh];
    kv_len = kv_len < 0 ? 0 : (kv_len > T ? T : kv_len);

    // this block's key tiles [jb, je): part z of the head's tiles, cut in
    // gridDim.z parts; with more than one part, flash_merge writes every row
    const int nsplit = gridDim.z;
    const int n_tiles = (kv_len + BKV - 1) / BKV;
    const int per = (n_tiles + nsplit - 1) / nsplit;
    const int jb = blockIdx.z * per;
    const int je = jb + per < n_tiles ? jb + per : n_tiles;
    if (q0 >= kv_len || jb >= je) {  // no valid query row or no key: no key loop
        const int n = (T - q0 < bq ? T - q0 : bq) * D;
        for (int i = threadIdx.x; nsplit == 1 && i < n; i += blockDim.x)
            out[base + (size_t)q0 * D + i] = 0.f;
        return;
    }

    // the ring: q and tile jb in flight before the loop, then one commit group
    // a tile, loaded one tile ahead of the one being multiplied
    load_rows(qs, q + base, q0, bq, T, D, dp, ld, vec);
    load_rows(kvs, k + base, jb * BKV, BKV, kv_len, D, dp, ld, vec);
    load_rows(kvs + BKV * ld, v + base, jb * BKV, BKV, kv_len, D, dp, ld, vec);
    cp_async_commit();

    const bool active = r0 < kv_len;  // a group past kv_len only helps load
    const float* qw = qs + wq * 16 * ld;
    float o[DT][4];
#pragma unroll
    for (int t = 0; t < DT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
    float m0 = MASKED, m1 = MASKED;  // running max of raw scores, rows g and g + 8
    float l0 = 0.f, l1 = 0.f;        // this lane's share of the running sums

    for (int j = jb; j < je; ++j) {
        if (j + 1 < je) {
            float* nxt = kvs + ((j + 1 - jb) % STAGES) * 2 * BKV * ld;
            load_rows(nxt, k + base, (j + 1) * BKV, BKV, kv_len, D, dp, ld, vec);
            load_rows(nxt + BKV * ld, v + base, (j + 1) * BKV, BKV, kv_len, D, dp, ld, vec);
        }
        cp_async_commit();  // possibly empty: one group per iteration
        cp_async_wait<1>(); // tile j (and q) have landed
        __syncthreads();

        const int kv0 = j * BKV + wk * NT * 8;  // this warp's first key
        if (active && kv0 < kv_len) {
            const float* ks = kvs + ((j - jb) % STAGES) * 2 * BKV * ld + wk * NT * 8 * ld;
            const float* vs = ks + BKV * ld;

            // s = q k^T (raw), 16 x 8*NT as NT m16n8 tiles.  Each 8-wide slice
            // of D goes into a fresh accumulator that is added to s in f32: the
            // tensor core truncates its sums, and a running accumulator would
            // drift toward zero over the slices.
            float s[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 2
            for (int kk = 0; kk < dp; kk += 8) {
                uint32_t ab[4], as[4], bb[NT][2], bs[NT][2];
                split(qw[g * ld + kk + tg], ab[0], as[0]);
                split(qw[(g + 8) * ld + kk + tg], ab[1], as[1]);
                split(qw[g * ld + kk + tg + 4], ab[2], as[2]);
                split(qw[(g + 8) * ld + kk + tg + 4], ab[3], as[3]);
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    const float* kr = ks + (n * 8 + g) * ld + kk + tg;
                    split(kr[0], bb[n][0], bs[n][0]);
                    split(kr[4], bb[n][1], bs[n][1]);
                }
                float t[NT][4] = {};
                mma_3xtf32<NT>(t, ab, as, bb, bs);
#pragma unroll
                for (int n = 0; n < NT; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[n][e] += t[n][e];
            }

            // mask the keys past kv_len, then the online softmax; lane holds
            // rows g (s[n][0..1]) and g + 8 (s[n][2..3]) at keys
            // kv0 + n*8 + 2*tg + {0, 1}
            if (kv0 + NT * 8 > kv_len) {
#pragma unroll
                for (int n = 0; n < NT; ++n)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        if (kv0 + n * 8 + 2 * tg + e >= kv_len) s[n][e] = s[n][2 + e] = MASKED;
            }
            float mx0 = m0, mx1 = m1;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
                mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
            }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
            }
            const float alpha0 = exp2f((m0 - mx0) * scale_log2);
            const float alpha1 = exp2f((m1 - mx1) * scale_log2);
            m0 = mx0;
            m1 = mx1;

            // p = exp2((s - max) * log2(e) / sqrt(D)), split as the A fragments
            // of p v: in 8-key slice n, k position tg is key 2*tg and tg + 4 is
            // key 2*tg + 1, so the score accumulator needs no shuffle
            uint32_t pb[NT][4], ps[NT][4];
            float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const float p0 = exp2f((s[n][0] - mx0) * scale_log2);
                const float p1 = exp2f((s[n][1] - mx0) * scale_log2);
                const float p2 = exp2f((s[n][2] - mx1) * scale_log2);
                const float p3 = exp2f((s[n][3] - mx1) * scale_log2);
                sum0 += p0 + p1;
                sum1 += p2 + p3;
                split(p0, pb[n][0], ps[n][0]);
                split(p2, pb[n][1], ps[n][1]);
                split(p1, pb[n][2], ps[n][2]);
                split(p3, pb[n][3], ps[n][3]);
            }
            l0 = l0 * alpha0 + sum0;
            l1 = l1 * alpha1 + sum1;

            // o = o * alpha + p v, four 8-column tiles at a time; this tile's
            // p v goes into a fresh accumulator, as s did
            const float* vr = vs + 2 * tg * ld + g;
#pragma unroll
            for (int t0 = 0; t0 < DT; t0 += 4) {
                if (t0 * 8 < dp) {
                    float acc[4][4] = {};
#pragma unroll
                    for (int n = 0; n < NT; ++n) {
                        uint32_t vb[4][2], vsm[4][2];
#pragma unroll
                        for (int u = 0; u < 4; ++u) {
                            const float* x = vr + n * 8 * ld + (t0 + u) * 8;
                            const bool in = (t0 + u) * 8 < dp;  // columns past dp: zeros
                            split(in ? x[0] : 0.f, vb[u][0], vsm[u][0]);
                            split(in ? x[ld] : 0.f, vb[u][1], vsm[u][1]);
                        }
                        mma_3xtf32<4>(acc, pb[n], ps[n], vb, vsm);
                    }
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        o[t0 + u][0] = fmaf(o[t0 + u][0], alpha0, acc[u][0]);
                        o[t0 + u][1] = fmaf(o[t0 + u][1], alpha0, acc[u][1]);
                        o[t0 + u][2] = fmaf(o[t0 + u][2], alpha1, acc[u][2]);
                        o[t0 + u][3] = fmaf(o[t0 + u][3], alpha1, acc[u][3]);
                    }
                }
            }
        }
        __syncthreads();  // this stage is free for tile j + 2
    }

    if (KS > 1) {
        // the warps of a query group hold softmax states over disjoint keys:
        // parts 1.. go through shared memory (the ring is free now) to part 0,
        // which merges them, each lane its own fragment positions
        cp_async_wait<0>();
        float* part = kvs + (size_t)warp * (4 * DT + 4) * 32 + lane;
        if (active && wk > 0) {
#pragma unroll
            for (int t = 0; t < DT; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) part[(4 * t + e) * 32] = o[t][e];
            part[(4 * DT) * 32] = m0;
            part[(4 * DT + 1) * 32] = m1;
            part[(4 * DT + 2) * 32] = l0;
            part[(4 * DT + 3) * 32] = l1;
        }
        __syncthreads();
        if (wk > 0) return;
#pragma unroll
        for (int w = 1; w < KS; ++w) {
            if (!active) break;
            const float* pw = part + (size_t)w * (4 * DT + 4) * 32;
            const float pm0 = pw[(4 * DT) * 32], pm1 = pw[(4 * DT + 1) * 32];
            const float mx0 = fmaxf(m0, pm0), mx1 = fmaxf(m1, pm1);
            const float a0 = exp2f((m0 - mx0) * scale_log2), b0 = exp2f((pm0 - mx0) * scale_log2);
            const float a1 = exp2f((m1 - mx1) * scale_log2), b1 = exp2f((pm1 - mx1) * scale_log2);
            m0 = mx0;
            m1 = mx1;
            l0 = l0 * a0 + pw[(4 * DT + 2) * 32] * b0;
            l1 = l1 * a1 + pw[(4 * DT + 3) * 32] * b1;
#pragma unroll
            for (int t = 0; t < DT; ++t) {
                o[t][0] = o[t][0] * a0 + pw[(4 * t) * 32] * b0;
                o[t][1] = o[t][1] * a0 + pw[(4 * t + 1) * 32] * b0;
                o[t][2] = o[t][2] * a1 + pw[(4 * t + 2) * 32] * b1;
                o[t][3] = o[t][3] * a1 + pw[(4 * t + 3) * 32] * b1;
            }
        }
    }
    if (!active) {  // every row of this query group is at or past kv_len
        const int n = (T - r0 < 16 ? T - r0 : 16) * D;
        for (int i = lane; nsplit == 1 && i < n; i += 32) out[base + (size_t)r0 * D + i] = 0.f;
        return;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const int ra = r0 + g, rb = r0 + g + 8;
    if (nsplit > 1) {  // this part's softmax state, unnormalised, for flash_merge
        const size_t prow = ((size_t)blockIdx.z * gridDim.y + bh) * T;
        float* po = part + prow * D;
        float* pml = part + (size_t)nsplit * gridDim.y * T * D + prow * 2;
#pragma unroll
        for (int t = 0; t < DT; ++t) {
            const int c = t * 8 + 2 * tg;
            if (ra < T) {
                if (c < D) po[(size_t)ra * D + c] = o[t][0];
                if (c + 1 < D) po[(size_t)ra * D + c + 1] = o[t][1];
            }
            if (rb < T) {
                if (c < D) po[(size_t)rb * D + c] = o[t][2];
                if (c + 1 < D) po[(size_t)rb * D + c + 1] = o[t][3];
            }
        }
        if (tg == 0 && ra < T) {
            pml[2 * ra] = m0;
            pml[2 * ra + 1] = l0;
        }
        if (tg == 0 && rb < T) {
            pml[2 * rb] = m1;
            pml[2 * rb + 1] = l1;
        }
        return;
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;  // >= 1: each row saw a valid key
#pragma unroll
    for (int t = 0; t < DT; ++t) {
        const int c = t * 8 + 2 * tg;
        if (ra < T) {
            if (c < D) out[base + (size_t)ra * D + c] = o[t][0] * inv0;
            if (c + 1 < D) out[base + (size_t)ra * D + c + 1] = o[t][1] * inv0;
        }
        if (rb < T) {
            if (c < D) out[base + (size_t)rb * D + c] = o[t][2] * inv1;
            if (c + 1 < D) out[base + (size_t)rb * D + c + 1] = o[t][3] * inv1;
        }
    }
}

// An output element from float32 (round to nearest even)
template <typename E> __device__ __forceinline__ E to_elem(float x);
template <> __device__ __forceinline__ float to_elem<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 to_elem<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half to_elem<__half>(float x) { return __float2half_rn(x); }

// Merges the nsplit parts of each valid row (t < kv_len) of flash_fwd_3xtf32
// or flash_fwd_16 (bkv: the keys of the kernel's tile):
// out = sum_z 2^((m_z - M) c) o_z / sum_z 2^((m_z - M) c) l_z, M = max_z m_z;
// rows at or past kv_len come out 0.  One warp a row, lanes over columns.
template <typename E>
__global__ void __launch_bounds__(256)
flash_merge(const float* __restrict__ part, const int* __restrict__ kv_lens,
            E* __restrict__ out, int nsplit, int T, int D, int bkv, float scale_log2) {
    const int t = blockIdx.x * 8 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    const int bh = blockIdx.y, BH = gridDim.y;
    if (t >= T) return;
    E* orow = out + ((size_t)bh * T + t) * D;
    int kv_len = kv_lens[bh];
    kv_len = kv_len < 0 ? 0 : (kv_len > T ? T : kv_len);
    if (t >= kv_len) {
        for (int c = lane; c < D; c += 32) orow[c] = to_elem<E>(0.f);
        return;
    }
    const int n_tiles = (kv_len + bkv - 1) / bkv;
    const int per = (n_tiles + nsplit - 1) / nsplit;
    const int nz = (n_tiles + per - 1) / per;  // parts that saw keys
    const float* pml = part + (size_t)nsplit * BH * T * D;
    float mx = MASKED;
    for (int z = 0; z < nz; ++z) mx = fmaxf(mx, pml[(((size_t)z * BH + bh) * T + t) * 2]);
    float l = 0.f;
    for (int z = 0; z < nz; ++z) {
        const float* ml = pml + (((size_t)z * BH + bh) * T + t) * 2;
        l += exp2f((ml[0] - mx) * scale_log2) * ml[1];
    }
    const float inv = 1.f / l;
    for (int c = lane; c < D; c += 32) {
        float acc = 0.f;
        for (int z = 0; z < nz; ++z) {
            const size_t row = ((size_t)z * BH + bh) * T + t;
            acc += exp2f((pml[row * 2] - mx) * scale_log2) * part[row * D + c];
        }
        orow[c] = to_elem<E>(acc * inv);
    }
}

// --- the 16-bit form ------------------------------------------------------------------

constexpr int BKV16 = 64;  // key/value rows per tile of the 16-bit form

template <typename E> struct Pair;  // two elements in one 32-bit register, low half first
template <> struct Pair<__nv_bfloat16> {
    using T2 = __nv_bfloat162;
    static __device__ __forceinline__ T2 of(float lo, float hi) {
        return __floats2bfloat162_rn(lo, hi);
    }
};
template <> struct Pair<__half> {
    using T2 = __half2;
    static __device__ __forceinline__ T2 of(float lo, float hi) { return __floats2half2_rn(lo, hi); }
};

// Three 16-bit pairs whose sum is (x, y) to float32 accuracy: parts[0] the
// rounded values, parts[1] and parts[2] the rounded remainders (each part
// holds 8 (bfloat16) or 11 (float16) more bits of the value)
template <typename E>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t (&parts)[3]) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const auto h = Pair<E>::of(x, y);
        memcpy(&parts[i], &h, 4);
        x -= __low2float(h);
        y -= __high2float(h);
    }
}

// p is split after scaling by P_SCALE<E>: float16's normal range ends at
// 2^-14, and a p in [0, 1] scaled by 2^15 keeps its low parts normal down to
// p ~ 2^-29; bfloat16 has float32's range
template <typename E> constexpr float P_SCALE = 1.f;
template <> constexpr float P_SCALE<__half> = 32768.f;

// c += a b: m16n8k16, 16-bit A (row) and B (col), float32 accumulators
template <typename E>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
    if constexpr (std::is_same<E, __nv_bfloat16>::value) {
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    } else {
        asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
}

// four 8x8 16-bit matrices from shared memory, transposed: lanes 8i..8i+7
// give the rows of matrix i; register i of lane l holds rows 2(l%4) and
// 2(l%4) + 1 of column l/4 of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s)
                 : "memory");
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// load_rows for 16-bit elements: 16-byte cp.async (8 elements) where
// D % 8 == 0 and the rows are 16-byte aligned, else element by element
// (synchronous; the barrier before the tile is read makes them visible)
__device__ __forceinline__ void load_rows16(uint16_t* __restrict__ dst,
                                            const uint16_t* __restrict__ src, int row0,
                                            int nrows, int lim, int D, int dp, int ld, bool vec) {
    const int nwarps = blockDim.x >> 5, lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < nrows; r += nwarps) {
        const bool row_ok = row0 + r < lim;
        const uint16_t* s = src + (size_t)(row_ok ? row0 + r : 0) * D;
        uint16_t* d = dst + r * ld;
        if (vec) {
            for (int c = lane * 8; c < dp; c += 256) {
                const bool ok = row_ok && c < D;
                cp_async16(d + c, ok ? s + c : src, ok ? 16 : 0);
            }
        } else {
            for (int c = lane; c < dp; c += 32) d[c] = row_ok && c < D ? s[c] : 0;
        }
    }
}

// E: __nv_bfloat16 or __half; DT: 8-column tiles of the output (dp <= 8 * DT);
// NT: 8-key slices of each 64-key tile a warp takes (8 / NT warps share a
// query group's tile).  q, k, v arrive as raw 16-bit words.
template <typename E, int DT, int NT>
__global__ void __launch_bounds__(32 * MAX_WARPS)
flash_fwd_16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
             const uint16_t* __restrict__ v, const int* __restrict__ kv_lens, E* __restrict__ out,
             float* __restrict__ part, int T, int D, int dp, float scale_log2,
             int vec) {  // keep in step with launch()
    static_assert(NT % 2 == 0 && DT % 4 == 0, "k16 steps take two slices; tiles go by 4");
    constexpr int KS = 8 / NT;  // warps of a query group
    extern __shared__ float4 smem4[];
    uint16_t* smem = reinterpret_cast<uint16_t*>(smem4);
    const int ld = dp + 8;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;  // fragment row group
    const int tg = lane & 3;  // thread in group
    const int wq = warp / KS;
    const int wk = warp - wq * KS;
    const int bq = 16 * (blockDim.x >> 5) / KS;
    uint16_t* qs = smem;           // (bq, ld)
    uint16_t* kvs = qs + bq * ld;  // STAGES x [K (BKV16, ld), V (BKV16, ld)]

    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * bq;
    const int r0 = q0 + wq * 16;
    const size_t base = (size_t)bh * T * D;
    int kv_len = kv_lens[bh];
    kv_len = kv_len < 0 ? 0 : (kv_len > T ? T : kv_len);

    const int nsplit = gridDim.z;
    const int n_tiles = (kv_len + BKV16 - 1) / BKV16;
    const int per = (n_tiles + nsplit - 1) / nsplit;
    const int jb = blockIdx.z * per;
    const int je = jb + per < n_tiles ? jb + per : n_tiles;
    if (q0 >= kv_len || jb >= je) {
        const int n = (T - q0 < bq ? T - q0 : bq) * D;
        for (int i = threadIdx.x; nsplit == 1 && i < n; i += blockDim.x)
            out[base + (size_t)q0 * D + i] = to_elem<E>(0.f);
        return;
    }

    load_rows16(qs, q + base, q0, bq, T, D, dp, ld, vec);
    load_rows16(kvs, k + base, jb * BKV16, BKV16, kv_len, D, dp, ld, vec);
    load_rows16(kvs + BKV16 * ld, v + base, jb * BKV16, BKV16, kv_len, D, dp, ld, vec);
    cp_async_commit();

    const bool active = r0 < kv_len;
    const uint16_t* qw = qs + wq * 16 * ld;
    float o[DT][4];
#pragma unroll
    for (int t = 0; t < DT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
    float m0 = MASKED, m1 = MASKED;
    float l0 = 0.f, l1 = 0.f;

    for (int j = jb; j < je; ++j) {
        if (j + 1 < je) {
            uint16_t* nxt = kvs + ((j + 1 - jb) % STAGES) * 2 * BKV16 * ld;
            load_rows16(nxt, k + base, (j + 1) * BKV16, BKV16, kv_len, D, dp, ld, vec);
            load_rows16(nxt + BKV16 * ld, v + base, (j + 1) * BKV16, BKV16, kv_len, D, dp, ld, vec);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();

        const int kv0 = j * BKV16 + wk * NT * 8;  // this warp's first key
        if (active && kv0 < kv_len) {
            const uint16_t* ks = kvs + ((j - jb) % STAGES) * 2 * BKV16 * ld + wk * NT * 8 * ld;
            const uint16_t* vs = ks + BKV16 * ld;

            // s = q k^T (raw), 16 x 8*NT, one product per k16 step of D, each
            // into a fresh accumulator added to s in f32
            float s[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 2
            for (int kk = 0; kk < dp; kk += 16) {
                const uint16_t* qa = qw + g * ld + kk + 2 * tg;
                const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * ld), ld32(qa + 8),
                                       ld32(qa + 8 * ld + 8)};
                float t[NT][4] = {};
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    const uint16_t* kr = ks + (n * 8 + g) * ld + kk + 2 * tg;
                    mma16<E>(t[n], a, ld32(kr), ld32(kr + 8));
                }
#pragma unroll
                for (int n = 0; n < NT; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[n][e] += t[n][e];
            }

            if (kv0 + NT * 8 > kv_len) {
#pragma unroll
                for (int n = 0; n < NT; ++n)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        if (kv0 + n * 8 + 2 * tg + e >= kv_len) s[n][e] = s[n][2 + e] = MASKED;
            }
            float mx0 = m0, mx1 = m1;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
                mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
            }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
            }
            const float alpha0 = exp2f((m0 - mx0) * scale_log2);
            const float alpha1 = exp2f((m1 - mx1) * scale_log2);
            m0 = mx0;
            m1 = mx1;

            // p * P_SCALE as the A fragments of p v, in three parts: k16 step
            // i takes slices 2i (keys 0..7: registers 0, 1) and 2i + 1 (keys
            // 8..15: registers 2, 3); in each, rows g and g + 8 at keys 2tg,
            // 2tg + 1
            uint32_t pp[NT / 2][4][3];
            float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const float p0 = exp2f((s[n][0] - mx0) * scale_log2);
                const float p1 = exp2f((s[n][1] - mx0) * scale_log2);
                const float p2 = exp2f((s[n][2] - mx1) * scale_log2);
                const float p3 = exp2f((s[n][3] - mx1) * scale_log2);
                sum0 += p0 + p1;
                sum1 += p2 + p3;
                constexpr float c = P_SCALE<E>;
                split_pair<E>(p0 * c, p1 * c, pp[n / 2][2 * (n % 2)]);
                split_pair<E>(p2 * c, p3 * c, pp[n / 2][2 * (n % 2) + 1]);
            }
            l0 = l0 * alpha0 + sum0;
            l1 = l1 * alpha1 + sum1;

            // o = o * alpha + p v, four 8-column tiles at a time, this tile's p v
            // in a fresh accumulator.  v's B fragments (k = key, n = column) by
            // ldmatrix.trans: matrices (keys 0-7, tile u), (keys 8-15, tile u),
            // (keys 0-7, tile u + 1), (keys 8-15, tile u + 1)
            const uint16_t* vl = vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
            for (int t0 = 0; t0 < DT; t0 += 4) {
                if (t0 * 8 < dp) {
                    float acc[4][4] = {};
#pragma unroll
                    for (int i = 0; i < NT / 2; ++i) {
#pragma unroll
                        for (int u = 0; u < 4; u += 2) {
                            if ((t0 + u) * 8 < dp) {  // dp % 16 == 0: both tiles of the pair
                                uint32_t b[4];
                                ldmatrix_x4_trans(b, vl + i * 16 * ld + (t0 + u) * 8);
#pragma unroll
                                for (int h = 2; h >= 0; --h) {
                                    const uint32_t a[4] = {pp[i][0][h], pp[i][1][h], pp[i][2][h],
                                                           pp[i][3][h]};
                                    mma16<E>(acc[u], a, b[0], b[1]);
                                    mma16<E>(acc[u + 1], a, b[2], b[3]);
                                }
                            }
                        }
                    }
                    constexpr float unscale = 1.f / P_SCALE<E>;  // a power of 2: exact
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        o[t0 + u][0] = fmaf(o[t0 + u][0], alpha0, acc[u][0] * unscale);
                        o[t0 + u][1] = fmaf(o[t0 + u][1], alpha0, acc[u][1] * unscale);
                        o[t0 + u][2] = fmaf(o[t0 + u][2], alpha1, acc[u][2] * unscale);
                        o[t0 + u][3] = fmaf(o[t0 + u][3], alpha1, acc[u][3] * unscale);
                    }
                }
            }
        }
        __syncthreads();
    }

    if (KS > 1) {  // the group's warps merge through shared memory, as in the float32 form
        cp_async_wait<0>();
        float* pbuf = reinterpret_cast<float*>(kvs) + (size_t)warp * (4 * DT + 4) * 32 + lane;
        if (active && wk > 0) {
#pragma unroll
            for (int t = 0; t < DT; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) pbuf[(4 * t + e) * 32] = o[t][e];
            pbuf[(4 * DT) * 32] = m0;
            pbuf[(4 * DT + 1) * 32] = m1;
            pbuf[(4 * DT + 2) * 32] = l0;
            pbuf[(4 * DT + 3) * 32] = l1;
        }
        __syncthreads();
        if (wk > 0) return;
#pragma unroll
        for (int w = 1; w < KS; ++w) {
            if (!active) break;
            const float* pw = pbuf + (size_t)w * (4 * DT + 4) * 32;
            const float pm0 = pw[(4 * DT) * 32], pm1 = pw[(4 * DT + 1) * 32];
            const float mx0 = fmaxf(m0, pm0), mx1 = fmaxf(m1, pm1);
            const float a0 = exp2f((m0 - mx0) * scale_log2), b0 = exp2f((pm0 - mx0) * scale_log2);
            const float a1 = exp2f((m1 - mx1) * scale_log2), b1 = exp2f((pm1 - mx1) * scale_log2);
            m0 = mx0;
            m1 = mx1;
            l0 = l0 * a0 + pw[(4 * DT + 2) * 32] * b0;
            l1 = l1 * a1 + pw[(4 * DT + 3) * 32] * b1;
#pragma unroll
            for (int t = 0; t < DT; ++t) {
                o[t][0] = o[t][0] * a0 + pw[(4 * t) * 32] * b0;
                o[t][1] = o[t][1] * a0 + pw[(4 * t + 1) * 32] * b0;
                o[t][2] = o[t][2] * a1 + pw[(4 * t + 2) * 32] * b1;
                o[t][3] = o[t][3] * a1 + pw[(4 * t + 3) * 32] * b1;
            }
        }
    }
    if (!active) {
        const int n = (T - r0 < 16 ? T - r0 : 16) * D;
        for (int i = lane; nsplit == 1 && i < n; i += 32)
            out[base + (size_t)r0 * D + i] = to_elem<E>(0.f);
        return;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const int ra = r0 + g, rb = r0 + g + 8;
    if (nsplit > 1) {  // this part's float32 softmax state, for flash_merge
        const size_t prow = ((size_t)blockIdx.z * gridDim.y + bh) * T;
        float* po = part + prow * D;
        float* pml = part + (size_t)nsplit * gridDim.y * T * D + prow * 2;
#pragma unroll
        for (int t = 0; t < DT; ++t) {
            const int c = t * 8 + 2 * tg;
            if (ra < T) {
                if (c < D) po[(size_t)ra * D + c] = o[t][0];
                if (c + 1 < D) po[(size_t)ra * D + c + 1] = o[t][1];
            }
            if (rb < T) {
                if (c < D) po[(size_t)rb * D + c] = o[t][2];
                if (c + 1 < D) po[(size_t)rb * D + c + 1] = o[t][3];
            }
        }
        if (tg == 0 && ra < T) {
            pml[2 * ra] = m0;
            pml[2 * ra + 1] = l0;
        }
        if (tg == 0 && rb < T) {
            pml[2 * rb] = m1;
            pml[2 * rb + 1] = l1;
        }
        return;
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
        const int c = t * 8 + 2 * tg;
        if (ra < T) {
            if (c < D) out[base + (size_t)ra * D + c] = to_elem<E>(o[t][0] * inv0);
            if (c + 1 < D) out[base + (size_t)ra * D + c + 1] = to_elem<E>(o[t][1] * inv0);
        }
        if (rb < T) {
            if (c < D) out[base + (size_t)rb * D + c] = to_elem<E>(o[t][2] * inv1);
            if (c + 1 < D) out[base + (size_t)rb * D + c + 1] = to_elem<E>(o[t][3] * inv1);
        }
    }
}

#include "flash_attention_sm90.cuh"

// The three forms: float32 (flash_fwd_3xtf32), bfloat16 and float16 (flash_fwd_16)
enum Form { F32 = 0, BF16 = 1, F16 = 2 };

// How a call is cut.  flash_fwd_3xtf32 and flash_fwd_16: 16-row query
// groups a block (wq) and warps a group (ks).  flash_fwd_16_sm90 (sm90 = 1):
// consumer warpgroups a block (wq), 64 rows each.  Then the parts each head's
// key tiles are split into (nsplit), the keys of a tile (bkv), the kernel, its
// threads and dynamic shared memory, and the workspace floats for the parts.
struct Plan {
    int sm90, wq, ks, rows, threads, bkv, nsplit;
    const void* kernel;
    size_t smem, workspace;
};

template <int DT>
const void* kernel_of(int form, int ks) {
    if (form == F32)
        return ks == 4 ? (const void*)flash_fwd_3xtf32<DT, 1>
             : ks == 2 ? (const void*)flash_fwd_3xtf32<DT, 2> : (const void*)flash_fwd_3xtf32<DT, 4>;
    if (form == BF16)
        return ks == 4 ? (const void*)flash_fwd_16<__nv_bfloat16, DT, 2>
             : ks == 2 ? (const void*)flash_fwd_16<__nv_bfloat16, DT, 4>
                       : (const void*)flash_fwd_16<__nv_bfloat16, DT, 8>;
    return ks == 4 ? (const void*)flash_fwd_16<__half, DT, 2>
         : ks == 2 ? (const void*)flash_fwd_16<__half, DT, 4> : (const void*)flash_fwd_16<__half, DT, 8>;
}

template <typename E, int NWG>
const void* sm90_kernel_of(int db) {
    return db == 1 ? (const void*)flash_fwd_16_sm90<E, NWG, 1>
         : db == 2 ? (const void*)flash_fwd_16_sm90<E, NWG, 2>
         : db == 3 ? (const void*)flash_fwd_16_sm90<E, NWG, 3> : (const void*)flash_fwd_16_sm90<E, NWG, 4>;
}

// D padded to the products' depth (8 for m16n8k8 tf32, 16 for m16n8k16)
int padded_dim(int form, int D) {
    const int step = form == F32 ? 8 : 16;
    return (D + step - 1) / step * step;
}

// The 16-bit kernel a plan takes: flash_fwd_16_sm90 wherever TMA can address
// the rows (D % 8 == 0), else flash_fwd_16
int kernel_16_of(int D) { return D % 8 == 0 ? 1 : 0; }

cudaError_t make_plan(int dev, int form, int BH, int T, int D, int sm90, Plan& p) {
    int sms = 0, smem_max = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    p.sm90 = sm90;
    if (sm90) {
        // two consumer warpgroups (128 rows) where that still gives every SM
        // a block, else one
        const int db = (D + BLOCK_COLS - 1) / BLOCK_COLS;
        p.wq = (long long)BH * ((T + 2 * WG_ROWS - 1) / (2 * WG_ROWS)) >= sms ? 2 : 1;
        p.ks = 1;
        p.rows = WG_ROWS * p.wq;
        p.threads = 128 * p.wq + 128;  // and the producer warpgroup
        p.bkv = BN;
        p.smem = sm90_smem_bytes(p.wq, db);
        if (p.smem > (size_t)smem_max) return cudaErrorInvalidValue;
        const bool bf16 = form == BF16;
        p.kernel = p.wq == 2 ? (bf16 ? sm90_kernel_of<__nv_bfloat16, 2>(db) : sm90_kernel_of<__half, 2>(db))
                             : (bf16 ? sm90_kernel_of<__nv_bfloat16, 1>(db) : sm90_kernel_of<__half, 1>(db));
    } else {
        // Query groups: the most (up to 8) that still give every SM a block
        // and fit in shared memory.  The block's other warps split each
        // group's key tiles (up to 4 warps a group), so that a block has 8
        // warps where it can.
        const int dp = padded_dim(form, D);
        const size_t esize = form == F32 ? sizeof(float) : 2;  // bytes an element in shared memory
        const int ld = dp + (form == F32 ? 4 : 8);
        const int bkv = form == F32 ? BKV : BKV16;
        const int dt = dp <= 64 ? 8 : dp <= 128 ? 16 : dp <= 192 ? 24 : 32;
        const auto split_of = [](int wq) { return MAX_WARPS / wq < 4 ? MAX_WARPS / wq : 4; };
        const auto smem_bytes = [&](int wq) {
            const size_t tiles = esize * 2 * STAGES * bkv * ld;
            const size_t parts = sizeof(float) * wq * split_of(wq) * (4 * dt + 4) * 32;
            return esize * 16 * wq * ld + (tiles > parts ? tiles : parts);
        };
        p.wq = MAX_WARPS;
        while (p.wq > 1 && ((long long)BH * ((T + 16 * p.wq - 1) / (16 * p.wq)) < sms ||
                            smem_bytes(p.wq) > (size_t)smem_max))
            p.wq /= 2;
        p.ks = split_of(p.wq);
        p.rows = 16 * p.wq;
        p.threads = 32 * p.wq * p.ks;
        p.bkv = bkv;
        p.smem = smem_bytes(p.wq);
        p.kernel = dt == 8 ? kernel_of<8>(form, p.ks) : dt == 16 ? kernel_of<16>(form, p.ks)
                 : dt == 24 ? kernel_of<24>(form, p.ks) : kernel_of<32>(form, p.ks);
    }
    // the device's limit, not this plan's size: plans share kernels
    err = cudaFuncSetAttribute(p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    int resident = 0;  // blocks an SM holds at once
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, p.kernel, p.threads, p.smem);
    if (err != cudaSuccess) return err;
    // A block's key loop is serial, and serving pads most rows (its blocks past
    // kv_len return at once), so where the blocks are few against what the card
    // holds, each head's key tiles are cut into parts, a block each, at least
    // MIN_SPLIT_TILES tiles of BKV keys (of BN keys for flash_fwd_16_sm90) a
    // part, merged by flash_merge.
    const long long blocks = (long long)BH * ((T + p.rows - 1) / p.rows);
    const int keys = (sm90 ? BN : BKV) * MIN_SPLIT_TILES;
    const int by_len = (T + keys - 1) / keys;
    const int by_card = (int)(SPLIT_LOAD * resident * sms / blocks + 0.5);
    p.nsplit = by_len < by_card ? by_len : by_card;
    p.nsplit = p.nsplit < 1 ? 1 : (p.nsplit > MAX_SPLIT ? MAX_SPLIT : p.nsplit);
    p.workspace = p.nsplit > 1 ? (size_t)p.nsplit * BH * T * (D + 2) : 0;
    return cudaSuccess;
}

// make_plan, once per (device, form, BH, T, D, kernel); kernel -1 takes the
// 16-bit form's default (kernel_16_of), 0 flash_fwd_16, 1 flash_fwd_16_sm90
cudaError_t plan_for(int form, int BH, int T, int D, int kernel, Plan& p) {
    static std::mutex mu;
    static std::map<std::tuple<int, int, int, int, int, int>, Plan> plans;
    const int sm90 = form == F32 ? 0 : kernel < 0 ? kernel_16_of(D) : kernel;
    if (sm90 && (D % 8 != 0 || kernel > 1)) return cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const auto key = std::make_tuple(dev, form, BH, T, D, sm90);
    std::lock_guard<std::mutex> lock(mu);
    const auto it = plans.find(key);
    if (it != plans.end()) {
        p = it->second;
        return cudaSuccess;
    }
    err = make_plan(dev, form, BH, T, D, sm90, p);
    if (err == cudaSuccess) plans.emplace(key, p);
    return err;
}

long long workspace_floats(int form, int BH, int T, int D, int kernel) {
    Plan p;
    if (BH <= 0 || T <= 0 || D <= 0 || D > 256) return 0;
    return plan_for(form, BH, T, D, kernel, p) == cudaSuccess ? (long long)p.workspace : -1;
}

int launch(int form, const void* q, const void* k, const void* v, const void* kv_lens, void* out,
           void* workspace, int BH, int T, int D, int kernel, void* stream) {
    if (BH <= 0 || T <= 0 || D <= 0 || D > 256 || BH > 65535) return (int)cudaErrorInvalidValue;
    Plan p;
    cudaError_t err = plan_for(form, BH, T, D, kernel, p);
    if (err != cudaSuccess) return (int)err;
    if (p.workspace > 0 && workspace == nullptr) return (int)cudaErrorInvalidValue;
    const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
    float scale_log2 = (float)(LOG2E / sqrt((double)D));
    const int* lens = static_cast<const int*>(kv_lens);
    float* ws = static_cast<float*>(workspace);
    auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid((T + p.rows - 1) / p.rows, BH, p.nsplit);
    if (p.sm90) {  // TMA reads 16-byte aligned rows of the three tensors
        if (!(aligned(q) && aligned(k) && aligned(v))) return (int)cudaErrorMisalignedAddress;
        CUtensorMap maps[3];
        const void* src[3] = {q, k, v};
        for (int i = 0; i < 3 && err == cudaSuccess; ++i)
            err = tensor_map(&maps[i], src[i], form == BF16, BH, T, D, i == 0 ? p.rows : BN);
        if (err != cudaSuccess) return (int)err;
        void* args[] = {&maps[0], &maps[1], &maps[2], &lens, &out, &ws, &T, &D, &scale_log2};
        err = cudaLaunchKernel(p.kernel, grid, dim3(p.threads), args, p.smem, s);
    } else {
        // 16-byte copies: 4 floats or 8 16-bit elements a row's step
        int vec = D % (form == F32 ? 4 : 8) == 0 && aligned(q) && aligned(k) && aligned(v);
        int dp = padded_dim(form, D);
        void* args[] = {&q, &k, &v, &lens, &out, &ws, &T, &D, &dp, &scale_log2, &vec};
        err = cudaLaunchKernel(p.kernel, grid, dim3(p.threads), args, p.smem, s);
    }
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess || p.nsplit == 1) return (int)err;
    const dim3 mgrid((T + 7) / 8, BH);
    if (form == F32)
        flash_merge<<<mgrid, 256, 0, s>>>(ws, lens, static_cast<float*>(out), p.nsplit, T, D, p.bkv,
                                          scale_log2);
    else if (form == BF16)
        flash_merge<<<mgrid, 256, 0, s>>>(ws, lens, static_cast<__nv_bfloat16*>(out), p.nsplit, T,
                                          D, p.bkv, scale_log2);
    else
        flash_merge<<<mgrid, 256, 0, s>>>(ws, lens, static_cast<__half*>(out), p.nsplit, T, D, p.bkv,
                                          scale_log2);
    return (int)cudaGetLastError();
}

}  // namespace

// Floats of device workspace that flash_attention_fwd_f32 needs for these
// sizes on the current device (0: none), or -1 on a CUDA error.
extern "C" long long flash_attention_workspace_floats(int BH, int T, int D) {
    return workspace_floats(F32, BH, T, D, -1);
}

// q, k, v, out: contiguous (BH, T, D) float32 on the device; kv_lens: (BH,)
// int32 on the device; workspace: flash_attention_workspace_floats(BH, T, D)
// floats on the device (may be null when that is 0).  Returns a cudaError_t
// (0 on success).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                       const void* kv_lens, void* out, void* workspace,
                                       int BH, int T, int D, void* stream) {
    return launch(F32, q, k, v, kv_lens, out, workspace, BH, T, D, -1, stream);
}

// The 16-bit kernel the plan takes for heads of D: 1 flash_fwd_16_sm90, 0
// flash_fwd_16.
extern "C" int flash_attention_kernel_16(int D) { return kernel_16_of(D); }

// The 16-bit form's workspace floats: bf16 1 for bfloat16, 0 for float16;
// kernel -1 the plan's, 0 flash_fwd_16, 1 flash_fwd_16_sm90.
extern "C" long long flash_attention_workspace_floats_16(int BH, int T, int D, int bf16,
                                                         int kernel) {
    return workspace_floats(bf16 ? BF16 : F16, BH, T, D, kernel);
}

// As flash_attention_fwd_f32 with q, k, v and out in bfloat16 (bf16 1) or
// float16 (bf16 0), the workspace float32, and the kernel as in
// flash_attention_workspace_floats_16 (flash_fwd_16_sm90 needs D % 8 == 0 and
// 16-byte aligned q, k, v).
extern "C" int flash_attention_fwd_16(const void* q, const void* k, const void* v,
                                      const void* kv_lens, void* out, void* workspace, int BH,
                                      int T, int D, int bf16, int kernel, void* stream) {
    return launch(bf16 ? BF16 : F16, q, k, v, kv_lens, out, workspace, BH, T, D, kernel, stream);
}
