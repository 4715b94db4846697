// The 16-bit form of the flash kernel built for Hopper: flash_fwd_16_sm90<E,
// NWG, DB>.  Included by flash_attention.cu inside its unnamed namespace,
// after the 16-bit helpers (Pair, split_pair, P_SCALE, to_elem), with
// <cuda.h> included at the top of that file.
//
// It computes what flash_fwd_16 computes (the Pallas kernel's function on
// 16-bit blocks: float32 scores, online softmax and accumulator, one rounding
// at the output) for D % 8 == 0, the row stride TMA needs.
//
// What bounds it on the H100: the dense 16-bit tensor rate (989 TFLOP/s).
// The one-ulp bar needs p v at float32 accuracy, so p goes in as three
// 16-bit parts and the tensor work is 2 * D * kv_len^2 for q k^T plus
// 3 * 2 * D * kv_len^2 for p v, twice the nominal 4 * D * kv_len^2.
// mma.sync (flash_fwd_16) reaches a fraction of that rate: every warp
// reloads each K/V tile's fragments from shared memory, all threads spend
// instruction slots on cp.async addresses, and copies, exponentials and products
// of different warps never overlap by role.
//
// What the design does about it:
// - Roles.  A block is NWG consumer warpgroups (64 query rows each; NWG = 2,
//   128 rows, where the grid fills the card, else 1) and a producer
//   warpgroup whose first warp's first lane starts every copy (the other
//   three warps exit at once).  With two consumer warpgroups, setmaxnreg
//   moves registers from the producer (24 a thread) to the consumers (240):
//   168 at launch, 3 x 168 = 24 + 2 x 240, the block's pool balanced.  The
//   role branch reads the warp index through a shuffle from lane 0: only
//   when ptxas can prove the branch warp-uniform does it compile the
//   consumers for 240 registers rather than the launch's 168 (the spills
//   at D = 192 fell by more than half, and the time by about a quarter).
// - Loads by TMA.  The block's Q tile once, then K and V tiles of BN = 64
//   keys into a ring of two stages, each with a full and an empty mbarrier.
//   A tile lies in shared memory as DB blocks of 64 columns (128 bytes a row,
//   the 128-byte swizzle that the wgmma descriptors name), filled by one TMA
//   box each from a (BH, T, D) tensor map; rows past T and columns past D
//   arrive as zeros (TMA's out-of-bounds fill).  Only ceil(kv_len / BN) tiles
//   are loaded; a block whose first row is at or past kv_len loads nothing.
//   A wait on an mbarrier that has not completed within seconds traps.
// - S = Q K^T: wgmma m64n64k16, both operands K-major from shared memory,
//   each 64-column block of D (4 k-steps) into a fresh float32 accumulator
//   (two in turn, the first two blocks in flight together), the blocks
//   summed in float32.  The
//   softmax keeps flash_fwd_16's scaling, exp2f((s - m) * log2(e) /
//   sqrt(D)); the row max and sum reduce over the 4 lanes that share a row
//   of the accumulator; only the keys past kv_len in the last tile are
//   masked.
// - P V: p * P_SCALE<E> split into three 16-bit parts (split_pair).  The S
//   accumulator's registers are the A fragment of a register-A wgmma as they
//   lie, so each part is a wgmma m64n64k16 with A from registers and B the V
//   tile, MN-major (the descriptor's transpose bit), 64 output columns at a
//   time.  Each tile's p v for a 64-column chunk goes into a fresh float32
//   accumulator, then O = O * alpha + fresh in float32: the tensor core
//   truncates its sums, and an accumulator fed tile after tile drifts past
//   the bar (as in the other two forms, and here too at (16, 2048, 192)).
//   Registers at D = 192: O 96, two S accumulators 64 while q k^T runs,
//   then the p parts 48 and the fresh accumulator 32 (S's registers).
// - Overlap: the producer keeps the next tile in flight during the current
//   one's products and softmax; the two consumer warpgroups of a block run
//   their softmax and products interleaved by the warp schedulers.  A
//   ping-pong of the two on named barriers (each passing the tensor cores
//   to the other around its q k^T and around its p v) measured slower and
//   was not kept; starting S of tile j + 1 before the softmax of tile j
//   needs 64 more registers than the consumers have.
// - Epilogue: O / l rounded once to E; or, where the plan splits each head's
//   key tiles into parts, the unnormalised float32 (o, max, sum) in the
//   workspace layout of flash_fwd_16, combined by flash_merge<E>.

constexpr int BN = 64;          // keys a K/V tile
constexpr int WG_ROWS = 64;     // query rows a consumer warpgroup
constexpr int BLOCK_COLS = 64;  // 16-bit columns of one 128-byte swizzled block
constexpr int ROW_BYTES = 128;
constexpr int SM90_STAGES = 2;  // K/V tiles in the ring (three measured no faster)

// Shared memory a block of flash_fwd_16_sm90 needs: Q, the K/V ring, the
// mbarriers and 1024 bytes to align the swizzled blocks
constexpr size_t sm90_smem_bytes(int nwg, int db) {
    return 1024 + (size_t)db * ROW_BYTES * (nwg * WG_ROWS + SM90_STAGES * 2 * BN) +
           8 * (1 + 2 * SM90_STAGES);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of this parity has completed.  A wait that has not ended
// after ~2^34 cycles (seconds) traps: a broken pipeline fails the launch
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    const long long t0 = clock64();
    while (true) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
        if (done) return;
        if (clock64() - t0 > (1ll << 34)) __trap();
    }
}

// one TMA box of a (BH, T, D) tensor map: columns c0.., rows c1.., head c2
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// A wgmma shared-memory descriptor for 128-byte-swizzled blocks of 8 rows of
// 128 bytes (1024-byte aligned): SBO = 1024 bytes between 8-row groups, LBO
// the stride between 64-column blocks (read only for MN-major operands wider
// than one block), layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo_bytes) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads of an accumulator across a wait
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FA_D32                                                                                 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FA_ACC32(d)                                                                          \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A B, m64n64k16: A and B K-major in shared memory (descriptors);
// accumulate = 0 overwrites d
template <typename E>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    if constexpr (std::is_same<E, __nv_bfloat16>::value)
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32
            ", %32, %33, p, 1, 1, 0, 0;\n}"
            : FA_ACC32(d)
            : "l"(a), "l"(b), "r"(accumulate));
    else
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " FA_D32
            ", %32, %33, p, 1, 1, 0, 0;\n}"
            : FA_ACC32(d)
            : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n64k16: A from registers (the m16n8k16 A fragment of each
// warp's 16 rows), B MN-major in shared memory (transpose bit set)
template <typename E>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
    if constexpr (std::is_same<E, __nv_bfloat16>::value)
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32
            ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
            : FA_ACC32(d)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
    else
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " FA_D32
            ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
            : FA_ACC32(d)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// E: __nv_bfloat16 or __half; NWG: consumer warpgroups (64 query rows each);
// DB: 64-column blocks of D.  Threads: 128 * NWG consumers, then the
// producer warpgroup.  The maps describe q, k, v as (BH, T, D) with boxes of 64
// columns by NWG * 64 rows (q) or BN rows (k, v).
template <typename E, int NWG, int DB>
__global__ void __launch_bounds__(128 * NWG + 128, 1)
flash_fwd_16_sm90(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const int* __restrict__ kv_lens,
                  E* __restrict__ out, float* __restrict__ part, int T, int D,
                  float scale_log2) {  // keep in step with launch()
    constexpr int BQ = NWG * WG_ROWS;
    constexpr uint32_t Q_BLOCK = BQ * ROW_BYTES;  // bytes of a 64-column block of Q
    constexpr uint32_t KV_BLOCK = BN * ROW_BYTES;
    constexpr uint32_t TILE = DB * KV_BLOCK;  // a K or a V tile
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint8_t* qs = smem;
    uint8_t* kvs = qs + DB * Q_BLOCK;  // stage s: K at kvs + 2 s TILE, V after it
    uint64_t* bars = reinterpret_cast<uint64_t*>(kvs + SM90_STAGES * 2 * TILE);
    uint64_t* q_full = bars;
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + SM90_STAGES;

    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * BQ;
    const size_t base = (size_t)bh * T * D;
    int kv_len = kv_lens[bh];
    kv_len = kv_len < 0 ? 0 : (kv_len > T ? T : kv_len);
    const int nsplit = gridDim.z;
    const int n_tiles = (kv_len + BN - 1) / BN;
    const int per = (n_tiles + nsplit - 1) / nsplit;
    const int jb = blockIdx.z * per;
    const int je = jb + per < n_tiles ? jb + per : n_tiles;
    if (q0 >= kv_len || jb >= je) {  // no valid query row or no key: nothing loaded
        const int n = (T - q0 < BQ ? T - q0 : BQ) * D;
        for (int i = threadIdx.x; nsplit == 1 && i < n; i += blockDim.x)
            out[base + (size_t)q0 * D + i] = to_elem<E>(0.f);
        return;
    }

    // warp-uniform as ptxas can prove it (a shuffle from lane 0): without
    // that, it compiles the consumers within the launch's 168 registers and
    // not within setmaxnreg's 240
    const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
    const int lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < SM90_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 128 * NWG);  // every consumer thread releases a stage
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp >= 4 * NWG) {  // the producer warpgroup: one lane starts every copy
        if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
        if (warp == 4 * NWG && lane == 0) {
            mbar_expect_tx(q_full, DB * Q_BLOCK);
#pragma unroll
            for (int b = 0; b < DB; ++b)
                tma_load(qs + b * Q_BLOCK, &qmap, q_full, b * BLOCK_COLS, q0, bh);
            for (int j = jb; j < je; ++j) {
                const int i = j - jb, s = i % SM90_STAGES;
                mbar_wait(&empty[s], ((i / SM90_STAGES) & 1) ^ 1);  // the first round passes
                mbar_expect_tx(&full[s], 2 * TILE);
                uint8_t* ks = kvs + 2 * s * TILE;
#pragma unroll
                for (int b = 0; b < DB; ++b) {
                    tma_load(ks + b * KV_BLOCK, &kmap, &full[s], b * BLOCK_COLS, j * BN, bh);
                    tma_load(ks + TILE + b * KV_BLOCK, &vmap, &full[s], b * BLOCK_COLS, j * BN, bh);
                }
            }
        }
    } else {  // a consumer warpgroup: 64 query rows
        if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
        const int wg = warp >> 2;
        const int g = lane >> 2, tg = lane & 3;
        const int r0 = q0 + wg * WG_ROWS + (warp & 3) * 16;  // this warp's first row
        const bool active = q0 + wg * WG_ROWS < kv_len;       // a warpgroup past kv_len only releases
        // descriptors of this warpgroup's Q rows and of stage 0's K and V
        // tiles; a k-step or a stage adds its byte offset / 16
        const uint64_t q_desc = smem_desc(qs + wg * WG_ROWS * ROW_BYTES, 16);
        const uint64_t k_desc = smem_desc(kvs, 16);
        const uint64_t v_desc = smem_desc(kvs + TILE, KV_BLOCK);

        float o[DB][32];
#pragma unroll
        for (int c = 0; c < DB; ++c)
#pragma unroll
            for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
        float m0 = MASKED, m1 = MASKED;  // running max of raw scores, rows g and g + 8
        float l0 = 0.f, l1 = 0.f;        // this lane's share of the running sums

        mbar_wait(q_full, 0);
        for (int j = jb; j < je; ++j) {
            const int i = j - jb, s = i % SM90_STAGES;
            mbar_wait(&full[s], (i / SM90_STAGES) & 1);
            if (active) {
                const uint32_t stage = (2 * s * TILE) >> 4;

                // s = q k^T (raw), 64 x 64: each 64-column block of D (4 k16
                // steps of 16 columns, 32 bytes) into a fresh accumulator, the
                // blocks summed in float32: block 0 into sc and blocks 1.. in
                // turn into sa, blocks 0 and 1 in flight together (a third
                // accumulator, to keep block b + 1 in flight while block b is
                // added, cost more in spills than it gained).  The columns
                // past D are zeros and add exactly 0.  A chain of all 4 * DB
                // steps in one accumulator costs the tensor core's truncated
                // sums at every step: at D = 192, softmax logits of std 1 and
                // float16, it put outputs near 0 farther from the plain
                // version than flash_fwd_16, and block sums are as close as
                // it.  sc is also the fresh accumulator of p v below: the two
                // are never live together.
                float sc[32], sa[32];
                wgmma_fence();
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    wgmma_ss<E>(sc, q_desc + 2 * k, k_desc + stage + 2 * k, k > 0);
                wgmma_commit();
#pragma unroll
                for (int b = 1; b < DB; ++b) {
                    if (b >= 2) {  // block b - 1 holds sa: add it first
                        wgmma_wait_all();
                        fence_regs(sa);
                        fence_regs(sc);
#pragma unroll
                        for (int e = 0; e < 32; ++e) sc[e] += sa[e];
                    }
                    wgmma_fence();
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        wgmma_ss<E>(sa, q_desc + b * (Q_BLOCK >> 4) + 2 * k,
                                    k_desc + stage + b * (KV_BLOCK >> 4) + 2 * k, k > 0);
                    wgmma_commit();
                }
                wgmma_wait_all();
                fence_regs(sc);
                if (DB >= 2) {
                    fence_regs(sa);
#pragma unroll
                    for (int e = 0; e < 32; ++e) sc[e] += sa[e];
                }

                // lane holds rows g (sc[4n], sc[4n + 1]) and g + 8 (sc[4n + 2],
                // sc[4n + 3]) at keys j * BN + 8n + 2tg + {0, 1}
                const int kv0 = j * BN;
                if (kv0 + BN > kv_len) {
#pragma unroll
                    for (int n = 0; n < 8; ++n)
#pragma unroll
                        for (int e = 0; e < 2; ++e)
                            if (kv0 + n * 8 + 2 * tg + e >= kv_len) sc[4 * n + e] = sc[4 * n + 2 + e] = MASKED;
                }
                float mx0 = m0, mx1 = m1;
#pragma unroll
                for (int n = 0; n < 8; ++n) {
                    mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
                    mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
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

                // p * P_SCALE in three parts h, as the A fragments of p v: k16
                // step kk takes slices 2kk (registers 0, 1: rows g, g + 8) and
                // 2kk + 1 (registers 2, 3); each fragment's four registers side
                // by side, as the product reads them
                uint32_t pp[4][3][4];
                float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
                for (int n = 0; n < 8; ++n) {
                    const float p0 = exp2f((sc[4 * n] - mx0) * scale_log2);
                    const float p1 = exp2f((sc[4 * n + 1] - mx0) * scale_log2);
                    const float p2 = exp2f((sc[4 * n + 2] - mx1) * scale_log2);
                    const float p3 = exp2f((sc[4 * n + 3] - mx1) * scale_log2);
                    sum0 += p0 + p1;
                    sum1 += p2 + p3;
                    constexpr float c = P_SCALE<E>;
                    uint32_t lo[3], hi[3];
                    split_pair<E>(p0 * c, p1 * c, lo);
                    split_pair<E>(p2 * c, p3 * c, hi);
#pragma unroll
                    for (int h = 0; h < 3; ++h) {
                        pp[n / 2][h][2 * (n % 2)] = lo[h];
                        pp[n / 2][h][2 * (n % 2) + 1] = hi[h];
                    }
                }
                l0 = l0 * alpha0 + sum0;
                l1 = l1 * alpha1 + sum1;

                // o = o * alpha + p v, 64 columns at a time, each tile's p v in
                // a fresh accumulator; the small parts first
#pragma unroll
                for (int c = 0; c < DB; ++c) {
                    float (&acc)[32] = sc;
                    wgmma_fence();
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                        for (int h = 2; h >= 0; --h)
                            wgmma_rs<E>(acc, pp[kk][h],
                                        v_desc + stage + ((c * KV_BLOCK + kk * 16 * ROW_BYTES) >> 4),
                                        kk > 0 || h < 2);
                    wgmma_commit();
                    wgmma_wait_all();
                    fence_regs(acc);
                    constexpr float unscale = 1.f / P_SCALE<E>;  // a power of 2: exact
#pragma unroll
                    for (int n = 0; n < 8; ++n) {
                        o[c][4 * n] = fmaf(o[c][4 * n], alpha0, acc[4 * n] * unscale);
                        o[c][4 * n + 1] = fmaf(o[c][4 * n + 1], alpha0, acc[4 * n + 1] * unscale);
                        o[c][4 * n + 2] = fmaf(o[c][4 * n + 2], alpha1, acc[4 * n + 2] * unscale);
                        o[c][4 * n + 3] = fmaf(o[c][4 * n + 3], alpha1, acc[4 * n + 3] * unscale);
                    }
                    fence_regs(o[c]);  // this chunk's update before the next chunk's products
                }
            }
            mbar_arrive(&empty[s]);  // this stage may take tile j + SM90_STAGES
        }

        if (!active) {  // every row of this warpgroup is at or past kv_len
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
            for (int c = 0; c < DB; ++c)
#pragma unroll
                for (int n = 0; n < 8; ++n) {
                    const int col = c * BLOCK_COLS + n * 8 + 2 * tg;  // D % 8 == 0: col + 1 < D too
                    if (col < D) {
                        if (ra < T) {
                            po[(size_t)ra * D + col] = o[c][4 * n];
                            po[(size_t)ra * D + col + 1] = o[c][4 * n + 1];
                        }
                        if (rb < T) {
                            po[(size_t)rb * D + col] = o[c][4 * n + 2];
                            po[(size_t)rb * D + col + 1] = o[c][4 * n + 3];
                        }
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
        using E2 = typename Pair<E>::T2;
#pragma unroll
        for (int c = 0; c < DB; ++c)
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                const int col = c * BLOCK_COLS + n * 8 + 2 * tg;
                if (col < D) {
                    if (ra < T)
                        *reinterpret_cast<E2*>(out + base + (size_t)ra * D + col) =
                            Pair<E>::of(o[c][4 * n] * inv0, o[c][4 * n + 1] * inv0);
                    if (rb < T)
                        *reinterpret_cast<E2*>(out + base + (size_t)rb * D + col) =
                            Pair<E>::of(o[c][4 * n + 2] * inv1, o[c][4 * n + 3] * inv1);
                }
            }
    }
}

#undef FA_D32
#undef FA_ACC32

// libcuda's cuTensorMapEncodeTiled, reached through the CUDA runtime so
// that the library needs no -lcuda; null where libcuda lacks it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                                 cudaEnableDefault, &found);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p)
                   : nullptr;
    }();
    return fn;
}

// A (BH, T, D) 16-bit tensor as TMA boxes of 64 columns by `rows` rows, the
// 128-byte swizzle, zeros out of bounds
cudaError_t tensor_map(CUtensorMap* map, const void* x, bool bf16, int BH, int T, int D, int rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
    const cuuint32_t box[3] = {(cuuint32_t)BLOCK_COLS, (cuuint32_t)rows, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult r = encode(
        map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 3,
        const_cast<void*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
