// The candidate walk both neighbor sweeps share (block_sweep.cu, B1 / B2;
// cell_sweep.cu, B3 / B3s): one warp sweeps a GROUP of at most 32 selves
// whose stencil rows are the same - one (y, z) cell row in 3D, one y row in
// 2D - in three steps per stencil row.
//
//   Stage.   The union of the group's candidate ranges,
//            [cell_start[row + min x_lo], cell_start[row + max x_hi + 1]),
//            is one contiguous run of sorted rows.  It is copied into the
//            warp's own slice of shared memory in tiles of WALK_TILE packed
//            rows, double-buffered: 16-byte cp.async copies, one commit group
//            per tile, the next tile (of this stencil row or the next one)
//            in flight while the current one is walked.  Only __syncwarp
//            orders the lanes; no block-wide barrier.
//   Filter.  Every lane tests its own self against every row of the tile -
//            the same trip count on all lanes, the cheap test on full lanes.
//            It accepts row j when j lies in its OWN clamped x range
//            (jb_i <= j < je_i, an index test, which keeps the stencil of the
//            stale cell coordinates exact), j != i, and d2 <= H2 on the
//            unfused d2 of pair_distance2 (written !(d2 > H2), the old walk's
//            test, so that a NaN is taken as it was).  The d2 tests of the
//            tile make a 64-bit word; the own range less the self is one
//            mask, applied once.  The accepted tile offsets are the set bits:
//            the lane's compacted list, ascending by construction.
//   Compute. The tile's pairs are evaluated (pair_terms) and folded into
//            each self's sums (fold_terms) in R rounds, R chosen per tile
//            from the accept masks: the fewest rounds >= ceil(all pairs /
//            32) whose pairs past them fit the queue (walk_queue<K>()
//            pairs, WALK_TERM_BYTES of terms).  R never passes the busiest
//            lane's count, where nothing is queued.
//
//            Cooperative (R < busiest): every lane evaluates its own first
//            pairs, up to R, with its self row in registers, and folds them
//            at once.  The pairs past a lane's R-th go to a queue in shared
//            memory (owner lane << 6 | offset), at the place an exclusive
//            warp scan of the excesses gives it: lane-major, ascending.
//            Lanes with fewer than R pairs take the queued pairs in their
//            spare rounds (a second scan, packed in the same word, numbers
//            those rounds), evaluate them with the owner's self row and own
//            cell (staged in shared memory by walk_stage_self) and write the
//            K terms to the pair's slot.  After __syncwarp each owner folds
//            its slots in order: they are its last pairs, so its order
//            holds.  A tile whose excess would overflow the queue runs more
//            rounds, so no pair is ever dropped.
//            Per lane (R = busiest): the same loop with nothing queued;
//            lanes with fewer pairs idle.  On the 3D dam breaks the busiest
//            lane holds ~2.8 times the mean over a pass (a lane's pairs
//            gather in the stencil rows next to its position in the cell);
//            R is about the mean (ops/block_sweep.py:pass_bodies).
//
//            The cooperative path's own cost (the scans, the queue, the
//            queued terms' round trip) is under one round: on an H100
//            (700 W), asking it to save two rounds before taking it ran
//            -0.8 to +3.8 % against one, slower in 16 of 24 kernel-state
//            pairs of walk_variants.py (B1 and B3, whole and windowed; e.g.
//            0.0821 against 0.0809 ms on the 2D square, 0.675 against 0.667
//            on the mDBC deck), so a tile takes it whenever it saves a round.
//
// The order: stencil rows z then y, then j ascending within the row - the
// order of the one-thread-per-self walk this replaces.  Each self folds its
// pairs' terms in that order on either path, and a pair's terms come from
// the one call of pair_terms in the walk, on the same inputs, whichever lane
// makes it.  So a self's sums do not depend on which path a tile took nor on
// how the selves were grouped into warps: B1 and B3 agree bit for bit, and a
// slab with its single launch.  Tile boundaries do not enter the order.
//
// Lanes outside the group (another subgroup of the warp, a row past the end,
// an inactive row) take part in the staging and in every warp-wide step with
// empty own ranges: their masks stay 0 and their sums untouched; on the
// cooperative path they evaluate other lanes' queued pairs.
//
// Resources per warp (WalkShared): 2 x WALK_TILE x 16 NV bytes of tiles
// (6 KB in 3D, 4 KB in 2D), the lanes' self rows (32 x 16 NV bytes) and own
// cells (256 B), the queued terms (WALK_TERM_BYTES or fewer) and the queue
// (2 bytes a pair): 11,392 B in 3D at K = 4.  WALK_WARPS warps a block, in
// dynamic shared memory sized per instance (walk_shared_bytes): 45,568 B a
// block for the main 3D instance, 5 blocks an SM where the tiles alone let
// 7 fit.  Smaller footprints measured slower on the dam break (B1 on an
// H100, 700 W): 32-row tiles with 2,816 or 3,072 B of terms (7 / 6 blocks)
// 0.436 ms, 48-row tiles with 1,472 B (7 blocks) 0.417, the self rows read
// from the pack instead of staged (6 blocks) +5-9 %, against 0.387.

#pragma once

#include <climits>

#include "sph_pair_math.cuh"

constexpr int WALK_TILE = 64;                 // packed rows per staged tile: one mask bit each
static_assert(WALK_TILE == 64, "a tile's accept mask is one 64-bit word");
constexpr int WALK_WARPS = 4;                 // warps per block
constexpr int WALK_THREADS = 32 * WALK_WARPS;
constexpr unsigned FULL_MASK = 0xffffffffu;
// Bytes of queued pair terms a warp holds: 192 pairs of the main path's 4
// sums, about as many as its tiles queue (B1 0.3904-0.3915 ms on the dam
// break against 0.4073 with 2048 bytes; H100, 700 W), within 48 KB a block
// in every instance.
constexpr int WALK_TERM_BYTES = 3072;

// float4s per packed row (csrc/sph_kernel_functions.cuh::load_row)
template <int D>
__host__ __device__ constexpr int pack_vectors() { return D == 3 ? 3 : 2; }

// queued pairs a tile may hand to other lanes, for K terms a pair
template <int K>
__host__ __device__ constexpr int walk_queue() {
    return WALK_TERM_BYTES / (4 * K) > 8 ? WALK_TERM_BYTES / (4 * K) : 8;
}

// A warp's shared memory
template <int D, int K>
struct WalkShared {
    float4 tiles[2 * WALK_TILE * pack_vectors<D>()];  // the staged tiles, double-buffered
    float4 selves[32 * pack_vectors<D>()];            // each lane's self row
    int2 own_cell[32];                                // and its own cell [s_i, e_i)
    float terms[K * walk_queue<K>()];                 // term k of queued pair q at k * Q + q
    unsigned short queue[walk_queue<K>()];            // owner lane << 6 | tile offset
};

// The block's dynamic shared memory: one WalkShared a warp, sized per
// instance at the launch.  Under 48 KB a launch needs no attribute.
template <int D, int K>
__host__ __device__ constexpr int walk_shared_bytes() {
    return WALK_WARPS * (int)sizeof(WalkShared<D, K>);
}

// warp ``warp``'s WalkShared
template <int D, int K>
__device__ __forceinline__ WalkShared<D, K>& walk_shared(int warp) {
    static_assert(walk_shared_bytes<D, K>() <= 48 * 1024, "a launch would need the attribute");
#if defined(__CUDACC__)
    extern __shared__ __align__(16) unsigned char walk_smem[];
#else  // host_walk_check.py's host build: a block's threads share it, blocks run in turn
    static __align__(16) unsigned char walk_smem[walk_shared_bytes<D, K>()];
#endif
    return reinterpret_cast<WalkShared<D, K>*>(walk_smem)[warp];
}

// A 16-byte copy from device to shared memory: cp.async where the target has
// it (sm_80 on), a plain copy elsewhere.
__device__ __forceinline__ void stage16(float4* dst, const float4* src) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
    *dst = *src;
#endif
}

__device__ __forceinline__ void stage_commit() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
    asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most one commit group of this lane is still in flight
__device__ __forceinline__ void stage_wait_all_but_one() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
    asm volatile("cp.async.wait_group 1;\n" ::);
#endif
}

// packed rows [t0, t0 + nt) into ``buf``, the 32 lanes side by side
template <int D>
__device__ __forceinline__ void stage_tile(float4* buf, const float4* pack, int t0, int nt,
                                           int lane) {
    constexpr int NV = pack_vectors<D>();
    const float4* src = pack + (size_t)t0 * NV;
    for (int k = lane; k < nt * NV; k += 32) stage16(buf + k, src + k);
}

// the lowest n bits of a 64-bit word, 0 <= n <= 64 (a shift by 64 is undefined)
__device__ __forceinline__ unsigned long long low_bits(int n) {
    return n >= 64 ? ~0ull : (1ull << n) - 1ull;
}

// What one lane brings to a pass of the walk.
struct WalkLane {
    bool member;      // its self is in this pass's group
    int i;            // the self's pack row; i - lane is the same on every lane
    int xl, xh;       // its clamped x range [x - 1, x + 1]
    int s_i, e_i;     // its own cell's rows (the density-diffusion role)
};

// Stencil row ``s`` (0 .. 3^(D-1) - 1: z outer, y inner, each -1, 0, +1) of
// a group whose selves sit in cell row (ry, rz), unclamped: false when the
// row lies outside the grid or the group's union of candidates there is
// empty; else the union [ub, ue) over x range [uxl, uxh] and the lane's own
// candidate range [jb, je) (empty off the group).
template <int D, class Params>
__device__ __forceinline__ bool walk_row(const Params& P, const int* __restrict__ cell_start,
                                         int s, int ry, int rz, int uxl, int uxh,
                                         const WalkLane& L, int& ub, int& ue, int& jb,
                                         int& je) {
    const int y = ry + (D == 3 ? s % 3 : s) - 1;
    if (y < 0 || y >= P.shape[1]) return false;
    int base = y * P.strides[1];
    if constexpr (D == 3) {
        const int z = rz + s / 3 - 1;
        if (z < 0 || z >= P.shape[2]) return false;
        base += z * P.strides[2];
    }
    ub = cell_start[base + uxl];
    ue = cell_start[base + uxh + 1];
    jb = L.member ? cell_start[base + L.xl] : 0;
    je = L.member ? cell_start[base + L.xh + 1] : 0;
    return ub < ue;
}

// The position of set bit n (counted from 0) of a word with more than n set bits
__device__ __forceinline__ int nth_bit(unsigned long long m, int n) {
    int pos = 0;
#pragma unroll
    for (int w = 32; w >= 1; w >>= 1) {
        const int c = __popcll(m & low_bits(w));
        if (n >= c) {
            n -= c;
            m >>= w;
            pos += w;
        }
    }
    return pos;
}

// The lane's self row and own cell, where the lanes that evaluate its queued
// pairs read them: every lane, before the passes over its self (visible
// after the walk's first __syncwarp; the last pass ended with one).
template <int D, int K>
__device__ __forceinline__ void walk_stage_self(WalkShared<D, K>& sh, const Row& s,
                                                const WalkLane& L) {
    const int lane = threadIdx.x & 31;
    store_row<D>(sh.selves, lane, s);
    sh.own_cell[lane] = make_int2(L.s_i, L.e_i);
}

// The compute step of one tile (the header's rule): every accepted pair of
// the tile's lanes, this lane's accepted offsets in ``take``.  One loop of
// ``rounds`` rounds and one call of pair_terms serve both paths.
template <int D, bool SPS, bool STORE, bool SHIFT, int FAM, int VISC, int DIFF, class Params>
__device__ __forceinline__ void walk_tile_pairs(const Params& P,
                                                WalkShared<D, n_sums<D, STORE, SHIFT>()>& sh,
                                                const float4* tile, int t0,
                                                unsigned long long take, const WalkLane& L,
                                                const Row& s, float* acc) {
    constexpr int K = n_sums<D, STORE, SHIFT>();
    constexpr int Q = walk_queue<K>();
    const int lane = threadIdx.x & 31;
    const int mine = __popcll(take);
    const int busiest = __reduce_max_sync(FULL_MASK, mine);
    if (busiest == 0) return;
    // the fewest rounds >= ceil(pairs / 32) whose pairs past them fit the
    // queue; never more than busiest, where nothing is queued (per lane)
    int rounds = (__reduce_add_sync(FULL_MASK, mine) + 31) >> 5;
    while (__reduce_add_sync(FULL_MASK, max(mine - rounds, 0)) > Q) ++rounds;
    const int own = min(mine, rounds);  // pairs this lane evaluates for itself
    const int excess = mine - own;      // ... and hands to the queue
    int first = 0;                      // its first queue entry
    int steal = 0;                      // the first entry it takes in its spare rounds
    int queued = 0;                     // the tile's queued pairs
    if (rounds < busiest) {
        // exclusive scans of the excess and of the spare rounds, in one word
        const int v = excess | (rounds - own) << 16;
        int incl = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int u = __shfl_up_sync(FULL_MASK, incl, d);
            if (lane >= d) incl += u;
        }
        queued = __shfl_sync(FULL_MASK, incl, 31) & 0xffff;
        first = (incl - v) & 0xffff;
        steal = (incl - v) >> 16;
        if (excess) {                   // its pairs past its rounds, ascending
            unsigned long long tail = take & ~low_bits(nth_bit(take, own));
            for (int q = first; tail != 0ull; ++q) {
                sh.queue[q] = (unsigned short)(lane << 6 | (__ffsll(tail) - 1));
                tail &= tail - 1ull;
            }
        }
        __syncwarp();
    }
    const int i0 = L.i - lane;          // the self row of lane o is i0 + o
    unsigned long long rest = take;
    for (int k = 0; k < rounds; ++k) {
        int jj, slot = -1, oi = L.i;
        Row so = s;                     // the pair's self: this lane's, in registers,
        int2 oc = make_int2(L.s_i, L.e_i);
        if (k < own) {                  // its own next pair, folded at once
            jj = __ffsll(rest) - 1;
            rest &= rest - 1ull;
        } else {                        // a queued pair of another lane
            slot = steal + k - own;
            if (slot >= queued) break;
            const int e = sh.queue[slot];
            const int o = e >> 6;
            jj = e & 63;
            so = load_row<D>(sh.selves, o);  // ... or its owner's, the same bits
            oc = sh.own_cell[o];
            oi = i0 + o;
        }
        const int j = t0 + jj;
        const Row c = load_row<D>(tile, jj);
        float xij[D];
        const float d2 = pair_distance2<D>(so, c, xij);
        const bool same_cell = (j >= oc.x) && (j < oc.y);
        float t[K];
        pair_terms<D, SPS, STORE, SHIFT, FAM, VISC, DIFF>(
            P, so, c, xij, d2, same_cell ? (oi < j) : (oi > j), t);
        if (slot < 0) {
            fold_terms<K>(acc, t);
        } else {
#pragma unroll
            for (int kk = 0; kk < K; ++kk) sh.terms[kk * Q + slot] = t[kk];
        }
    }
    if (rounds < busiest) {
        __syncwarp();                   // every queued pair has its terms
        for (int q = first; q < first + excess; ++q) {
            float t[K];
#pragma unroll
            for (int kk = 0; kk < K; ++kk) t[kk] = sh.terms[kk * Q + q];
            fold_terms<K>(acc, t);
        }
    }
}

// One pass of the warp over its group: every member lane adds the pairs of
// its self ``s`` (pack row L.i) to acc.  Called by all 32 lanes of the warp
// together, after walk_stage_self; ``sh`` is the warp's shared memory.
template <int D, bool SPS, bool STORE, bool SHIFT, int FAM, int VISC, int DIFF, class Params>
__device__ __forceinline__ void walk_pass(const Params& P, const float4* __restrict__ pack,
                                          const int* __restrict__ cell_start,
                                          WalkShared<D, n_sums<D, STORE, SHIFT>()>& sh,
                                          int ry, int rz, const WalkLane& L, const Row& s,
                                          float* acc) {
    constexpr int NV = pack_vectors<D>();
    constexpr int S = (D == 3) ? 9 : 3;
    constexpr int T = WALK_TILE;
    const int lane = threadIdx.x & 31;
    const int uxl = __reduce_min_sync(FULL_MASK, L.member ? L.xl : INT_MAX);
    const int uxh = __reduce_max_sync(FULL_MASK, L.member ? L.xh : -1);

    int row = 0, ub = 0, ue = 0, jb = 0, je = 0;
    while (row < S && !walk_row<D>(P, cell_start, row, ry, rz, uxl, uxh, L, ub, ue, jb, je))
        ++row;
    if (row == S) return;
    float4* tiles = sh.tiles;
    int t0 = ub, buf = 0;
    stage_tile<D>(tiles, pack, t0, min(T, ue - t0), lane);
    stage_commit();
    while (true) {
        // the tile after this one: the rest of this row, or the next row's first
        int nrow = row, n0 = t0 + T, nub = ub, nue = ue, njb = jb, nje = je;
        if (n0 >= ue) {
            do {
                ++nrow;
            } while (nrow < S
                     && !walk_row<D>(P, cell_start, nrow, ry, rz, uxl, uxh, L, nub, nue, njb,
                                     nje));
            n0 = nub;
        }
        const bool more = nrow < S;
        if (more) stage_tile<D>(tiles + (buf ^ 1) * T * NV, pack, n0, min(T, nue - n0), lane);
        stage_commit();                 // an empty group when nothing follows
        stage_wait_all_but_one();       // this lane's copies of the current tile are in
        __syncwarp();                   // ... and every lane's are visible

        const float4* tile = tiles + buf * T * NV;
        const int nt = min(T, ue - t0);
        // the d2 tests of the tile's rows, one bit each
        unsigned long long in_h = 0ull;
        for (int jj = 0; jj < nt; ++jj) {
            const float4 r = tile[jj * NV];
            Row c;
            c.x[0] = r.x;
            c.x[1] = r.y;
            if constexpr (D == 3) c.x[2] = r.z;
            float xij[D];
            in_h |= (unsigned long long)!(pair_distance2<D>(s, c, xij) > P.H2) << jj;
        }
        // ... kept where they lie in the lane's own range [jb, je) and are not
        // its self: one mask, applied once to the tile's tests
        const int lo = min(max(jb - t0, 0), T), hi = min(max(je - t0, 0), T);
        unsigned long long own = low_bits(hi) & ~low_bits(lo);
        if ((unsigned)(L.i - t0) < (unsigned)T) own &= ~(1ull << (L.i - t0));
        walk_tile_pairs<D, SPS, STORE, SHIFT, FAM, VISC, DIFF>(P, sh, tile, t0, in_h & own, L,
                                                               s, acc);
        __syncwarp();                   // every lane is done with this buffer
        if (!more) break;
        row = nrow;
        t0 = n0;
        ub = nub;
        ue = nue;
        jb = njb;
        je = nje;
        buf ^= 1;
    }
}
