// The candidate walk both neighbor sweeps share (block_sweep.cu, B1 / B2;
// cell_sweep.cu, B3 / B3s): one warp sweeps a GROUP of at most 32 selves
// whose stencil rows are the same - one (y, z) cell row in 3D, one y row in
// 2D - in three steps per tile of the group's candidate stream.
//
//   Stage.   The union of the group's candidate ranges in a stencil row,
//            [cell_start[row + min x_lo], cell_start[row + max x_hi + 1]),
//            is one contiguous run of sorted rows.  The runs of the
//            stencil rows, in the walk's order, are one STREAM, copied into
//            the warp's own slice of shared memory in full tiles of
//            WALK_TILE packed rows: a tile may end one stencil row and
//            start the next ones, so only a pass's last tile is part-full
//            (on the 2,215,035-row dam break 16.2 tiles a pass, 0.967 full,
//            against 19.2 and 0.817 when a tile ended with its stencil row;
//            ops/block_sweep.py:schedule_stats).  Double-buffered: 16-byte
//            cp.async copies, one commit group per tile, the next tile in
//            flight while the current one is walked.  Only __syncwarp
//            orders the lanes; no block-wide barrier.  While a tile's
//            pieces are staged (walk_stage) each lane forms two masks of
//            it: OWN, the rows of its own clamped x range in each stencil
//            row (jb_i <= j < je_i, an index test, which keeps the stencil
//            of the stale cell coordinates exact) less its self; ROLE,
//            pair_terms' role_i of each row.  The stream's pack rows ascend,
//            so the rows below a pack row v are a prefix of the tile, whose
//            length the pieces add up: role_i = same_cell ? i < j : i > j
//            is low(below(i)) ^ (low(below(e_i)) & ~low(below(s_i))) for
//            every j != i.  No pack index is staged or kept per row.
//   Filter.  Every lane tests its own self against all WALK_TILE rows of
//            the tile, unrolled: each row's bit at a compile-time place in
//            one of two 32-bit words - d2 <= H2 on the unfused d2 of
//            pair_distance2 (written !(d2 > H2), the old walk's test, so
//            that a NaN is taken as it was).  OWN is applied once to the
//            word; the accepted tile offsets are its set bits, ascending.
//            A part-full tile is tested whole: its stale rows' bits fall
//            outside OWN.  11 instructions a row (SASS of the 3D cell
//            kernel), against 17.5-20 for the counted loop with a run-time
//            64-bit shift that tested each stencil row's tiles before;
//            testing a part-full tile's rows one by one instead took B3
//            6.03 against 5.97 ms on the large dam break's benchmark state
//            (B1 on the 160k deck 0.379 against 0.382; H100 80GB HBM3,
//            700 W; walk_variants.py).
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
//            memory (owner lane << 7 | role_i << 6 | offset), at the place
//            an exclusive warp scan of the excesses gives it: lane-major,
//            ascending.  Lanes with fewer than R pairs take the queued pairs
//            in their spare rounds (a second scan, packed in the same word,
//            numbers those rounds), evaluate them with the owner's self row
//            (staged in shared memory by walk_stage_self) and the owner's
//            role bit, and write the K terms to the pair's slot.  After __syncwarp each owner folds
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
// slab with its single launch.  Tile boundaries, inside a stencil row or
// between two, do not enter the order.
//
// Lanes outside the group (another subgroup of the warp, a row past the end,
// an inactive row) take part in the staging and in every warp-wide step with
// empty own ranges: their masks stay 0 and their sums untouched; on the
// cooperative path they evaluate other lanes' queued pairs.
//
// Resources per warp (WalkShared): 2 x WALK_TILE x 16 NV bytes of tiles
// (6 KB in 3D, 4 KB in 2D), the lanes' self rows (32 x 16 NV bytes), the
// queued terms (WALK_TERM_BYTES or fewer) and the queue (2 bytes a pair):
// 11,136 B in 3D at K = 4.  WALK_WARPS warps a block, in dynamic shared
// memory sized per instance (walk_shared_bytes): 44,544 B a block for the
// main 3D instance, 5 blocks an SM where the tiles alone let 7 fit.
// Smaller footprints measured slower on the dam break (B1 on an H100,
// 700 W): 32-row tiles with 2,816 or 3,072 B of terms (7 / 6 blocks) 0.436
// ms, 48-row tiles with 1,472 B (7 blocks) 0.417, the self rows read from
// the pack instead of staged (6 blocks) +5-9 %, against 0.387.  The
// kernels ask ptxas for those 5 blocks (WALK_MIN_BLOCKS): at most 96
// registers a thread.  Left to itself ptxas gave the unrolled filter's
// loads in flight up to 114 in the 3D instances with extras (4 blocks an
// SM); held to 96 they spill at most 4 bytes, and the main instances run
// as fast (B3 6.004 against 6.006 ms on the large cell's state, B1 0.385
// on the 160k deck either way; H100 80GB HBM3, 700 W).

#pragma once

#include <climits>

#include "sph_pair_math.cuh"

constexpr int WALK_TILE = 64;                 // packed rows per staged tile: one mask bit each
static_assert(WALK_TILE == 64, "a tile's accept mask is one 64-bit word");
constexpr int WALK_WARPS = 4;                 // warps per block
constexpr int WALK_THREADS = 32 * WALK_WARPS;
constexpr int WALK_MIN_BLOCKS = 5;            // blocks an SM the 3D walk's shared memory lets fit
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
    float terms[K * walk_queue<K>()];                 // term k of queued pair q at k * Q + q
    unsigned short queue[walk_queue<K>()];            // owner lane << 7 | role << 6 | offset
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

// packed rows [j0, j0 + n) into ``buf``, the 32 lanes side by side
template <int D>
__device__ __forceinline__ void stage_rows(float4* buf, const float4* pack, int j0, int n,
                                           int lane) {
    constexpr int NV = pack_vectors<D>();
    const float4* src = pack + (size_t)j0 * NV;
    for (int k = lane; k < n * NV; k += 32) stage16(buf + k, src + k);
}

// the lowest n bits of a 64-bit word, 0 <= n <= 64 (a shift by 64 is undefined)
__device__ __forceinline__ unsigned long long low_bits(int n) {
    return n >= 64 ? ~0ull : (1ull << n) - 1ull;
}

// What one lane brings to a pass of the walk.
struct WalkLane {
    bool member;      // its self is in this pass's group
    int i;            // the self's pack row
    int xl, xh;       // its clamped x range [x - 1, x + 1]
    int s_i, e_i;     // its own cell's rows (the density-diffusion role)
};

// Where a pass's candidate stream stands: stencil row ``row`` (S once the
// stream is done), the end ``ue`` of its union, the lane's own range
// [jb, je) in it, and ``pos``, its next row to stage.
struct WalkCursor {
    int row, pos, ue, jb, je;
};

// What a lane knows of a staged tile before its d2 tests: ``own``, the rows
// of its own ranges less its self; ``role``, the density-diffusion role_i
// of pair_terms for each row.
struct WalkTile {
    unsigned long long own, role;
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

// The lane's self row, where the lanes that evaluate its queued pairs read
// it: every lane, before the passes over its self (visible after the walk's
// first __syncwarp; the last pass ended with one).
template <int D, int K>
__device__ __forceinline__ void walk_stage_self(WalkShared<D, K>& sh, const Row& s) {
    store_row<D>(sh.selves, threadIdx.x & 31, s);
}

// Move the cursor to the first stencil row after c.row whose union has
// candidates, or to S.
template <int D, class Params>
__device__ __forceinline__ void walk_next_row(const Params& P, const int* __restrict__ cell_start,
                                              int ry, int rz, int uxl, int uxh,
                                              const WalkLane& L, WalkCursor& c) {
    constexpr int S = (D == 3) ? 9 : 3;
    do {
        ++c.row;
    } while (c.row < S
             && !walk_row<D>(P, cell_start, c.row, ry, rz, uxl, uxh, L, c.pos, c.ue, c.jb, c.je));
}

// The stage step: the next WALK_TILE rows of the stream from the cursor on,
// across stencil rows, into ``buf``, and the lane's masks of them.  A piece
// of n rows from pack row c.pos lands at tile offset nt.  The stream's pack
// rows ascend (stencil rows in cell-key order, x fastest), so the rows of a
// tile below a pack row v are its first below(v) = sum over the pieces of
// clamp(v - c.pos, 0, n) rows: the own cell [s_i, e_i) is the offsets
// [below(s_i), below(e_i)), the rows before the self the first below(i).
// role_i = same_cell ? i < j : i > j is then one word for every j != i.
template <int D, class Params>
__device__ __forceinline__ WalkTile walk_stage(const Params& P, const float4* __restrict__ pack,
                                               const int* __restrict__ cell_start, float4* buf,
                                               int ry, int rz, int uxl, int uxh,
                                               const WalkLane& L, WalkCursor& c) {
    constexpr int NV = pack_vectors<D>();
    constexpr int S = (D == 3) ? 9 : 3;
    const int lane = threadIdx.x & 31;
    WalkTile t = {0ull, 0ull};
    int nt = 0, below_i = 0, below_s = 0, below_e = 0;
    while (nt < WALK_TILE && c.row < S) {
        const int n = min(WALK_TILE - nt, c.ue - c.pos);
        stage_rows<D>(buf + nt * NV, pack, c.pos, n, lane);
        const int lo = min(max(c.jb - c.pos, 0), n), hi = min(max(c.je - c.pos, 0), n);
        unsigned long long own = low_bits(nt + hi) & ~low_bits(nt + lo);
        if ((unsigned)(L.i - c.pos) < (unsigned)n) own &= ~(1ull << (nt + L.i - c.pos));
        t.own |= own;
        below_i += min(max(L.i - c.pos, 0), n);
        below_s += min(max(L.s_i - c.pos, 0), n);
        below_e += min(max(L.e_i - c.pos, 0), n);
        nt += n;
        c.pos += n;
        if (c.pos == c.ue) walk_next_row<D>(P, cell_start, ry, rz, uxl, uxh, L, c);
    }
    t.role = low_bits(below_i) ^ (low_bits(below_e) & ~low_bits(below_s));
    return t;
}

// The filter step: the d2 test of all WALK_TILE rows of a tile against the
// lane's self, one bit a row at a compile-time place in one of two 32-bit
// words.  The rows of a part-full tile past its end hold stale data: their
// bits are set or not, and no own mask keeps them.
template <int D, class Params>
__device__ __forceinline__ unsigned long long walk_filter(const Params& P, const float4* tile,
                                                          const Row& s) {
    constexpr int NV = pack_vectors<D>();
    unsigned half[2] = {0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int b = 0; b < 32; ++b) {
            const float4 r = tile[(32 * h + b) * NV];
            Row c;
            c.x[0] = r.x;
            c.x[1] = r.y;
            if constexpr (D == 3) c.x[2] = r.z;
            float xij[D];
            if (!(pair_distance2<D>(s, c, xij) > P.H2)) half[h] |= 1u << b;
        }
    }
    return (unsigned long long)half[1] << 32 | half[0];
}

// The compute step of one tile (the header's rule): every accepted pair of
// the tile's lanes, this lane's accepted offsets in ``take`` and its roles
// in ``role``.  One loop of ``rounds`` rounds and one call of pair_terms
// serve both paths.
template <int D, bool SPS, bool STORE, bool SHIFT, int FAM, int VISC, int DIFF, class Params>
__device__ __forceinline__ void walk_tile_pairs(const Params& P,
                                                WalkShared<D, n_sums<D, STORE, SHIFT>()>& sh,
                                                const float4* tile, unsigned long long take,
                                                unsigned long long role, const Row& s,
                                                float* acc) {
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
                const int jj = __ffsll(tail) - 1;
                sh.queue[q] = (unsigned short)(lane << 7 | (int)(role >> jj & 1ull) << 6 | jj);
                tail &= tail - 1ull;
            }
        }
        __syncwarp();
    }
    unsigned long long rest = take;
    for (int k = 0; k < rounds; ++k) {
        int jj, slot = -1;
        bool role_i;
        Row so = s;                     // the pair's self: this lane's, in registers,
        if (k < own) {                  // its own next pair, folded at once
            jj = __ffsll(rest) - 1;
            rest &= rest - 1ull;
            role_i = role >> jj & 1ull;
        } else {                        // a queued pair of another lane
            slot = steal + k - own;
            if (slot >= queued) break;
            const int e = sh.queue[slot];
            jj = e & 63;
            role_i = e >> 6 & 1;
            so = load_row<D>(sh.selves, e >> 7);  // ... or its owner's, the same bits
        }
        const Row c = load_row<D>(tile, jj);
        float xij[D];
        const float d2 = pair_distance2<D>(so, c, xij);
        float t[K];
        pair_terms<D, SPS, STORE, SHIFT, FAM, VISC, DIFF>(P, so, c, xij, d2, role_i, t);
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
    const int uxl = __reduce_min_sync(FULL_MASK, L.member ? L.xl : INT_MAX);
    const int uxh = __reduce_max_sync(FULL_MASK, L.member ? L.xh : -1);

    WalkCursor c;
    c.row = -1;
    walk_next_row<D>(P, cell_start, ry, rz, uxl, uxh, L, c);
    if (c.row == S) return;
    float4* tiles = sh.tiles;
    int buf = 0;
    WalkTile cur = walk_stage<D>(P, pack, cell_start, tiles, ry, rz, uxl, uxh, L, c);
    stage_commit();
    while (true) {
        const bool more = c.row < S;    // the stream goes on past this tile
        WalkTile next = {0ull, 0ull};
        if (more)
            next = walk_stage<D>(P, pack, cell_start, tiles + (buf ^ 1) * T * NV, ry, rz, uxl,
                                 uxh, L, c);
        stage_commit();                 // an empty group when nothing follows
        stage_wait_all_but_one();       // this lane's copies of the current tile are in
        __syncwarp();                   // ... and every lane's are visible

        const float4* tile = tiles + buf * T * NV;
        const unsigned long long in_h = walk_filter<D>(P, tile, s);
        walk_tile_pairs<D, SPS, STORE, SHIFT, FAM, VISC, DIFF>(P, sh, tile, in_h & cur.own,
                                                               cur.role, s, acc);
        __syncwarp();                   // every lane is done with this buffer
        if (!more) break;
        cur = next;
        buf ^= 1;
    }
}
