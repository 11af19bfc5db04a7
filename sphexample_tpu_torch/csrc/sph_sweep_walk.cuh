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
//   Compute. Every lane walks its own mask lowest bit first and calls
//            add_pair on the row held in shared memory.  A warp pays the
//            pair body for the largest per-lane pair count of the tile, not
//            for every candidate that any lane accepts - on the 3D dam
//            breaks nearly as much, since a lane's pairs gather in the
//            stencil rows next to its position in the cell; over a whole
//            pass the busiest lane is near the mean (PERF.md).
//
// The order: stencil rows z then y, then j ascending within the row - the
// order of the one-thread-per-self walk this replaces.  Each self's sums are
// therefore added in the same order as before, and (with the same add_pair
// and the same pair_distance2) come out the same bits; B1 and B3 keep
// agreeing bit for bit.  Tile boundaries do not enter the order.
//
// Lanes outside the group (another subgroup of the warp, a row past the end,
// an inactive row) take part in the staging and in every warp-wide step with
// empty own ranges: their masks stay 0 and their sums untouched.
//
// Resources per warp: 2 x WALK_TILE x 16 NV bytes of tiles (6 KB in 3D, 4 KB
// in 2D); WALK_WARPS warps a block, all static shared memory.

#pragma once

#include <climits>

#include "sph_pair_math.cuh"

constexpr int WALK_TILE = 64;                 // packed rows per staged tile: one mask bit each
static_assert(WALK_TILE == 64, "a tile's accept mask is one 64-bit word");
constexpr int WALK_WARPS = 4;                 // warps per block
constexpr int WALK_THREADS = 32 * WALK_WARPS;
constexpr unsigned FULL_MASK = 0xffffffffu;

// float4s per packed row (csrc/sph_kernel_functions.cuh::load_row)
template <int D>
__host__ __device__ constexpr int pack_vectors() { return D == 3 ? 3 : 2; }

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
    int i;            // the self's pack row
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

// One pass of the warp over its group: every member lane adds the pairs of
// its self ``s`` (pack row L.i) to acc.  Called by all 32 lanes of the warp
// together; ``tiles`` is the warp's 2 x WALK_TILE x NV float4s.
template <int D, bool SPS, bool STORE, bool SHIFT, int FAM, int VISC, int DIFF, class Params>
__device__ __forceinline__ void walk_pass(const Params& P, const float4* __restrict__ pack,
                                          const int* __restrict__ cell_start, float4* tiles,
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
        const unsigned long long take = in_h & own;
        // lowest bit first, one 32-bit half at a time; one copy of the pair
        // body (the 2D all-extras body is large)
        unsigned bits = (unsigned)take, high = (unsigned)(take >> 32);
        int base = 0;
        while (true) {
            if (bits == 0u) {
                if (high == 0u) break;
                bits = high;
                high = 0u;
                base = 32;
            }
            const int jj = base + __ffs(bits) - 1;
            bits &= bits - 1u;
            const int j = t0 + jj;
            const Row c = load_row<D>(tile, jj);
            float xij[D];
            const float d2 = pair_distance2<D>(s, c, xij);
            const bool same_cell = (j >= L.s_i) && (j < L.e_i);
            add_pair<D, SPS, STORE, SHIFT, FAM, VISC, DIFF>(
                P, s, c, xij, d2, same_cell ? (L.i < j) : (L.i > j), acc);
        }
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
