// Stage 04 of the mDBC step - the ghost-node moment sums of the modified
// dynamic boundary condition and the density correction behind them - for
// NVIDIA Hopper (sm_90a).  Built by ops/_build.py with nvcc into a shared
// library with a plain C interface and bound with ctypes
// (ops/mdbc_moments.py).
//
// Replaces: sphexample_tpu/ops/pallas_mdbc.py::_make_mdbc_kernel (the TPU
// moment kernel) and the solve the JAX package leaves to XLA behind it.  Per
// ghost slot b with ghost point g it sums, over the fluid particles j within
// the support of g, the K = (D+1)(D+2) moments
//
//     b = sum m0 [W, grad W]                         (D+1 scalars)
//     A = sum [V_j W, V_j grad W] (x) [1, -x_gj]     ((D+1)^2 scalars)
//
// with x_gj = g - x_j and V_j = m0 / rho_j, and then (fused mode) solves
// A x = b by Cramer's rule and applies the decision tree of
// ops/mdbc.py::_mdbc_apply (reference SPHCellList.jl:606-621) to the
// density of the slot's particle.
//
// The TPU kernel's one idea is kept: ghosts are grouped by the cell of their
// ghost point (it argsorts them on every call), and a cell's candidate rows
// are staged once in fast memory for all of its ghosts.  Its layout (program
// tables, [R, 128] tiles, capacity windows) is not.  One C call runs:
//
//   1. mdbc_wet_group_kernel: per grid cell, whether it holds a fluid row.
//      mdbc_keys_group_kernel: per slot, the clamped cell of its ghost point
//      (map_floor: round half away from zero on the pitch H, the multiply and
//      the add unfused, so that the f32 key is the plain version's bit for
//      bit; clamped into the grid) and its rank in the cell (an atomic
//      histogram).  A slot that computes nothing is PARKED and launches no
//      warp: an invalid slot, or - when the compacted list's row index
//      ``bidx`` is given - a fill slot (past the ghost count every slot
//      indexes row 0, which only slot 0 may own; ops/mdbc.py:compact_ghosts).
//      On a slab of a sharded run the list has the global capacity, so most
//      slots are fill slots.  A slot is DRY when none of the 3^D cells of its
//      stencil holds a fluid row: the walk would take no candidate, every sum
//      would be +0 and the solve would keep the density, so this kernel
//      writes those outputs itself (zero moments, decision 0, the NaN scrub)
//      and the slot is not grouped.  On the mDBC dam break most walls are
//      dry: two thirds of the ghosts.
//   2. mdbc_cells_group_kernel: per grid cell with ghosts, its first place
//      in the sorted slot order and its work entries - chunks of at most
//      MDBC_CHUNK ghosts - from warp prefix sums and one atomic per warp.
//   3. mdbc_order_group_kernel: the counting sort's scatter of the slots.
//   4. mdbc_moments_kernel: persistent blocks of MDBC_WARPS warps take work
//      entries from a device counter.  A block computes its cell's 3^(D-1)
//      stencil row ranges [cell_start[key_lo], cell_start[key_hi + 1])
//      exactly as ops/cell_list.py::row_segments does (x clipped at the grid
//      edge, rows outside the grid empty) and stages the rows - position,
//      density and motion limiter, 20 bytes a row in 3D - into shared memory
//      with 4-byte cp.async copies, up to MDBC_STAGE_ROWS rows (rows past
//      that are read from device memory; an entry of one ghost reads them
//      all there).  Every ghost of the cell has exactly these candidates.
//      The warps then take the entry's ghosts, one ghost a warp at a time.
//
// No host sync: the entry count stays on the device.  The order of the
// slots inside a cell comes from atomics and changes from call to call; it
// decides only which warp takes a ghost, never a ghost's result.
//
// Per ghost the warp walks the stencil rows z, then y, and within a row the
// 32 lanes stride over the range: lane l takes j = start + l, start + l + 32,
// ... - the lane assignment and candidate order of the first version of this
// kernel (one warp per ghost slot, reading device memory), with the same
// per-candidate code, so that a ghost's f32 sums are those bits: they depend
// on the ghost's own candidate sequence alone, never on which ghosts share
// its block, on the staging, or on the slab that runs it.  The fluid test is
// ml_j > 0.5, the density is guarded (rho_j > 0 ? rho_j : 1) and V_j = m0 /
// rho_j is formed per accepted pair; the cutoff is d2 <= H2 on an
// elementwise d2.  An xor-butterfly shuffle reduction then leaves all K sums
// in every lane (the same bits in each: a + b = b + a).
//
// The epilogue (fused mode) runs in the state's dtype S (float or double)
// from the f32 moments cast to it, with the expression tree of
// ops/mdbc.py::_det3 / _det4 / _det_solve / _mdbc_apply and every product,
// sum and quotient rounded on its own (__fmul_rn and friends: no contraction
// into a multiply-add), so that the corrected density is the one torch's
// elementwise kernels give from the same moments: the determinant and the
// column-replaced determinants, sol = dets / det, rho_solve = sol0 + ((sol1
// d0 + sol2 d1) + sol3 d2) with d = x_b - g, rho_shepard = b0 / A00, solve
// when |det| >= 1e-3, else Shepard when A00 > 0, else keep; NaN -> rho0.
// Lane 0 writes the corrected density of row bidx[b] into a fresh array the
// wrapper copied from the state's density (the pre-step state is never
// written) and the decision (0 keep, 1 Shepard, 2 solve; a parked slot
// keeps: 0).  Without ``bidx`` (moments mode) the kernel writes only the
// [B, K] moments; with it, the moments too when asked.
//
// Candidates: the f32 position [N, D], density [N] and motion limiter [N]
// as they are (an f64 state is cast to f32 by the wrapper first; a ghost
// point within an f32 rounding of a cell edge can then land in the
// neighbouring cell, and the particles it could lose sit at the edge of the
// support, where W and grad W vanish).  They may be a slab's halo-extended
// window with cell_start rebased to it; the ghost point, the particle's
// position and density are the slab's own rows (``bidx`` indexes them).
//
// What bounds it on the H100: the operation count.  In 3D a candidate costs
// 10 f32 operations to reject and an accepted pair 56 more; the inputs are
// 20 bytes per particle and 12 per ghost, the output 80 bytes per ghost
// (moments) or the density.  The function needs that work only for the
// grouped slots: a parked slot needs none, a dry one the test of its 3^D
// cells' fluid flags.  chip_smoke.py counts the candidates and pairs of the
// grouped slots, the ghost groups, the staged rows against the candidates
// they serve and the parked and dry slots, and prints the bound beside the
// time.
// What the design does about it: parked and dry slots cost no warp; a
// candidate row is read from device memory once per work entry instead of
// once per ghost, and a wall row costs one shared-memory load; a ghost no
// lane took a candidate for skips its reductions; the determinants run one a
// lane.  What it keeps paying: the 20 shuffle reductions of 5 steps per
// ghost (they fix the bits), the pair body on every lane iteration where any
// lane takes a row, and lanes idle on the last pass of a short row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sph_kernel_functions.cuh"

extern "C" {

struct MdbcParams {
    int nb;           // ghost slots
    int ncells;       // grid cells
    int cmin[3];
    int shape[3];
    int strides[3];
    float H2;         // support radius squared
    float H_inv;      // 1 / cell pitch
    float h_inv;
    float eta2;
    float alpha_d;
    float wendland_fac;  // alpha_d * 5 / (8 h^2)
    float m0;
    double rho0;           // the NaN scrub's density
    double det_threshold;  // |det A| below it: Shepard or keep
};

}  // extern "C"

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MDBC_WARPS = 8;              // warps per block of the moment kernel
constexpr int MDBC_THREADS = 32 * MDBC_WARPS;
constexpr int MDBC_CHUNK = 32;             // ghosts per work entry
constexpr int MDBC_STAGE_ROWS = 2048;      // stencil rows staged per entry
constexpr int MDBC_MIN_STAGE = 2;          // ghosts an entry needs to stage its rows
constexpr int GROUP_THREADS = 256;         // the grouping kernels' blocks

// scratch (ints): counters, then the per-cell count and first place, then
// the per-slot key, rank and sorted order, then the work entries
enum { CTR_ENTRIES, CTR_NEXT, CTR_SLOTS, CTR_PARKED, CTR_CELLS, CTR_DRY, CTR_COUNT = 8 };

struct Scratch {
    int* ctr;
    int* count;      // [ncells] ghosts per cell
    int* cell_off;   // [ncells] a cell's first place in ``order``
    int* wet;        // [ncells] whether the cell holds a fluid row
    int* key;        // [nb] the slot's cell, -1 when parked
    int* rank;       // [nb] its place in the cell
    int* order;      // [nb] slots sorted by cell
    int* entries;    // [3 nb] (cell, first place, ghosts)
};

__host__ __device__ inline Scratch carve(int* s, const MdbcParams& P) {
    Scratch c;
    c.ctr = s;
    c.count = s + CTR_COUNT;
    c.cell_off = c.count + P.ncells;
    c.wet = c.cell_off + P.ncells;
    c.key = c.wet + P.ncells;
    c.rank = c.key + P.nb;
    c.order = c.rank + P.nb;
    c.entries = c.order + P.nb;
    return c;
}

__host__ __device__ inline long long scratch_ints(const MdbcParams& P) {
    return CTR_COUNT + 3LL * P.ncells + 6LL * P.nb;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
    return v;
}

// exclusive prefix sum over the warp; ``total`` = the warp's sum
__device__ __forceinline__ int warp_exclusive_sum(int v, int lane, int& total) {
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL_MASK, inc, o);
        if (lane >= o) inc += t;
    }
    total = __shfl_sync(FULL_MASK, inc, 31);
    return inc - v;
}

// map_floor then the clamp into the grid: sign(x) * trunc(|x| * H_inv + 0.5),
// two roundings, relative to cmin
__device__ __forceinline__ int ghost_cell(const MdbcParams& P, float g, int d) {
    const float t = truncf(__fadd_rn(__fmul_rn(fabsf(g), P.H_inv), 0.5f));
    const int c = static_cast<int>(g < 0.0f ? -t : t);
    return min(max(c - P.cmin[d], 0), P.shape[d] - 1);
}

// A 4-byte copy from device to shared memory: cp.async where the target has
// it (sm_80 on), a plain copy elsewhere.
__device__ __forceinline__ void stage4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
#else
    *dst = *src;
#endif
}

__device__ __forceinline__ void stage_wait_all() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
    asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// each operation rounded on its own, as torch's elementwise kernels round it
template <class S> struct Rn;
template <> struct Rn<float> {
    static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
    static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
    static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
    static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
    static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
};
template <> struct Rn<double> {
    static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
    static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
    static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
    static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
    static __device__ __forceinline__ double abs(double a) { return ::fabs(a); }
};

// ops/mdbc.py::_det3: m00 (m11 m22 - m12 m21) - m01 (m10 m22 - m12 m20)
// + m02 (m10 m21 - m11 m20), left to right
template <class S>
__device__ __forceinline__ S det3(const S m[3][3]) {
    using R = Rn<S>;
    const S a = R::mul(m[0][0], R::sub(R::mul(m[1][1], m[2][2]), R::mul(m[1][2], m[2][1])));
    const S b = R::mul(m[0][1], R::sub(R::mul(m[1][0], m[2][2]), R::mul(m[1][2], m[2][0])));
    const S c = R::mul(m[0][2], R::sub(R::mul(m[1][0], m[2][1]), R::mul(m[1][1], m[2][0])));
    return R::add(R::sub(a, b), c);
}

// ops/mdbc.py::_det4: Laplace along the first row, minor k keeping the
// columns other than k in order; t0 - t1 + t2 - t3 left to right
template <class S>
__device__ __forceinline__ S det4(const S M[4][4]) {
    using R = Rn<S>;
    S t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        S m[3][3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
            for (int c = 0; c < 3; ++c) m[r][c] = M[1 + r][c < k ? c : c + 1];
        }
        t[k] = R::mul(M[0][k], det3<S>(m));
    }
    return R::sub(R::add(R::sub(t[0], t[1]), t[2]), t[3]);
}

template <int N, class S>
__device__ __forceinline__ S det_n(const S M[N][N]) {
    if constexpr (N == 3) return det3<S>(M);
    else return det4<S>(M);
}

// ops/mdbc.py::_mdbc_apply for one slot, called by the whole warp with the
// sums in every lane: the corrected density and the decision (0 keep, 1
// Shepard, 2 solve).  Lane k <= N computes determinant k - of A (k = 0) or
// of A with column k - 1 replaced by b (Cramer) - and its quotient by det A;
// the shuffles hand every lane all of them.
template <int D, class S>
__device__ __forceinline__ S correct(const MdbcParams& P, int lane, const float (&vb)[D + 1],
                                     const float (&vA)[D + 1][D + 1], const S (&diff)[D],
                                     S rho_old, int& decision) {
    using R = Rn<S>;
    constexpr int N = D + 1;
    const int k = lane <= N ? lane : 0;
    S M[N][N];
#pragma unroll
    for (int r = 0; r < N; ++r) {
#pragma unroll
        for (int c = 0; c < N; ++c)
            M[r][c] = static_cast<S>(c == k - 1 ? vb[r] : vA[r][c]);
    }
    const S dk = det_n<N, S>(M);
    const S det = __shfl_sync(FULL_MASK, dk, 0);
    const S qk = R::div(dk, det);                       // sol[k - 1]
    S sol[N];
#pragma unroll
    for (int i = 0; i < N; ++i) sol[i] = __shfl_sync(FULL_MASK, qk, i + 1);
    S grad = R::mul(sol[1], diff[0]);
#pragma unroll
    for (int d = 1; d < D; ++d) grad = R::add(grad, R::mul(sol[1 + d], diff[d]));
    const S rho_solve = R::add(sol[0], grad);
    const S a00 = static_cast<S>(vA[0][0]);
    const S rho_shepard = R::div(static_cast<S>(vb[0]), a00);
    const bool use_solve = R::abs(det) >= static_cast<S>(P.det_threshold);
    const bool use_shepard = !use_solve && a00 > S(0);
    S rho = use_solve ? rho_solve : (use_shepard ? rho_shepard : rho_old);
    if (isnan(rho)) rho = static_cast<S>(P.rho0);
    decision = use_solve ? 2 : (use_shepard ? 1 : 0);
    return rho;
}

// one candidate j of a ghost at g (x_j at ``xj``, its limiter at ``mlj``, its
// density at ``rhoj``, in shared or device memory): the fluid test, the
// density guard, V_j, W and grad W, and the K sums - the first kernel's
// arithmetic (the fluid test comes first: a wall row costs one load).
// Returns whether j was taken.
template <int D, int FAM>
__device__ __forceinline__ bool add_candidate(const MdbcParams& P, const float (&g)[D],
                                              const float* xj, const float* mlj,
                                              const float* rhoj, float (&sb)[D + 1],
                                              float (&sA)[D + 1][D + 1]) {
    constexpr int DP = D + 1;
    // fluid rows only (ml == 1 <=> FLUID), inclusive cutoff
    if (!(*mlj > 0.5f)) return false;
    float xv[D];
    float d2 = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        xv[d] = g[d] - xj[d];
        d2 += xv[d] * xv[d];
    }
    if (d2 > P.H2) return false;
    const float rho_j = *rhoj;
    const float vol = P.m0 / (rho_j > 0.0f ? rho_j : 1.0f);

    const float dist = sqrtf(d2);
    const float q = fminf(dist * P.h_inv, 2.0f);
    const float fac = grad_factor<FAM>(P, q, dist);
    float f[DP];
    f[0] = kernel_value<FAM>(P, q);
#pragma unroll
    for (int d = 0; d < D; ++d) f[1 + d] = fac * xv[d];
#pragma unroll
    for (int a = 0; a < DP; ++a) {
        sb[a] += f[a];
        const float fa = vol * f[a];
        sA[a][0] += fa;
#pragma unroll
        for (int d = 0; d < D; ++d) sA[a][1 + d] -= fa * xv[d];
    }
    return true;
}

// 1a - per grid cell, whether it holds a fluid row (ml > 0.5: the walk's
// fluid test)
__global__ void __launch_bounds__(GROUP_THREADS)
mdbc_wet_group_kernel(const MdbcParams P, const float* __restrict__ ml,
                      const int* __restrict__ cell_start, int* __restrict__ scratch) {
    const Scratch s = carve(scratch, P);
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= P.ncells) return;
    bool wet = false;
    for (int j = cell_start[c], je = cell_start[c + 1]; j < je && !wet; ++j) wet = ml[j] > 0.5f;
    s.wet[c] = wet;
}

// 1b - keys and ranks.  A parked slot, or a DRY one - no fluid row in the
// 3^D cells of its stencil, so the walk would take no candidate and every
// sum would be +0 - gets key -1 and its outputs here: zero moments, a keep
// decision, and for a dry slot the NaN scrub of its density.
template <int D, class S>
__global__ void __launch_bounds__(GROUP_THREADS)
mdbc_keys_group_kernel(const MdbcParams P, const S* __restrict__ ghost,
                       const int64_t* __restrict__ bidx, const unsigned char* __restrict__ gvalid,
                       const S* __restrict__ own_rho, S* __restrict__ out_rho,
                       int* __restrict__ scratch, signed char* __restrict__ decision,
                       float* __restrict__ moments) {
    constexpr int K = (D + 1) * (D + 2);
    const Scratch s = carve(scratch, P);
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in = b < P.nb;
    const bool parked = in && (!gvalid[b] || (bidx != nullptr && b > 0 && bidx[b] == 0));
    const int64_t row = (in && !parked) ? (bidx ? bidx[b] : b) : 0;
    int rel[D];
    bool wet = false;
    if (in && !parked) {
#pragma unroll
        for (int d = 0; d < D; ++d)
            rel[d] = ghost_cell(P, static_cast<float>(ghost[row * D + d]), d);
        const int x_lo = max(rel[0] - 1, 0), x_hi = min(rel[0] + 1, P.shape[0] - 1);
        constexpr int R2 = (D == 3) ? 1 : 0;
        for (int r2 = -R2; r2 <= R2 && !wet; ++r2) {
            for (int r1 = -1; r1 <= 1 && !wet; ++r1) {
                const int y = rel[1] + r1;
                const int z = (D == 3) ? rel[2] + r2 : 0;
                if (y < 0 || y >= P.shape[1] || (D == 3 && (z < 0 || z >= P.shape[2]))) continue;
                const int base = y * P.strides[1] + (D == 3 ? z * P.strides[2] : 0);
                for (int x = x_lo; x <= x_hi; ++x) wet |= s.wet[base + x] != 0;
            }
        }
    }
    const bool dry = in && !parked && !wet;
    const unsigned pb = __ballot_sync(FULL_MASK, parked);
    const unsigned db = __ballot_sync(FULL_MASK, dry);
    if ((threadIdx.x & 31) == 0) {
        if (pb) atomicAdd(s.ctr + CTR_PARKED, __popc(pb));
        if (db) atomicAdd(s.ctr + CTR_DRY, __popc(db));
    }
    if (!in) return;
    if (parked || dry) {
        s.key[b] = -1;
        if (decision) decision[b] = 0;
        if (dry && out_rho && isnan(own_rho[row])) out_rho[row] = static_cast<S>(P.rho0);
        if (moments) {
#pragma unroll
            for (int k = 0; k < K; ++k) moments[(size_t)b * K + k] = 0.0f;
        }
        return;
    }
    int key = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) key += rel[d] * P.strides[d];
    s.key[b] = key;
    s.rank[b] = atomicAdd(s.count + key, 1);
}

// 2 - per cell with ghosts: its first place in the order and its entries
__global__ void __launch_bounds__(GROUP_THREADS)
mdbc_cells_group_kernel(const MdbcParams P, int* __restrict__ scratch) {
    const Scratch s = carve(scratch, P);
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const int n = c < P.ncells ? s.count[c] : 0;
    const int chunks = (n + MDBC_CHUNK - 1) / MDBC_CHUNK;
    int n_tot, ch_tot;
    const int n_pre = warp_exclusive_sum(n, lane, n_tot);
    const int ch_pre = warp_exclusive_sum(chunks, lane, ch_tot);
    const int occupied = __popc(__ballot_sync(FULL_MASK, n > 0));
    int n_base = 0, ch_base = 0;
    if (lane == 0 && n_tot > 0) {
        n_base = atomicAdd(s.ctr + CTR_SLOTS, n_tot);
        ch_base = atomicAdd(s.ctr + CTR_ENTRIES, ch_tot);
        atomicAdd(s.ctr + CTR_CELLS, occupied);
    }
    n_base = __shfl_sync(FULL_MASK, n_base, 0);
    ch_base = __shfl_sync(FULL_MASK, ch_base, 0);
    if (n == 0) return;
    const int off = n_base + n_pre;
    s.cell_off[c] = off;
    for (int k = 0; k < chunks; ++k) {
        int* e = s.entries + 3 * (ch_base + ch_pre + k);
        e[0] = c;
        e[1] = off + k * MDBC_CHUNK;
        e[2] = min(MDBC_CHUNK, n - k * MDBC_CHUNK);
    }
}

// 3 - the counting sort's scatter
__global__ void __launch_bounds__(GROUP_THREADS)
mdbc_order_group_kernel(const MdbcParams P, int* __restrict__ scratch) {
    const Scratch s = carve(scratch, P);
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= P.nb) return;
    const int key = s.key[b];
    if (key >= 0) s.order[s.cell_off[key] + s.rank[b]] = b;
}

// 4 - the moments of the entries' ghosts, and the correction behind them
template <int D, int FAM, class S>
__global__ void __launch_bounds__(MDBC_THREADS)
mdbc_moments_kernel(const MdbcParams P, const S* __restrict__ ghost,
                    const int64_t* __restrict__ bidx, const float* __restrict__ pos,
                    const float* __restrict__ rho, const float* __restrict__ ml,
                    const int* __restrict__ cell_start, const S* __restrict__ own_pos,
                    const S* __restrict__ own_rho, S* __restrict__ out_rho,
                    signed char* __restrict__ decision, float* __restrict__ moments,
                    int* __restrict__ scratch) {
    constexpr int DP = D + 1;
    constexpr int K = DP * (D + 2);
    constexpr int NS = (D == 3) ? 9 : 3;         // stencil rows: z outer, y inner
    __shared__ float s_pos[MDBC_STAGE_ROWS * D];
    __shared__ float s_rho[MDBC_STAGE_ROWS];
    __shared__ float s_ml[MDBC_STAGE_ROWS];
    __shared__ int s_lo[NS], s_off[NS + 1];
    __shared__ int s_entry;
    const Scratch sc = carve(scratch, P);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_entries = sc.ctr[CTR_ENTRIES];

    while (true) {
        __syncthreads();                          // the last entry is done with the stage
        if (threadIdx.x == 0) s_entry = atomicAdd(sc.ctr + CTR_NEXT, 1);
        __syncthreads();
        const int e = s_entry;
        if (e >= n_entries) return;
        const int cell = sc.entries[3 * e];
        const int first = sc.entries[3 * e + 1];
        const int n = sc.entries[3 * e + 2];
        const int x = cell % P.shape[0];
        const int t = cell / P.shape[0];
        const int y = (D == 3) ? t % P.shape[1] : t;
        const int z = (D == 3) ? t / P.shape[1] : 0;
        if (threadIdx.x < NS) {                   // row s: [jb, je), empty off the grid
            const int sr = threadIdx.x;
            const int yy = y + (D == 3 ? sr % 3 : sr) - 1;
            const int zz = (D == 3) ? z + sr / 3 - 1 : 0;
            int jb = 0, je = 0;
            if (yy >= 0 && yy < P.shape[1] && (D == 2 || (zz >= 0 && zz < P.shape[2]))) {
                const int base = yy * P.strides[1] + (D == 3 ? zz * P.strides[2] : 0);
                jb = cell_start[base + max(x - 1, 0)];
                je = cell_start[base + min(x + 1, P.shape[0] - 1) + 1];
            }
            s_lo[sr] = jb;
            s_off[sr + 1] = je - jb;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            s_off[0] = 0;
            for (int sr = 0; sr < NS; ++sr) s_off[sr + 1] += s_off[sr];
        }
        __syncthreads();
        const int staged = n >= MDBC_MIN_STAGE ? min(s_off[NS], MDBC_STAGE_ROWS) : 0;
        for (int sr = 0; sr < NS; ++sr) {
            const int o = s_off[sr];
            const int len = min(s_off[sr + 1], staged) - o;
            const int lo = s_lo[sr];
            for (int q = threadIdx.x; q < len * D; q += MDBC_THREADS)
                stage4(s_pos + o * D + q, pos + (size_t)lo * D + q);
            for (int q = threadIdx.x; q < len; q += MDBC_THREADS) {
                stage4(s_rho + o + q, rho + lo + q);
                stage4(s_ml + o + q, ml + lo + q);
            }
        }
        stage_wait_all();
        __syncthreads();

        for (int k = warp; k < n; k += MDBC_WARPS) {
            const int b = sc.order[first + k];
            const int64_t row = bidx ? bidx[b] : b;
            float g[D];
#pragma unroll
            for (int d = 0; d < D; ++d) g[d] = static_cast<float>(ghost[row * D + d]);

            float sb[DP];       // sum [W, grad W]
            float sA[DP][DP];   // sum [V W, V grad W] (x) [1, -x_gj]
#pragma unroll
            for (int a = 0; a < DP; ++a) {
                sb[a] = 0.0f;
#pragma unroll
                for (int c = 0; c < DP; ++c) sA[a][c] = 0.0f;
            }
            bool taken = false;
            for (int sr = 0; sr < NS; ++sr) {
                const int o = s_off[sr];
                const int len = s_off[sr + 1] - o;
                const int lo = s_lo[sr];
                // the row's staged part, then the rest from device memory:
                // the lane's candidates j = lo + lane, lo + lane + 32, ... in order
                const int n_staged = min(max(staged - o, 0), len);
                int q = lane;
                for (; q < n_staged; q += 32)
                    taken |= add_candidate<D, FAM>(P, g, s_pos + (o + q) * D, s_ml + o + q,
                                                   s_rho + o + q, sb, sA);
                for (; q < len; q += 32)
                    taken |= add_candidate<D, FAM>(P, g, pos + (size_t)(lo + q) * D, ml + lo + q,
                                                   rho + lo + q, sb, sA);
            }
            float* mo = moments ? moments + (size_t)b * K : nullptr;
            if (!__any_sync(FULL_MASK, taken)) {
                // no lane took a candidate: every sum is +0, the solve keeps
                // the density (the NaN scrub aside) - the full path's bits
                if (mo && lane < K) mo[lane] = 0.0f;
                if (out_rho != nullptr && lane == 0) {
                    if (isnan(own_rho[row])) out_rho[row] = static_cast<S>(P.rho0);
                    decision[b] = 0;
                }
                continue;
            }

            // every lane gets every sum; lane k writes moment k: b first, then A row-major
            float vb[DP];
            float vA[DP][DP];
#pragma unroll
            for (int a = 0; a < DP; ++a) {
                vb[a] = P.m0 * warp_sum(sb[a]);
                if (mo && lane == a) mo[a] = vb[a];
            }
#pragma unroll
            for (int a = 0; a < DP; ++a) {
#pragma unroll
                for (int c = 0; c < DP; ++c) {
                    vA[a][c] = warp_sum(sA[a][c]);
                    if (mo && lane == DP + a * DP + c) mo[DP + a * DP + c] = vA[a][c];
                }
            }
            if (out_rho != nullptr) {
                S diff[D];
#pragma unroll
                for (int d = 0; d < D; ++d)
                    diff[d] = Rn<S>::sub(own_pos[row * D + d], ghost[row * D + d]);
                int dec;
                const S r = correct<D, S>(P, lane, vb, vA, diff, own_rho[row], dec);
                if (lane == 0) {
                    out_rho[row] = r;
                    decision[b] = static_cast<signed char>(dec);
                }
            }
        }
    }
}

struct Args {
    const void* ghost;
    const int64_t* bidx;
    const unsigned char* gvalid;
    const float* pos;
    const float* rho;
    const float* ml;
    const int* cell_start;
    const void* own_pos;
    const void* own_rho;
    void* out_rho;
    signed char* decision;
    float* moments;
    int* scratch;
};

template <int D, int FAM, class S>
cudaError_t launch(const MdbcParams& P, const Args& a, cudaStream_t stream) {
    auto kernel = mdbc_moments_kernel<D, FAM, S>;
    // persistent blocks: as many as fit on the card at once (looked up once
    // per instance), never more than there are slots
    static int resident = 0;
    if (resident == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MDBC_THREADS, 0);
        if (err != cudaSuccess) return err;
        resident = max(1, sms * per_sm);
    }
    const S* ghost = static_cast<const S*>(a.ghost);
    cudaError_t err = cudaMemsetAsync(a.scratch, 0, (CTR_COUNT + (size_t)P.ncells) * sizeof(int),
                                      stream);
    if (err != cudaSuccess) return err;
    const int slot_blocks = (P.nb + GROUP_THREADS - 1) / GROUP_THREADS;
    const int cell_blocks = (P.ncells + GROUP_THREADS - 1) / GROUP_THREADS;
    mdbc_wet_group_kernel<<<cell_blocks, GROUP_THREADS, 0, stream>>>(P, a.ml, a.cell_start,
                                                                     a.scratch);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    mdbc_keys_group_kernel<D, S><<<slot_blocks, GROUP_THREADS, 0, stream>>>(
        P, ghost, a.bidx, a.gvalid, static_cast<const S*>(a.own_rho),
        static_cast<S*>(a.out_rho), a.scratch, a.decision, a.moments);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    mdbc_cells_group_kernel<<<cell_blocks, GROUP_THREADS, 0, stream>>>(P, a.scratch);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    mdbc_order_group_kernel<<<slot_blocks, GROUP_THREADS, 0, stream>>>(P, a.scratch);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int blocks = min(resident, P.nb);
    kernel<<<blocks, MDBC_THREADS, 0, stream>>>(
        P, ghost, a.bidx, a.pos, a.rho, a.ml, a.cell_start, static_cast<const S*>(a.own_pos),
        static_cast<const S*>(a.own_rho), static_cast<S*>(a.out_rho), a.decision, a.moments,
        a.scratch);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// variant = f64 << 2 | dims3 << 1 | cubic; ``ghost`` (and in fused mode
// ``own_pos``, ``own_rho``, ``out_rho``) hold the state's dtype, the
// candidate arrays f32.  Moments mode: ``bidx`` null, ``ghost`` [nb, D] in
// slot order, ``moments`` [nb, K]; fused mode: ``bidx`` [nb] indexes the own
// rows of ``ghost``, ``own_pos``, ``own_rho`` and ``out_rho``, ``decision``
// [nb], ``moments`` null or [nb, K].  ``scratch`` is device memory of
// sph_mdbc_scratch_ints(params) ints.  Returns 0, a cudaError_t code, or -1
// for an unknown variant or a missing array.
int sph_mdbc_moments(const MdbcParams* params, int variant, const void* ghost,
                     const int64_t* bidx, const unsigned char* gvalid, const float* pos,
                     const float* rho, const float* ml, const int* cell_start,
                     const void* own_pos, const void* own_rho, void* out_rho,
                     signed char* decision, float* moments, int* scratch, void* stream) {
    const MdbcParams P = *params;
    if (P.nb <= 0) return 0;
    if (bidx ? !(own_pos && own_rho && out_rho && decision) : !moments) return -1;
    const Args a{ghost, bidx, gvalid, pos, rho, ml, cell_start, own_pos, own_rho, out_rho,
                 decision, moments, scratch};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (variant) {
        case 0: return static_cast<int>(launch<2, WENDLAND, float>(P, a, st));
        case 1: return static_cast<int>(launch<2, CUBIC, float>(P, a, st));
        case 2: return static_cast<int>(launch<3, WENDLAND, float>(P, a, st));
        case 3: return static_cast<int>(launch<3, CUBIC, float>(P, a, st));
        case 4: return static_cast<int>(launch<2, WENDLAND, double>(P, a, st));
        case 5: return static_cast<int>(launch<2, CUBIC, double>(P, a, st));
        case 6: return static_cast<int>(launch<3, WENDLAND, double>(P, a, st));
        case 7: return static_cast<int>(launch<3, CUBIC, double>(P, a, st));
        default: return -1;
    }
}

long long sph_mdbc_scratch_ints(const MdbcParams* params) { return scratch_ints(*params); }

const char* sph_mdbc_error_string(int code) {
    if (code == -1) return "unknown mDBC variant or a missing array";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
