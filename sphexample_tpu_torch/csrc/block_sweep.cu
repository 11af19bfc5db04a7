// Neighbor sweep of the weakly-compressible SPH step, for NVIDIA Hopper
// (sm_90a).  Built by ops/_build.py with nvcc into a shared library with a
// plain C interface and bound with ctypes (ops/block_sweep.py).
//
// Replaces: sphexample_tpu/ops/pallas_block_sweep.py::_make_block_kernel
// (the TPU block sweep, pair physics from ops/pallas_sweep.py::_pair_math).
// It computes WHAT that kernel computes, not its TPU structure: no 128-lane
// self blocks, no VMEM DMA ring, no chunk table with its 2^21-row word
// encoding, no f32-packed indices.  Indices stay int32; cell_start, the
// stale cell coordinates of the last rebuild and the sorted order are the
// whole contract.
//
// Design (the first version walked one thread per self): one warp
// per 32 consecutive sorted self rows [32w, 32w + 32) - the counterpart of
// the TPU kernel's block of consecutive sorted rows - swept through the
// shared stage -> filter -> compute walk of csrc/sph_sweep_walk.cuh.  The
// warp splits its rows into subgroups by the values its stencil rows come
// from, the unclamped cell coordinates rel[1 .. D-1] of the stale cell of
// the last rebuild: a ballot on the key of the lowest pending lane, one
// subgroup per pass, no table and no extra launch.  In 3D, 32 consecutive
// rows of a ~41-particle cell nearly always form one subgroup; in the 2D
// moving square (about 4 selves a cell) the 32 rows span about 8 cells of one
// row, and the union of candidates is about 10 cells per stencil row against
// 3 of one self.  The x span is not capped: a pass costs the filter over the
// union plus the compute of its tiles, so splitting the 32 rows in two passes
// would pay the compute's rounds twice to save part of a cheaper filter (a
// capped variant was not measured).  For each stencil row the candidate
// range of a self is [cell_start[key_lo], cell_start[key_hi + 1]) exactly as
// ops/cell_list.py::row_segments computes it (x-range clamped to the grid
// edge, rows outside the grid empty); each self accumulates its K =
// (1+D)(1 + STORE + PLANAR) sums in f32 registers: drho, dv/dt, then W,
// grad W, then grad C, div r (the cell sweep's column order).  One output row
// per self, in sorted order; an inactive row's is zero.  Each pair is
// computed from both endpoints: no atomics.
// Self is excluded (j != i), the support cutoff is d2 <= H2, and the
// density-diffusion role is cell-centric: for a pair in the self's own cell
// [s_i, e_i) the i role goes to the lower sorted index, across cells to the
// particle in the later cell (the higher sorted index) - equivalently
// role_i = (cs_i > cs_j) || (cs_i == cs_j && i < j) on own-cell starts.
//
// Fields: the wrapper packs per row, in f32, position, velocity, the
// GUARDED density (padding rows carry 1, never 0) with its reciprocal,
// pressure and motion limiter (pack_fields in ops/block_sweep.py).  The pair
// math is csrc/sph_pair_math.cuh (pair_terms, fold_terms), shared with the
// cell sweep as the TPU kernels share ::_pair_math; d2 is summed unfused
// there, so that in 2D the cutoff is the plain version's bit for bit (the
// MovingSquare deck's k = sqrt 2 cuts W where it is not yet zero).  A self's
// candidates are visited in the order of the first version (stencil rows z,
// y; j ascending) and folded in that order on either path of the walk's
// compute, so its sums are the cell sweep's bit for bit.  Summation order
// differs from the plain version, so results agree with it to f32 rounding,
// not bit for bit.
//
// The self window (the sharded path; replaces
// sphexample_tpu/ops/pallas_block_sweep.py::pallas_block_sweep_sharded, the
// same TPU kernel on a halo-extended pack): the pack may hold more rows than
// there are selves.  Selves are the pack rows [self_off, self_off + n) - a
// slab of the global sorted order between its left and right halo rows, or
// inside the whole gathered array; ``cell`` and ``active`` hold the n self
// rows only, the output is [n, K], and cell_start arrives rebased to the
// pack's rows and clamped to them.  A rigid shift keeps the order of two
// sorted indices, so the role rule compares pack rows and no global index
// rides the exchange (the TPU kernel packs it as f32, whence its 2^24-row
// bound); the per-self candidate order is that of the single-device launch,
// so a slab's rows come out bit for bit as that launch gives them.  A stencil
// that reaches past the halo is cut by the clamp without a sign: the step's
// max_halo telemetry guards that.  Single device: self_off = 0.
//
// Instances (32): the main path's models pinned by template - dims (2, 3),
// kernel family (Wendland C2, cubic spline), viscosity (ZERO, ARTIFICIAL),
// density diffusion (ZERO, LINEAR), no kernel output, no shifting: variants
// 0-15 - and every other model set templated as the cell sweep is, on dims,
// LAMINAR_SPS, STORE and PLANAR, with the kernel family, the other
// viscosities and the density diffusion as grid-uniform run-time branches on
// SweepParams: variants 16-31.
//
// What bounds it on the H100: the operation count.  A candidate costs about
// 10 f32 operations to reject (difference, squared distance, compare) and an
// accepted pair about 60 more; the inputs are ~80 bytes per particle (a few
// microseconds of HBM time at 160k particles), so the bound is operations
// over the 67 TFLOP/s f32 rate.  chip_smoke.py counts the candidates and
// pairs of its inputs and prints the bound beside the measured time.  What
// the design does about it: the first version's warp ran the pair body on
// every candidate that any of its lanes accepted - about three in four on the
// main deck, where one in six is needed - and walked ragged per-thread
// ranges; the shared walk runs the cheap filter on full lanes over staged
// tiles and the body only over accepted pairs (0.440 against 0.466 ms on the
// main deck, 0.221 against 0.36 ms on its quarter slab, 0.71 against 0.63 ms
// on the mDBC deck; H100 80GB HBM3, 700 W).  A lane's pairs gather in the
// stencil rows next to its position in the cell, so the busiest lane of a
// tile holds ~2.8 times the mean on the 3D dam breaks; the walk's compute
// hands the pairs past about ceil(pairs / 32) rounds to the lanes with spare
// rounds (csrc/sph_sweep_walk.cuh), each self folding its pairs in its own
// order: the warp pays ~122 pair bodies a pass on the benchmark's dam break
// state where it paid ~320 (ops/block_sweep.py:pass_bodies), and B1 alone
// takes 0.386-0.390 against 0.438-0.450 ms there, 0.0806-0.0817 against
// 0.0834-0.0837 ms on the 2D moving square at t = 0 (walk_variants.py, the
// per-lane walk before it in the same turns).  What it leaves: the filter, which tests every
// row of the union for every lane (~1,000 candidates a pass for ~120 pairs;
// ~0.29 of the 0.39 ms do not shrink with the bodies), and the walk's shared
// memory (45.5 KB a block in 3D: 5 blocks an SM, where the per-lane walk's
// 24 KB of tiles let 7 fit; that walk's pair loop put in this one runs 0.507
// against its own 0.438 ms on the main deck at t = 0).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sph_pair_math.cuh"
#include "sph_sweep_walk.cuh"

extern "C" {

struct SweepParams {
    int n;            // self rows
    int self_off;     // pack row of self row 0 (0 on a single device)
    int cmin[3];
    int shape[3];
    int strides[3];
    int family;       // WENDLAND / CUBIC
    int viscosity;    // VISC_*
    int diffusion;    // DIFF_*
    float H2;         // support radius squared
    float h;
    float h_inv;
    float eta2;
    float alpha_d;
    float wendland_fac;  // alpha_d * 5 / (8 h^2)
    float m0;
    float alpha_c0;      // alpha * c0 (artificial viscosity)
    float diff_fac;      // delta_sph * h * c0 (density diffusion)
    float C_lin;         // linear hydrostatic constant
    float rho0;
    float rho0_g;        // rho0 * g: P_h = rho0_g * x_ij[last]
    float Cb_inv;
    float lam_fac;       // 4 m0 nu0 (laminar viscosity)
    float cs2_dx2;       // (smagorinsky_constant dx)^2
    float blin_dx2;      // blin_constant dx^2
    float cubic_eps;
    float w_dx_inv;      // 1 / W(dx), cubic tensile correction
};

}  // extern "C"

namespace {

template <int D, int FAM, int VISC, int DIFF, bool SPS, bool STORE, bool SHIFT>
__global__ void __launch_bounds__(WALK_THREADS)
block_sweep_kernel(const SweepParams P,
                   const float4* __restrict__ pack,
                   const int* __restrict__ cell,
                   const int* __restrict__ cell_start,
                   const unsigned char* __restrict__ active,
                   float* __restrict__ out) {
    constexpr int K = n_sums<D, STORE, SHIFT>();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    WalkShared<D, K>& walk = walk_shared<D, K>(warp);
    const int w0 = blockIdx.x * WALK_THREADS + warp * 32;  // the warp's first self row
    if (w0 >= P.n) return;                                 // the whole warp
    const int r = w0 + lane;                               // self row
    const bool in = r < P.n;
    const bool live = in && active[r];
    const int i = P.self_off + r;                          // its pack row

    int rel[D];
    int key = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        rel[d] = in ? cell[(size_t)r * D + d] - P.cmin[d] : 0;
        const int rc = min(max(rel[d], 0), P.shape[d] - 1);
        key += rc * P.strides[d];
    }
    WalkLane L;
    L.i = i;
    L.s_i = live ? cell_start[key] : 0;
    L.e_i = live ? cell_start[key + 1] : 0;
    L.xl = min(max(rel[0] - 1, 0), P.shape[0] - 1);
    L.xh = min(max(rel[0] + 1, 0), P.shape[0] - 1);
    const Row s = load_row<D>(pack, live ? i : P.self_off + w0);
    walk_stage_self<D, K>(walk, s, L);

    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;
    // subgroups by stencil rows: the lowest pending lane's cell row, and
    // every pending lane in the same row, one pass each
    unsigned pending = __ballot_sync(FULL_MASK, live);
    while (pending) {
        const int leader = __ffs(pending) - 1;
        // (y, z) in 3D; in 2D rel[D - 1] is y again and rz goes unused
        const int ry = __shfl_sync(FULL_MASK, rel[1], leader);
        const int rz = __shfl_sync(FULL_MASK, rel[D - 1], leader);
        L.member = ((pending >> lane) & 1u) && rel[1] == ry && rel[D - 1] == rz;
        pending &= ~__ballot_sync(FULL_MASK, L.member);
        walk_pass<D, SPS, STORE, SHIFT, FAM, VISC, DIFF>(P, pack, cell_start, walk,
                                                        ry, rz, L, s, acc);
    }
    if (in) {
        float* o = out + (size_t)r * K;
#pragma unroll
        for (int k = 0; k < K; ++k) o[k] = acc[k];
    }
}

template <int D, int FAM, int VISC, int DIFF, bool SPS, bool STORE, bool SHIFT>
cudaError_t launch(const SweepParams& P, const float* pack, const int* cell,
                   const int* cell_start, const unsigned char* active,
                   float* out, cudaStream_t stream) {
    const int blocks = (P.n + WALK_THREADS - 1) / WALK_THREADS;
    constexpr int smem = walk_shared_bytes<D, n_sums<D, STORE, SHIFT>()>();
    block_sweep_kernel<D, FAM, VISC, DIFF, SPS, STORE, SHIFT><<<blocks, WALK_THREADS, smem,
                                                                stream>>>(
        P, reinterpret_cast<const float4*>(pack), cell, cell_start, active, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// variant 0-15 = dims3 << 3 | cubic << 2 | artificial << 1 | linear (no
// kernel output, no shifting; the params must name the same models);
// variant 16-31 = 16 | dims3 << 3 | sps << 2 | store << 1 | shift.
// Returns 0, a cudaError_t code, or -1 for an unknown variant or mode.
int sph_block_sweep(const SweepParams* params, int variant, const float* pack,
                    const int* cell, const int* cell_start,
                    const unsigned char* active, float* out, void* stream) {
    const SweepParams P = *params;
    if (P.n <= 0) return 0;
    if (P.family < WENDLAND || P.family > CUBIC || P.viscosity < VISC_ZERO
        || P.viscosity > VISC_LAMINAR_SPS || P.diffusion < DIFF_ZERO
        || P.diffusion > DIFF_COMPLEX)
        return -1;
    if (variant >= 0 && variant < 16
        && (P.family != ((variant >> 2) & 1)
            || P.viscosity != (((variant >> 1) & 1) ? VISC_ARTIFICIAL : VISC_ZERO)
            || P.diffusion != ((variant & 1) ? DIFF_LINEAR : DIFF_ZERO)))
        return -1;
    if (variant >= 16 && ((variant >> 2) & 1) != (P.viscosity == VISC_LAMINAR_SPS))
        return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    constexpr int W = WENDLAND, C = CUBIC, V0 = VISC_ZERO, VA = VISC_ARTIFICIAL;
    constexpr int D0 = DIFF_ZERO, DL = DIFF_LINEAR, RT = AT_RUN_TIME;
#define SPH_CASE(V, D, F, VI, DI, SPS, STORE, SHIFT) \
    case V: return static_cast<int>(launch<D, F, VI, DI, SPS, STORE, SHIFT>( \
        P, pack, cell, cell_start, active, out, st));
    switch (variant) {
        SPH_CASE(0, 2, W, V0, D0, false, false, false)
        SPH_CASE(1, 2, W, V0, DL, false, false, false)
        SPH_CASE(2, 2, W, VA, D0, false, false, false)
        SPH_CASE(3, 2, W, VA, DL, false, false, false)
        SPH_CASE(4, 2, C, V0, D0, false, false, false)
        SPH_CASE(5, 2, C, V0, DL, false, false, false)
        SPH_CASE(6, 2, C, VA, D0, false, false, false)
        SPH_CASE(7, 2, C, VA, DL, false, false, false)
        SPH_CASE(8, 3, W, V0, D0, false, false, false)
        SPH_CASE(9, 3, W, V0, DL, false, false, false)
        SPH_CASE(10, 3, W, VA, D0, false, false, false)
        SPH_CASE(11, 3, W, VA, DL, false, false, false)
        SPH_CASE(12, 3, C, V0, D0, false, false, false)
        SPH_CASE(13, 3, C, V0, DL, false, false, false)
        SPH_CASE(14, 3, C, VA, D0, false, false, false)
        SPH_CASE(15, 3, C, VA, DL, false, false, false)
        SPH_CASE(16, 2, RT, RT, RT, false, false, false)
        SPH_CASE(17, 2, RT, RT, RT, false, false, true)
        SPH_CASE(18, 2, RT, RT, RT, false, true, false)
        SPH_CASE(19, 2, RT, RT, RT, false, true, true)
        SPH_CASE(20, 2, RT, RT, RT, true, false, false)
        SPH_CASE(21, 2, RT, RT, RT, true, false, true)
        SPH_CASE(22, 2, RT, RT, RT, true, true, false)
        SPH_CASE(23, 2, RT, RT, RT, true, true, true)
        SPH_CASE(24, 3, RT, RT, RT, false, false, false)
        SPH_CASE(25, 3, RT, RT, RT, false, false, true)
        SPH_CASE(26, 3, RT, RT, RT, false, true, false)
        SPH_CASE(27, 3, RT, RT, RT, false, true, true)
        SPH_CASE(28, 3, RT, RT, RT, true, false, false)
        SPH_CASE(29, 3, RT, RT, RT, true, false, true)
        SPH_CASE(30, 3, RT, RT, RT, true, true, false)
        SPH_CASE(31, 3, RT, RT, RT, true, true, true)
        default: return -1;
    }
#undef SPH_CASE
}

const char* sph_error_string(int code) {
    if (code == -1) return "unknown sweep variant or mode";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
