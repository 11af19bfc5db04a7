// Cell-centric neighbor sweep of the weakly-compressible SPH step, every
// model and mode, for NVIDIA Hopper (sm_90a).  Built by ops/_build.py with
// nvcc into a shared library with a plain C interface and bound with ctypes
// (ops/cell_sweep.py).
//
// Replaces: sphexample_tpu/ops/pallas_sweep.py::_make_kernel (the TPU
// cell-pair sweep, pair physics from ::_pair_math, outputs gathered back by
// ::_gather_back).  It computes WHAT that kernel computes - per cell-sorted
// self row the K = (1+D)(1 + STORE + PLANAR) sums drho, dv/dt, then W,
// grad W, then grad C, div r over the 3^(D-1) stencil rows of the self's
// (stale, last-rebuild) cell - and keeps its one idea: the candidates of a
// cell are staged once in fast memory and shared by every self of the cell.
// What does not come across: the x-parity cell pairing with two predicated
// halves, the mpc / cseg / maxc capacities and their overflow telemetry,
// 128-aligned windows with lane validity masks, the sublane roll, the
// twice-packed fields, scalar prefetch, the [maxp, K_pad, R2] output block
// and the gather back to sorted order.
//
// Design (first, simple version): one thread block per grid cell; a block
// whose cell is empty returns at once, so no list of occupied cells is kept
// and the step gains no host sync.  The block's cell coordinates follow from
// blockIdx (x fastest), its selves are the sorted rows [cs, ce) of
// cell_start.  Selves are taken blockDim at a time (a cell of any occupancy
// works), one thread per self.  For each stencil row the candidate range
// [cell_start[key_lo], cell_start[key_hi + 1]) is computed exactly as
// ops/cell_list.py::row_segments does (x clamped to the grid edge, rows
// outside the grid empty) and brought tile by tile (TILE packed rows,
// coalesced float4 loads) into shared memory; after a barrier every thread
// walks the tile for its own self - all threads read the same shared row, a
// broadcast - and sums in f32 registers.  Each thread writes its K sums to
// row i of the [N, K] output: a self's sorted index is its row, so there are
// no atomics and no gather back.  Rows that no block owns (inactive padding,
// parked past the last cell) are never written: the wrapper zero-fills the
// output and masks with ``active``.
//
// The self window (the sharded path; replaces
// sphexample_tpu/ops/pallas_sweep.py::pallas_pair_sweep_sharded, the same TPU
// kernel on halo-extended arrays): the pack may hold more rows than there
// are selves.  Selves are the pack rows [self_off, self_off + n) - a slab of
// the global sorted order between its two halos, or inside the whole gathered
// array - and cell_start arrives rebased to the pack's rows and clamped to
// them.  A block takes the part of its cell's rows that lies in the self
// range and returns when there is none (on P slabs about (P-1)/P of the
// blocks of a launch); a cell that straddles a slab edge is swept by both
// slabs, each writing its own rows.  The role rule and the own-cell test use
// the cell's whole range [cs, ce).  Tiles start at the stencil row's first
// candidate whatever the self range, so a slab's rows come out bit for bit
// as the single-device launch gives them.  Single device: self_off = 0.
//
// Pair math: csrc/sph_pair_math.cuh::add_pair, shared with the block sweep
// as the TPU kernels share ::_pair_math.  Self excluded by index, support
// cutoff d2 <= H2 on the unfused d2 of pair_distance2, the density-diffusion
// role cell-centric: same_cell = cs <= j < ce of the block's own cell,
// role_i = same_cell ? i < j : i > j.  Summation order differs from the
// plain version: agreement to f32 rounding, not bit for bit.
//
// Instances: templates on what changes the registers a thread holds - dims
// (2, 3), the sub-particle-scale stress (LAMINAR_SPS), STORE and PLANAR
// (16 instances).  Kernel family, the other viscosities and the density
// diffusion are grid-uniform run-time branches on CellSweepParams.
//
// What bounds it on the H100: the operation count, as for the block sweep -
// a candidate costs about 9 f32 operations to reject and an accepted pair
// about 45 more (ARTIFICIAL + LINEAR), while the inputs are ~50 bytes a
// particle.  chip_smoke.py counts the candidates and pairs of its inputs and
// prints the bound beside the measured time: on the 2,215,035-particle 3D dam
// break 3.63e10 operations over 67 TFLOP/s = 0.542 ms against 10.4-10.5 ms
// per launch (the block sweep on the same state: 5.9 ms), measured on an
// NVIDIA H100 80GB HBM3 at a 700 W power limit.  What the design does about
// it: candidate rows are read from device memory once per (cell, stencil
// row) instead of once per self, coalesced; every thread of a block has the
// same trip count.  What it leaves on the table: threads past a cell's
// occupancy idle through the walk (the occupied cells of that dam break hold
// 31 selves on average for 64 threads, a 2D moving-square cell 4 for 32: this
// is why the block sweep, with its lanes full, is faster), loads are not overlapped
// with the walk (no cp.async / TMA ring), warps diverge at the cutoff.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sph_pair_math.cuh"

extern "C" {

struct CellSweepParams {
    int n;            // self rows
    int self_off;     // pack row of self row 0 (0 on a single device)
    int ncells;
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

constexpr int TILE = 128;   // candidate rows staged per barrier

template <int D, bool SPS, bool STORE, bool SHIFT>
__global__ void __launch_bounds__((D == 3) ? 64 : 32)
cell_sweep_kernel(const CellSweepParams P,
                  const float4* __restrict__ pack,
                  const int* __restrict__ cell_start,
                  float* __restrict__ out) {
    constexpr int NV = (D == 3) ? 3 : 2;               // float4s per packed row
    constexpr int K = n_sums<D, STORE, SHIFT>();
    __shared__ float4 tile[TILE * NV];

    const int c = blockIdx.x;
    const int cs = cell_start[c];
    const int ce = cell_start[c + 1];
    const int lo = max(cs, P.self_off);                 // the cell's selves
    const int hi = min(ce, P.self_off + P.n);
    if (lo >= hi) return;                               // empty, or another slab's

    int rel[3];
    rel[0] = c % P.shape[0];
    const int t = c / P.shape[0];
    rel[1] = (D == 3) ? t % P.shape[1] : t;
    rel[2] = (D == 3) ? t / P.shape[1] : 0;
    const int x_lo = max(rel[0] - 1, 0);
    const int x_hi = min(rel[0] + 1, P.shape[0] - 1);

    for (int base = lo; base < hi; base += blockDim.x) {
        const int i = base + threadIdx.x;
        const bool has = i < hi;
        const Row s = load_row<D>(pack, has ? i : lo);
        float acc[K];
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = 0.0f;

        constexpr int R2 = (D == 3) ? 1 : 0;
        for (int r2 = -R2; r2 <= R2; ++r2) {
            for (int r1 = -1; r1 <= 1; ++r1) {
                const int y = rel[1] + r1;
                if (y < 0 || y >= P.shape[1]) continue;
                int row = y * P.strides[1];
                if constexpr (D == 3) {
                    const int z = rel[2] + r2;
                    if (z < 0 || z >= P.shape[2]) continue;
                    row += z * P.strides[2];
                }
                const int jb = cell_start[row + x_lo];
                const int je = cell_start[row + x_hi + 1];
                for (int t0 = jb; t0 < je; t0 += TILE) {
                    const int nt = min(TILE, je - t0);
                    __syncthreads();                    // the last tile is consumed
                    const float4* src = pack + (size_t)t0 * NV;
                    for (int k = threadIdx.x; k < nt * NV; k += blockDim.x) tile[k] = src[k];
                    __syncthreads();
                    if (!has) continue;
                    for (int jj = 0; jj < nt; ++jj) {
                        const int j = t0 + jj;
                        const Row n = load_row<D>(tile, jj);
                        float xij[D];
                        const float d2 = pair_distance2<D>(s, n, xij);
                        if (d2 > P.H2 || j == i) continue;
                        const bool same_cell = (j >= cs) && (j < ce);
                        add_pair<D, SPS, STORE, SHIFT, AT_RUN_TIME, AT_RUN_TIME, AT_RUN_TIME>(
                            P, s, n, xij, d2, same_cell ? (i < j) : (i > j), acc);
                    }
                }
            }
        }
        if (has) {
            float* o = out + (size_t)(i - P.self_off) * K;
#pragma unroll
            for (int k = 0; k < K; ++k) o[k] = acc[k];
        }
    }
}

template <int D, bool SPS, bool STORE, bool SHIFT>
cudaError_t launch(const CellSweepParams& P, const float* pack, const int* cell_start,
                   float* out, cudaStream_t stream) {
    const int threads = (D == 3) ? 64 : 32;
    cell_sweep_kernel<D, SPS, STORE, SHIFT><<<P.ncells, threads, 0, stream>>>(
        P, reinterpret_cast<const float4*>(pack), cell_start, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// variant = dims3 << 3 | sps << 2 | store << 1 | shift.
// Returns 0, a cudaError_t code, or -1 for an unknown variant or mode.
int sph_cell_sweep(const CellSweepParams* params, int variant, const float* pack,
                   const int* cell_start, float* out, void* stream) {
    const CellSweepParams P = *params;
    if (P.n <= 0 || P.ncells <= 0) return 0;
    if (P.family < WENDLAND || P.family > CUBIC || P.viscosity < VISC_ZERO
        || P.viscosity > VISC_LAMINAR_SPS || P.diffusion < DIFF_ZERO
        || P.diffusion > DIFF_COMPLEX)
        return -1;
    if (((variant >> 2) & 1) != (P.viscosity == VISC_LAMINAR_SPS)) return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPH_CASE(V, D, SPS, STORE, SHIFT) \
    case V: return static_cast<int>(launch<D, SPS, STORE, SHIFT>(P, pack, cell_start, out, st));
    switch (variant) {
        SPH_CASE(0, 2, false, false, false)
        SPH_CASE(1, 2, false, false, true)
        SPH_CASE(2, 2, false, true, false)
        SPH_CASE(3, 2, false, true, true)
        SPH_CASE(4, 2, true, false, false)
        SPH_CASE(5, 2, true, false, true)
        SPH_CASE(6, 2, true, true, false)
        SPH_CASE(7, 2, true, true, true)
        SPH_CASE(8, 3, false, false, false)
        SPH_CASE(9, 3, false, false, true)
        SPH_CASE(10, 3, false, true, false)
        SPH_CASE(11, 3, false, true, true)
        SPH_CASE(12, 3, true, false, false)
        SPH_CASE(13, 3, true, false, true)
        SPH_CASE(14, 3, true, true, false)
        SPH_CASE(15, 3, true, true, true)
        default: return -1;
    }
#undef SPH_CASE
}

const char* sph_cell_sweep_error_string(int code) {
    if (code == -1) return "unknown cell-sweep variant or mode";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
