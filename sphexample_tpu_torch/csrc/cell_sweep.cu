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
// Design (the first version ran one thread block per grid cell, most
// of them empty, with block-wide barriers around every tile): the kernel
// runs over OCCUPIED cells only, the counterpart of the TPU kernel's
// occupied-cell programs, and pairs x-adjacent cells as that kernel does: a
// group is the cells (2q, 2q + 1) of one x row (the last one alone when the
// row has an odd length), whose selves are one contiguous run of sorted rows
// with one set of stencil rows.  On the 2,215,035-row dam break a full cell
// holds 36-64 selves: one cell a group fills 63 % of the lanes of its warp
// passes, a pair 85 % (ops/cell_sweep.py:cell_schedule, schedule_stats).
//
//   1. occupied_groups_kernel lists, in device memory, the groups with self
//      rows in [self_off, self_off + n) - a flag per group, a ballot and a
//      prefix within each block, one atomicAdd per block - and counts them.
//      Launched by the same C call on the same stream: no host sync.
//   2. cell_sweep_kernel runs persistent warps (as many as fit on the card at
//      once, never more than the groups can use); a warp takes the next list
//      entry from a device counter and sweeps its group's selves 32 at a time
//      through the shared stage -> filter -> compute walk of
//      csrc/sph_sweep_walk.cuh.  Each lane knows its own cell (the first or
//      the second of the pair) from the pair's middle start.
//
// A self's K sums are written to row i of the [N, K] output: a self's sorted
// index is its row, so there are no atomics and no gather back.  Rows that no
// group owns (inactive padding, parked past the last cell) are never written:
// the wrapper zero-fills the output and masks with ``active``.  For each
// stencil row the candidate range of a self is computed exactly as
// ops/cell_list.py::row_segments does (x clamped to the grid edge, rows
// outside the grid empty).
//
// The self window (the sharded path; replaces
// sphexample_tpu/ops/pallas_sweep.py::pallas_pair_sweep_sharded, the same TPU
// kernel on halo-extended arrays): the pack may hold more rows than there
// are selves.  Selves are the pack rows [self_off, self_off + n) - a slab of
// the global sorted order between its two halos, or inside the whole gathered
// array - and cell_start arrives rebased to the pack's rows and clamped to
// them.  Only groups with rows in the self range are listed, and a warp
// takes the part of its group's rows that lies there; a cell that straddles
// a slab edge is swept by both slabs, each writing its own rows.  The role
// rule and the own-cell test use the cell's whole range [cs, ce).  A self's
// candidates are visited in the single-device launch's order, so a slab's
// rows come out bit for bit as that launch gives them.  Single device:
// self_off = 0.
//
// Pair math: csrc/sph_pair_math.cuh::add_pair, shared with the block sweep
// as the TPU kernels share ::_pair_math.  Self excluded by index, support
// cutoff d2 <= H2 on the unfused d2 of pair_distance2, the density-diffusion
// role cell-centric: same_cell = cs <= j < ce of the self's own cell,
// role_i = same_cell ? i < j : i > j.  A self's candidates are visited in
// the order of the first version and of the block sweep (stencil rows z, y;
// j ascending): the same bits as both.  Summation order differs from the
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
// break 3.63e10 operations over 67 TFLOP/s = 0.542 ms, against 10.1-10.2 ms
// per launch for the first version (NVIDIA H100 80GB HBM3, 700 W power
// limit).  What the design does about it: no block for an empty cell; the
// lanes of a pair-of-cells group fuller than those of one cell; tiles staged
// asynchronously per warp, with no block-wide barrier; the pair body run
// only over each lane's own accepted rows, where the first version's block
// ran it on every candidate that any of its threads accepted.  Measured on
// an H100 80GB HBM3 (700 W): 7.5-7.6 against 10.2 ms on that dam break,
// 0.24-0.25 against 0.54 ms on the 2D moving square.  What it leaves: a
// pair's last pass is part-full (85 % of the lanes are used on that dam
// break, against 97 % for the block sweep's 32 consecutive rows), the model
// is chosen at run time, and the busiest lane of a tile sets the compute as
// in the block sweep.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sph_pair_math.cuh"
#include "sph_sweep_walk.cuh"

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

// groups: cells (2q, 2q + 1) of one x row; list[0] = their count,
// list[1] = the next entry to take, list[2 ..] = each group's first cell
template <class Params>
__device__ __forceinline__ int group_first_cell(const Params& P, int q) {
    const int half = (P.shape[0] + 1) / 2;
    return (q / half) * P.shape[0] + 2 * (q % half);
}

__global__ void __launch_bounds__(256)
occupied_groups_kernel(const CellSweepParams P, const int* __restrict__ cell_start,
                       int* __restrict__ list) {
    __shared__ int warp_base[8];
    __shared__ int block_base;
    const int half = (P.shape[0] + 1) / 2;
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    bool has = false;
    int c = 0;
    if (q < (P.ncells / P.shape[0]) * half) {
        c = group_first_cell(P, q);
        const int gw = min(2, P.shape[0] - c % P.shape[0]);
        has = max(cell_start[c], P.self_off) < min(cell_start[c + gw], P.self_off + P.n);
    }
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const unsigned b = __ballot_sync(FULL_MASK, has);
    if (lane == 0) warp_base[w] = __popc(b);
    __syncthreads();
    if (threadIdx.x == 0) {
        int sum = 0;
        for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
            const int v = warp_base[k];
            warp_base[k] = sum;
            sum += v;
        }
        block_base = sum ? atomicAdd(list, sum) : 0;
    }
    __syncthreads();
    if (has) list[2 + block_base + warp_base[w] + __popc(b & ((1u << lane) - 1u))] = c;
}

template <int D, bool SPS, bool STORE, bool SHIFT>
__global__ void __launch_bounds__(WALK_THREADS)
cell_sweep_kernel(const CellSweepParams P,
                  const float4* __restrict__ pack,
                  const int* __restrict__ cell_start,
                  int* __restrict__ list,
                  float* __restrict__ out) {
    constexpr int NV = pack_vectors<D>();
    constexpr int K = n_sums<D, STORE, SHIFT>();
    __shared__ __align__(16) float4 tiles[WALK_WARPS][2 * WALK_TILE * NV];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int count = list[0];
    while (true) {
        int e = 0;
        if (lane == 0) e = atomicAdd(list + 1, 1);
        e = __shfl_sync(FULL_MASK, e, 0);
        if (e >= count) return;
        const int c = list[2 + e];                          // the group's first cell
        const int x = c % P.shape[0];
        const int gw = min(2, P.shape[0] - x);
        const int t = c / P.shape[0];
        const int ry = (D == 3) ? t % P.shape[1] : t;
        const int rz = (D == 3) ? t / P.shape[1] : 0;
        const int cs0 = cell_start[c], mid = cell_start[c + 1], ce1 = cell_start[c + 2];
        const int lo = max(cs0, P.self_off);                // the group's selves
        const int hi = min(gw == 2 ? ce1 : mid, P.self_off + P.n);
        for (int base = lo; base < hi; base += 32) {
            WalkLane L;
            L.i = base + lane;
            L.member = L.i < hi;
            const bool second = L.i >= mid;                 // in cell c + 1
            const int cx = x + (second ? 1 : 0);
            L.s_i = second ? mid : cs0;
            L.e_i = second ? ce1 : mid;
            L.xl = max(cx - 1, 0);
            L.xh = min(cx + 1, P.shape[0] - 1);
            const Row s = load_row<D>(pack, L.member ? L.i : lo);
            float acc[K];
#pragma unroll
            for (int k = 0; k < K; ++k) acc[k] = 0.0f;
            walk_pass<D, SPS, STORE, SHIFT, AT_RUN_TIME, AT_RUN_TIME, AT_RUN_TIME>(
                P, pack, cell_start, tiles[warp], ry, rz, L, s, acc);
            if (L.member) {
                float* o = out + (size_t)(L.i - P.self_off) * K;
#pragma unroll
                for (int k = 0; k < K; ++k) o[k] = acc[k];
            }
        }
    }
}

// the groups of this grid: one per x pair of cells of every x row
int group_count(const CellSweepParams& P) {
    return (P.ncells / P.shape[0]) * ((P.shape[0] + 1) / 2);
}

template <int D, bool SPS, bool STORE, bool SHIFT>
cudaError_t launch(const CellSweepParams& P, const float* pack, const int* cell_start,
                   int* list, float* out, cudaStream_t stream) {
    auto kernel = cell_sweep_kernel<D, SPS, STORE, SHIFT>;
    // persistent warps: as many blocks as fit on the card at once (looked up
    // once per instance), never more than the groups can use
    static int resident = 0;
    if (resident == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WALK_THREADS, 0);
        if (err != cudaSuccess) return err;
        resident = max(1, sms * per_sm);
    }
    const int groups = group_count(P);
    cudaError_t err = cudaMemsetAsync(list, 0, 2 * sizeof(int), stream);
    if (err != cudaSuccess) return err;
    occupied_groups_kernel<<<(groups + 255) / 256, 256, 0, stream>>>(P, cell_start, list);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int blocks = min(resident, (groups + WALK_WARPS - 1) / WALK_WARPS);
    kernel<<<blocks, WALK_THREADS, 0, stream>>>(P, reinterpret_cast<const float4*>(pack),
                                                  cell_start, list, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// variant = dims3 << 3 | sps << 2 | store << 1 | shift.
// Returns 0, a cudaError_t code, or -1 for an unknown variant or mode.
// ``list`` is device scratch of sph_cell_sweep_list_size(params) ints.
int sph_cell_sweep(const CellSweepParams* params, int variant, const float* pack,
                   const int* cell_start, int* list, float* out, void* stream) {
    const CellSweepParams P = *params;
    if (P.n <= 0 || P.ncells <= 0) return 0;
    if (P.family < WENDLAND || P.family > CUBIC || P.viscosity < VISC_ZERO
        || P.viscosity > VISC_LAMINAR_SPS || P.diffusion < DIFF_ZERO
        || P.diffusion > DIFF_COMPLEX)
        return -1;
    if (((variant >> 2) & 1) != (P.viscosity == VISC_LAMINAR_SPS)) return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPH_CASE(V, D, SPS, STORE, SHIFT) \
    case V: return static_cast<int>(launch<D, SPS, STORE, SHIFT>(P, pack, cell_start, list, out, st));
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

int sph_cell_sweep_list_size(const CellSweepParams* params) {
    return 2 + group_count(*params);
}

const char* sph_cell_sweep_error_string(int code) {
    if (code == -1) return "unknown cell-sweep variant or mode";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
