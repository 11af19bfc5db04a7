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
// Pair math: the plain form of ops/interactions.py and models/*.py (grad W
// as a scalar factor times x_ij; pair geometry elementwise, never through
// |xi|^2 - 2 xi.xj + |xj|^2; m0 explicit in every term), with 1/rho read
// from the pack.  Self excluded by index, support cutoff d2 <= H2, the
// density-diffusion role cell-centric: same_cell = cs <= j < ce of the
// block's own cell, role_i = same_cell ? i < j : i > j.  COMPLEX diffusion
// evaluates -inv_eos(-P_h) at the j-role endpoint (the inverse EOS is not
// odd), LAMINAR keeps the reference's (rho_i + rho_j) + (d2 + eta2)
// denominator, the cubic spline its tensile term with W at the raw q0 = dx,
// ZERO_GRAVITY_LINEAR is not gated by the motion limiter.  The squared
// distance is summed unfused, so that in 2D the cutoff takes the plain
// version's decision bit for bit: a kernel with k != 2 (the MovingSquare
// deck's sqrt 2) is cut where W is not yet zero, and lattice neighbours sit
// exactly on that rim.  Summation order differs from the plain version:
// agreement to f32 rounding, not bit for bit.
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

#include "sph_kernel_functions.cuh"

extern "C" {

enum { VISC_ZERO = 0, VISC_ARTIFICIAL = 1, VISC_LAMINAR = 2, VISC_LAMINAR_SPS = 3 };
enum { DIFF_ZERO = 0, DIFF_ZERO_GRAVITY_LINEAR = 1, DIFF_LINEAR = 2, DIFF_COMPLEX = 3 };

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

// rho = rho0 ((1 + P/Cb)^(1/7) - 1), odd root by copysign.  P/Cb is ~1e-4,
// so root - 1 is taken as expm1(log1p(P/Cb) / 7): the same function without
// the f32 cancellation of forming 1 + P/Cb first.
__device__ __forceinline__ float inverse_hydrostatic_eos(const CellSweepParams& P, float Ph) {
    const float y = Ph * P.Cb_inv;
    if (y > -1.0f) return P.rho0 * expm1f(log1pf(y) * (1.0f / 7.0f));
    return P.rho0 * (-powf(-(1.0f + y), 1.0f / 7.0f) - 1.0f);
}

// tau . gradW of the SPS stress built from S = s_fac dv (x) gw and rho_self
// (models/viscosity.py::_laminar_sps): dev_fac dv |gw|^2 + iso gw
template <int D>
__device__ __forceinline__ void sps_tau_dot_gw(const CellSweepParams& P, float s_fac,
                                               float rho_self, const float* dv,
                                               const float* gw, float dv2, float gw2,
                                               float dv_gw, float* t) {
    const float norm_S2 = 2.0f * (s_fac * s_fac) * dv2 * gw2;
    const float norm_S = sqrtf(norm_S2);
    const float nu_t = P.cs2_dx2 * norm_S;
    const float trace_S = s_fac * dv_gw;
    const float iso = -(trace_S / 3.0f) * (2.0f * nu_t * rho_self)
                      - (2.0f / 3.0f) * rho_self * P.blin_dx2 * norm_S2;
    const float dev_fac = 2.0f * nu_t * rho_self * s_fac;
#pragma unroll
    for (int d = 0; d < D; ++d) t[d] += dev_fac * dv[d] * gw2 + iso * gw[d];
}

template <int D, bool SPS, bool STORE, bool SHIFT>
__global__ void __launch_bounds__((D == 3) ? 64 : 32)
cell_sweep_kernel(const CellSweepParams P,
                  const float4* __restrict__ pack,
                  const int* __restrict__ cell_start,
                  float* __restrict__ out) {
    constexpr int NV = (D == 3) ? 3 : 2;               // float4s per packed row
    constexpr int K = (1 + D) * (1 + (STORE ? 1 : 0) + (SHIFT ? 1 : 0));
    constexpr int K_W = 1 + D;                          // W, grad W
    constexpr int K_C = (1 + D) * (1 + (STORE ? 1 : 0));  // grad C, div r
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
    const bool cubic = P.family == CUBIC;

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
                        float d2 = 0.0f;
#pragma unroll
                        for (int d = 0; d < D; ++d) {
                            xij[d] = s.x[d] - n.x[d];
                            // unfused: the cutoff decides on the plain
                            // version's d2, bit for bit in 2D - with k != 2
                            // the kernel is cut where W is not yet zero
                            d2 = __fadd_rn(d2, __fmul_rn(xij[d], xij[d]));
                        }
                        if (d2 > P.H2 || j == i) continue;

                        const float dist = sqrtf(d2);
                        const float q = fminf(dist * P.h_inv, 2.0f);
                        const float fac = cubic ? grad_factor<CUBIC>(P, q, dist)
                                                : grad_factor<WENDLAND>(P, q, dist);
                        float vij[D];
                        float vdotx = 0.0f;
#pragma unroll
                        for (int d = 0; d < D; ++d) {
                            vij[d] = s.v[d] - n.v[d];
                            vdotx += vij[d] * xij[d];
                        }
                        const float fac_d2 = fac * d2;      // x_ij . gradW
                        const float mlg = s.ml * n.ml;

                        // continuity: -rho_i (m0/rho_j) (-v_ij . gradW)
                        float dr = s.rho * P.m0 * n.rcp * fac * vdotx;
                        if (P.diffusion != DIFF_ZERO) {
                            const bool same_cell = (j >= cs) && (j < ce);
                            const bool role_i = same_cell ? (i < j) : (i > j);
                            float num = n.rho - s.rho;
                            float gate = mlg;
                            if (P.diffusion == DIFF_ZERO_GRAVITY_LINEAR) {
                                gate = 1.0f;
                            } else if (P.diffusion == DIFF_LINEAR) {
                                num -= P.C_lin * xij[D - 1];
                            } else {
                                const float Ph = P.rho0_g * xij[D - 1];
                                num -= role_i ? inverse_hydrostatic_eos(P, Ph)
                                              : -inverse_hydrostatic_eos(P, -Ph);
                            }
                            // psi . gradW = 2 num / (d2 + eta2) * (-x_ij . gradW)
                            const float psi_gw = 2.0f * num / (d2 + P.eta2) * (-fac_d2);
                            const float vol = P.m0 * (role_i ? n.rcp : s.rcp);
                            dr += P.diff_fac * vol * psi_gw * gate;
                        }
                        acc[0] += dr;

                        // momentum: -m0 ((p_i + p_j)/(rho_i rho_j) + f_ab) gradW
                        float pfac = (s.p + n.p) * (s.rcp * n.rcp);
                        if (cubic) {
                            const float ratio = kernel_value<CUBIC>(P, q) * P.w_dx_inv;
                            const float ratio2 = ratio * ratio;
                            pfac += P.cubic_eps * (s.p * s.rcp * s.rcp + n.p * n.rcp * n.rcp)
                                    * (ratio2 * ratio2);
                        }
                        float A = -P.m0 * pfac;
                        if (P.viscosity == VISC_ARTIFICIAL) {
                            if (vdotx < 0.0f) {
                                // Monaghan: m0 alpha c0 mu / rho_bar, mu = h v.x/(d2+eta2)
                                const float mu = P.h * vdotx / (d2 + P.eta2);
                                A += P.m0 * P.alpha_c0 * mu / (0.5f * (s.rho + n.rho));
                            }
                        }
                        const float Af = A * fac;
#pragma unroll
                        for (int d = 0; d < D; ++d) acc[1 + d] += Af * xij[d];
                        if (P.viscosity >= VISC_LAMINAR) {
                            // 4 m0 nu0 (x.gradW) / ((rho_i + rho_j) + (d2 + eta2)) v_ij
                            const float term = P.lam_fac * fac_d2
                                               / ((s.rho + n.rho) + (d2 + P.eta2));
#pragma unroll
                            for (int d = 0; d < D; ++d) acc[1 + d] += term * vij[d];
                        }
                        if constexpr (SPS) {
                            float dv[D], gw[D], tt[D];
                            float dv2 = 0.0f, gw2 = 0.0f, dv_gw = 0.0f;
#pragma unroll
                            for (int d = 0; d < D; ++d) {
                                dv[d] = -vij[d];
                                gw[d] = fac * xij[d];
                                dv2 += dv[d] * dv[d];
                                gw2 += gw[d] * gw[d];
                                dv_gw += dv[d] * gw[d];
                                tt[d] = 0.0f;
                            }
                            sps_tau_dot_gw<D>(P, P.m0 * n.rcp, s.rho, dv, gw, dv2, gw2, dv_gw, tt);
                            sps_tau_dot_gw<D>(P, P.m0 * s.rcp, n.rho, dv, gw, dv2, gw2, dv_gw, tt);
                            const float tf = P.m0 * (s.rcp * n.rcp);
#pragma unroll
                            for (int d = 0; d < D; ++d) acc[1 + d] += tf * tt[d];
                        }
                        if constexpr (STORE) {
                            acc[K_W] += cubic ? kernel_value<CUBIC>(P, q)
                                              : kernel_value<WENDLAND>(P, q);
#pragma unroll
                            for (int d = 0; d < D; ++d) acc[K_W + 1 + d] += fac * xij[d];
                        }
                        if constexpr (SHIFT) {
                            // grad C with the self density, div r with the neighbor's
                            const float gcf = P.m0 * s.rcp * fac;
#pragma unroll
                            for (int d = 0; d < D; ++d) acc[K_C + d] += gcf * xij[d];
                            acc[K_C + D] += P.m0 * n.rcp * (-fac_d2) * mlg;
                        }
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
