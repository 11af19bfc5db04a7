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
// Design (first, simple version): one thread per cell-sorted self row i.
// For each of the 3^(D-1) stencil rows it takes the contiguous candidate
// range [cell_start[key_lo], cell_start[key_hi + 1]) exactly as
// ops/cell_list.py::row_segments computes it (x-range clamped to the grid
// edge, rows outside the grid empty), loops over j, and accumulates drho and
// acc in f32 registers.  One output row [drho, acc_0..acc_{D-1}] per self, in
// sorted order.  Each pair is computed from both endpoints: no atomics.
// Self is excluded (j != i), the support cutoff is d2 <= H2, and the
// density-diffusion role is cell-centric: for a pair in the self's own cell
// [s_i, e_i) the i role goes to the lower sorted index, across cells to the
// particle in the later cell (the higher sorted index) - equivalently
// role_i = (cs_i > cs_j) || (cs_i == cs_j && i < j) on own-cell starts.
//
// Fields: the wrapper packs per row, in f32, position, velocity, the
// GUARDED density (padding rows carry 1, never 0) with its reciprocal,
// pressure and motion limiter (pack_fields in ops/block_sweep.py).  The pair
// math is the plain form of ops/interactions.py (grad W as a scalar factor
// times x_ij, computed per pair; pair geometry elementwise, never through
// |xi|^2 - 2 xi.xj + |xj|^2), with 1/rho read from the pack instead of a
// division.  Summation order differs from the plain version, so results
// agree to f32 rounding, not bit for bit.
//
// The self window (the sharded path; replaces
// sphexample_tpu/ops/pallas_block_sweep.py::pallas_block_sweep_sharded, the
// same TPU kernel on a halo-extended pack): the pack may hold more rows than
// there are selves.  Selves are the pack rows [self_off, self_off + n) - a
// slab of the global sorted order between its left and right halo rows, or
// inside the whole gathered array; ``cell`` and ``active`` hold the n self
// rows only, the output is [n, 1+D], and cell_start arrives rebased to the
// pack's rows and clamped to them.  A rigid shift keeps the order of two
// sorted indices, so the role rule compares pack rows and no global index
// rides the exchange (the TPU kernel packs it as f32, whence its 2^24-row
// bound); the per-self candidate order is that of the single-device launch,
// so a slab's rows come out bit for bit as that launch gives them.  A stencil
// that reaches past the halo is cut by the clamp without a sign: the step's
// max_halo telemetry guards that.  Single device: self_off = 0.
//
// Specialised by template on dims (2, 3), kernel family (Wendland C2, cubic
// spline), viscosity (ZERO, ARTIFICIAL) and density diffusion (ZERO,
// LINEAR).  The wrapper raises NotImplementedError for any other model.
//
// What bounds it on the H100: the operation count.  A candidate costs about
// 10 f32 operations to reject (difference, squared distance, compare) and an
// accepted pair about 60 more; the inputs are ~80 bytes per particle (a few
// microseconds of HBM time at 160k particles), so the bound is operations
// over the 67 TFLOP/s f32 rate.  chip_smoke.py counts the candidates and
// pairs of its inputs and prints the bound beside the measured time.
//
// What this design leaves on the table (later work): candidate reads are
// not staged - each thread walks its own candidate range, so the loads of a
// warp coalesce only where its selves share a cell; no shared-memory tile
// of a cell row; warp divergence at the support cutoff and between selves
// of different cells (different trip counts); at ~56 registers a thread
// (ptxas, 3D instance) 9 blocks of 128 fit an SM, so the 1,248 blocks of
// 159,712 selves are one wave of 1,188 blocks on 132 SMs plus a short tail.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sph_kernel_functions.cuh"

extern "C" {

struct SweepParams {
    int n;            // self rows
    int self_off;     // pack row of self row 0 (0 on a single device)
    int cmin[3];
    int shape[3];
    int strides[3];
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
    float cubic_eps;
    float w_dx_inv;      // 1 / W(dx), cubic tensile correction
};

}  // extern "C"

namespace {

template <int D, int FAM, bool VISC, bool DIFF>
__global__ void __launch_bounds__(128)
block_sweep_kernel(const SweepParams P,
                   const float4* __restrict__ pack,
                   const int* __restrict__ cell,
                   const int* __restrict__ cell_start,
                   const unsigned char* __restrict__ active,
                   float* __restrict__ out) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;   // self row
    if (r >= P.n) return;
    const int i = P.self_off + r;                          // its pack row
    float* o = out + (size_t)r * (D + 1);
    if (!active[r]) {
#pragma unroll
        for (int k = 0; k <= D; ++k) o[k] = 0.0f;
        return;
    }

    const Row s = load_row<D>(pack, i);
    int rel[D];
    int key = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        rel[d] = cell[(size_t)r * D + d] - P.cmin[d];
        const int rc = min(max(rel[d], 0), P.shape[d] - 1);
        key += rc * P.strides[d];
    }
    const int s_i = cell_start[key];
    const int e_i = cell_start[key + 1];
    const int x_lo = min(max(rel[0] - 1, 0), P.shape[0] - 1);
    const int x_hi = min(max(rel[0] + 1, 0), P.shape[0] - 1);

    float drho = 0.0f;
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.0f;

    constexpr int R2 = (D == 3) ? 1 : 0;
    for (int r2 = -R2; r2 <= R2; ++r2) {
        for (int r1 = -1; r1 <= 1; ++r1) {
            const int y = rel[1] + r1;
            if (y < 0 || y >= P.shape[1]) continue;
            int base = y * P.strides[1];
            if constexpr (D == 3) {
                const int z = rel[2] + r2;
                if (z < 0 || z >= P.shape[2]) continue;
                base += z * P.strides[2];
            }
            const int jb = cell_start[base + x_lo];
            const int je = cell_start[base + x_hi + 1];
            for (int j = jb; j < je; ++j) {
                const Row c = load_row<D>(pack, j);
                float xij[D];
                float d2 = 0.0f;
#pragma unroll
                for (int d = 0; d < D; ++d) {
                    xij[d] = s.x[d] - c.x[d];
                    d2 += xij[d] * xij[d];
                }
                if (d2 > P.H2 || j == i) continue;

                const float dist = sqrtf(d2);
                const float q = fminf(dist * P.h_inv, 2.0f);
                const float fac = grad_factor<FAM>(P, q, dist);
                float vdotx = 0.0f;
#pragma unroll
                for (int d = 0; d < D; ++d) vdotx += (s.v[d] - c.v[d]) * xij[d];

                // continuity: -rho_i (m0/rho_j) (-v_ij . gradW)
                float dr = s.rho * P.m0 * c.rcp * fac * vdotx;
                if constexpr (DIFF) {
                    const bool same_cell = (j >= s_i) && (j < e_i);
                    const bool role_i = same_cell ? (i < j) : (i > j);
                    const float rho_h = P.C_lin * xij[D - 1];
                    // psi . gradW = 2 (rho_j - rho_i - rho_h)/(d2 + eta2) * (-fac d2)
                    const float psi_gw = 2.0f * ((c.rho - s.rho) - rho_h) / (d2 + P.eta2)
                                         * (-fac * d2);
                    const float vol = P.m0 * (role_i ? c.rcp : s.rcp);
                    dr += P.diff_fac * vol * psi_gw * (s.ml * c.ml);
                }
                drho += dr;

                // momentum: -m0 ((p_i + p_j)/(rho_i rho_j) + f_ab) gradW
                float pfac = (s.p + c.p) * (s.rcp * c.rcp);
                if constexpr (FAM == CUBIC) {
                    const float ratio = kernel_value<FAM>(P, q) * P.w_dx_inv;
                    const float ratio2 = ratio * ratio;
                    pfac += P.cubic_eps * (s.p * s.rcp * s.rcp + c.p * c.rcp * c.rcp)
                            * (ratio2 * ratio2);
                }
                float A = -P.m0 * pfac;
                if constexpr (VISC) {
                    if (vdotx < 0.0f) {
                        // Monaghan: m0 alpha c0 mu / rho_bar, mu = h v.x/(d2+eta2)
                        const float mu = P.h * vdotx / (d2 + P.eta2);
                        A += P.m0 * P.alpha_c0 * mu / (0.5f * (s.rho + c.rho));
                    }
                }
                const float Af = A * fac;
#pragma unroll
                for (int d = 0; d < D; ++d) acc[d] += Af * xij[d];
            }
        }
    }
    o[0] = drho;
#pragma unroll
    for (int d = 0; d < D; ++d) o[1 + d] = acc[d];
}

template <int D, int FAM, bool VISC, bool DIFF>
cudaError_t launch(const SweepParams& P, const float* pack, const int* cell,
                   const int* cell_start, const unsigned char* active,
                   float* out, cudaStream_t stream) {
    const int threads = 128;
    const int blocks = (P.n + threads - 1) / threads;
    block_sweep_kernel<D, FAM, VISC, DIFF><<<blocks, threads, 0, stream>>>(
        P, reinterpret_cast<const float4*>(pack), cell, cell_start, active, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// variant = dims3 << 3 | cubic << 2 | artificial << 1 | linear.
// Returns 0, a cudaError_t code, or -1 for an unknown variant.
int sph_block_sweep(const SweepParams* params, int variant, const float* pack,
                    const int* cell, const int* cell_start,
                    const unsigned char* active, float* out, void* stream) {
    const SweepParams P = *params;
    if (P.n <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPH_CASE(V, D, F, VI, DI) \
    case V: return static_cast<int>(launch<D, F, VI, DI>(P, pack, cell, cell_start, active, out, st));
    switch (variant) {
        SPH_CASE(0, 2, WENDLAND, false, false)
        SPH_CASE(1, 2, WENDLAND, false, true)
        SPH_CASE(2, 2, WENDLAND, true, false)
        SPH_CASE(3, 2, WENDLAND, true, true)
        SPH_CASE(4, 2, CUBIC, false, false)
        SPH_CASE(5, 2, CUBIC, false, true)
        SPH_CASE(6, 2, CUBIC, true, false)
        SPH_CASE(7, 2, CUBIC, true, true)
        SPH_CASE(8, 3, WENDLAND, false, false)
        SPH_CASE(9, 3, WENDLAND, false, true)
        SPH_CASE(10, 3, WENDLAND, true, false)
        SPH_CASE(11, 3, WENDLAND, true, true)
        SPH_CASE(12, 3, CUBIC, false, false)
        SPH_CASE(13, 3, CUBIC, false, true)
        SPH_CASE(14, 3, CUBIC, true, false)
        SPH_CASE(15, 3, CUBIC, true, true)
        default: return -1;
    }
#undef SPH_CASE
}

const char* sph_error_string(int code) {
    if (code == -1) return "unknown sweep variant";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
