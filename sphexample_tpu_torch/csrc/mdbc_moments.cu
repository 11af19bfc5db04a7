// Ghost-node moment sums of the modified dynamic boundary condition (mDBC),
// for NVIDIA Hopper (sm_90a).  Built by ops/_build.py with nvcc into a shared
// library with a plain C interface and bound with ctypes
// (ops/mdbc_moments.py).
//
// Replaces: sphexample_tpu/ops/pallas_mdbc.py::_make_mdbc_kernel (the TPU
// moment kernel).  It computes WHAT that kernel computes - per ghost point g
// the K = (D+1)(D+2) sums over the fluid particles j within the support of g
//
//     b = sum m0 [W, grad W]                         (D+1 scalars)
//     A = sum [V_j W, V_j grad W] (x) [1, -x_gj]     ((D+1)^2 scalars)
//
// with x_gj = g - x_j and V_j = m0 / rho_j - and none of its TPU structure:
// no per-call sort of the ghosts by cell key, no program tables, no [R+8,128]
// self window with its roll, no 128-aligned candidate windows with their
// capacity limits.  The closed-form solve and the decision tree stay outside
// (ops/mdbc.py), as they do in the JAX package.
//
// Design (first, simple version): one warp per ghost slot, in the caller's
// ghost order.  The warp derives the ghost's cell fresh from the ghost point
// (round half away from zero on the pitch H, clamped into the grid; the
// multiply and the add are kept unfused so that the f32 result is the plain
// version's bit for bit), then walks the 3^(D-1) stencil rows.  A row's
// candidates are the contiguous range [cell_start[key_lo], cell_start[key_hi
// + 1]) exactly as ops/cell_list.py::row_segments computes it (x-range
// clipped at the grid edge, rows outside the grid skipped).  The 32 lanes
// stride over the range, so a warp's loads come from neighbouring
// addresses; each lane keeps the K sums in f32 registers, a
// shuffle reduction adds the lanes, and lane k writes scalar k of row b of
// the [B, K] output.  Invalid slots give zeros.  No atomics.
//
// Candidates: the kernel reads the f32 state arrays as they are - position
// [N, D], density [N], motion limiter [N] - with no pack in between (an f32
// state is passed through untouched).  As in the TPU kernel's body, the
// fluid-only test is ml_j > 0.5, the density is guarded (rho_j > 0 ? rho_j :
// 1) and V_j = m0 / rho_j is formed per accepted pair; the limiter and the
// density are loaded only for candidates inside the support.  The cutoff is
// d2 <= H2; pair geometry is computed elementwise, never through
// |a|^2 - 2 a.b + |b|^2.  The order of the sums differs from the plain
// version's, so the moments agree to f32 rounding, not bit for bit.
//
// For an f64 state the wrapper casts to f32 first; a ghost point within an
// f32 rounding of a cell edge can then land in the neighbouring cell.  The
// particles it could lose sit at the edge of the support, where W and grad W
// vanish.
//
// What bounds it on the H100: the operation count.  In 3D a candidate costs
// 10 f32 operations to reject (difference, squared distance, two compares)
// and an accepted pair 56 more (density guard and volume, kernel value and
// gradient, 4 + 16 products and sums); the inputs are 20 bytes per particle
// and 12 per ghost, the output 80 bytes per ghost.  chip_smoke.py counts the candidates and pairs
// of its inputs and prints the bound beside the measured time.
//
// What this design leaves on the table (later work): ghosts of one cell read
// the same candidate rows once per warp instead of staging them in shared
// memory once per block; a row range shorter than 32 leaves lanes idle; the
// solve could be fused behind the reduction.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sph_kernel_functions.cuh"

extern "C" {

struct MdbcParams {
    int nb;           // ghost slots
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
};

}  // extern "C"

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <int D, int FAM>
__global__ void __launch_bounds__(128)
mdbc_moments_kernel(const MdbcParams P,
                    const float* __restrict__ ghost,          // [B, D]
                    const unsigned char* __restrict__ gvalid,  // [B]
                    const float* __restrict__ pos,             // [N, D]
                    const float* __restrict__ rho,             // [N]
                    const float* __restrict__ ml,              // [N]
                    const int* __restrict__ cell_start,
                    float* __restrict__ out) {                 // [B, K]
    constexpr int DP = D + 1;
    constexpr int K = DP * (D + 2);
    const int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (b >= P.nb) return;  // whole warps only: blockDim is a multiple of 32

    float sb[DP];       // sum [W, grad W]
    float sA[DP][DP];   // sum [V W, V grad W] (x) [1, -x_gj]
#pragma unroll
    for (int a = 0; a < DP; ++a) {
        sb[a] = 0.0f;
#pragma unroll
        for (int c = 0; c < DP; ++c) sA[a][c] = 0.0f;
    }

    if (gvalid[b]) {
        float g[D];
        int rel[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
            g[d] = ghost[(size_t)b * D + d];
            // map_floor: sign(x) * trunc(|x| * H_inv + 0.5), two roundings
            const float t = truncf(__fadd_rn(__fmul_rn(fabsf(g[d]), P.H_inv), 0.5f));
            const int c = static_cast<int>(g[d] < 0.0f ? -t : t);
            rel[d] = min(max(c - P.cmin[d], 0), P.shape[d] - 1);
        }
        const int x_lo = max(rel[0] - 1, 0);
        const int x_hi = min(rel[0] + 1, P.shape[0] - 1);

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
                for (int j = jb + lane; j < je; j += 32) {
                    float x[D];
                    float d2 = 0.0f;
#pragma unroll
                    for (int d = 0; d < D; ++d) {
                        x[d] = g[d] - pos[(size_t)j * D + d];
                        d2 += x[d] * x[d];
                    }
                    // inclusive cutoff, fluid rows only (ml == 1 <=> FLUID)
                    if (d2 > P.H2 || !(ml[j] > 0.5f)) continue;
                    const float rho_j = rho[j];
                    const float vol = P.m0 / (rho_j > 0.0f ? rho_j : 1.0f);

                    const float dist = sqrtf(d2);
                    const float q = fminf(dist * P.h_inv, 2.0f);
                    const float fac = grad_factor<FAM>(P, q, dist);
                    float f[DP];
                    f[0] = kernel_value<FAM>(P, q);
#pragma unroll
                    for (int d = 0; d < D; ++d) f[1 + d] = fac * x[d];
#pragma unroll
                    for (int a = 0; a < DP; ++a) {
                        sb[a] += f[a];
                        const float fa = vol * f[a];
                        sA[a][0] += fa;
#pragma unroll
                        for (int d = 0; d < D; ++d) sA[a][1 + d] -= fa * x[d];
                    }
                }
            }
        }
    }

    // add the lanes; lane k writes scalar k of row b: b first, then A row-major
    float* o = out + (size_t)b * K;
#pragma unroll
    for (int a = 0; a < DP; ++a) {
        const float v = P.m0 * warp_sum(sb[a]);
        if (lane == a) o[a] = v;
    }
#pragma unroll
    for (int a = 0; a < DP; ++a) {
#pragma unroll
        for (int c = 0; c < DP; ++c) {
            const float v = warp_sum(sA[a][c]);
            if (lane == DP + a * DP + c) o[DP + a * DP + c] = v;
        }
    }
}

template <int D, int FAM>
cudaError_t launch(const MdbcParams& P, const float* ghost,
                   const unsigned char* gvalid, const float* pos,
                   const float* rho, const float* ml, const int* cell_start,
                   float* out, cudaStream_t stream) {
    const int threads = 128;  // 4 warps = 4 ghosts a block
    const int blocks = (P.nb + 3) / 4;
    mdbc_moments_kernel<D, FAM><<<blocks, threads, 0, stream>>>(
        P, ghost, gvalid, pos, rho, ml, cell_start, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// variant = dims3 << 1 | cubic.
// Returns 0, a cudaError_t code, or -1 for an unknown variant.
int sph_mdbc_moments(const MdbcParams* params, int variant, const float* ghost,
                     const unsigned char* gvalid, const float* pos,
                     const float* rho, const float* ml, const int* cell_start,
                     float* out, void* stream) {
    const MdbcParams P = *params;
    if (P.nb <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (variant) {
        case 0: return static_cast<int>(launch<2, WENDLAND>(P, ghost, gvalid, pos, rho, ml, cell_start, out, st));
        case 1: return static_cast<int>(launch<2, CUBIC>(P, ghost, gvalid, pos, rho, ml, cell_start, out, st));
        case 2: return static_cast<int>(launch<3, WENDLAND>(P, ghost, gvalid, pos, rho, ml, cell_start, out, st));
        case 3: return static_cast<int>(launch<3, CUBIC>(P, ghost, gvalid, pos, rho, ml, cell_start, out, st));
        default: return -1;
    }
}

const char* sph_mdbc_error_string(int code) {
    if (code == -1) return "unknown mDBC variant";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
