// The pair physics both neighbor sweeps share (the counterpart of
// sphexample_tpu/ops/pallas_sweep.py::_pair_math, which the TPU block and
// cell-pair kernels share): what one candidate pair adds to a self's K sums.
// Each kernel keeps its own walk - block_sweep.cu one thread per self,
// cell_sweep.cu one block per cell with shared tiles - and calls these.
//
// Pair math: the plain form of ops/interactions.py and models/*.py (grad W
// as a scalar factor times x_ij; pair geometry elementwise, never through
// |xi|^2 - 2 xi.xj + |xj|^2; m0 explicit in every term), with 1/rho read
// from the pack.  COMPLEX diffusion evaluates -inv_eos(-P_h) at the j-role
// endpoint (the inverse EOS is not odd), LAMINAR keeps the reference's
// (rho_i + rho_j) + (d2 + eta2) denominator, the cubic spline its tensile
// term with W at the raw q0 = dx, ZERO_GRAVITY_LINEAR is not gated by the
// motion limiter.
//
// ``Params`` is any struct with the members of CellSweepParams from
// ``family`` on (block_sweep.cu's SweepParams has them all).  The family,
// viscosity and diffusion come either from the template (a compile-time
// branch) or, given as AT_RUN_TIME, from those members (a grid-uniform
// run-time branch); the arithmetic is the same either way.

#pragma once

#include "sph_kernel_functions.cuh"

enum { VISC_ZERO = 0, VISC_ARTIFICIAL = 1, VISC_LAMINAR = 2, VISC_LAMINAR_SPS = 3 };
enum { DIFF_ZERO = 0, DIFF_ZERO_GRAVITY_LINEAR = 1, DIFF_LINEAR = 2, DIFF_COMPLEX = 3 };
// a model template argument that leaves the choice to the run-time member
constexpr int AT_RUN_TIME = -1;

// K = (1+D)(1 + STORE + PLANAR) sums per self: drho, dv/dt, then W, grad W,
// then grad C, div r
template <int D, bool STORE, bool SHIFT>
__host__ __device__ constexpr int n_sums() {
    return (1 + D) * (1 + (STORE ? 1 : 0) + (SHIFT ? 1 : 0));
}

// x_ij = x_s - x_n and its squared length, summed unfused: the cutoff decides
// on the plain version's d2, bit for bit in 2D - with k != 2 (the
// MovingSquare deck's sqrt 2) the kernel is cut where W is not yet zero, and
// lattice neighbours sit exactly on that rim
template <int D>
__device__ __forceinline__ float pair_distance2(const Row& s, const Row& n, float* xij) {
    float d2 = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        xij[d] = s.x[d] - n.x[d];
        d2 = __fadd_rn(d2, __fmul_rn(xij[d], xij[d]));
    }
    return d2;
}

// rho = rho0 ((1 + P/Cb)^(1/7) - 1), odd root by copysign.  P/Cb is ~1e-4,
// so root - 1 is taken as expm1(log1p(P/Cb) / 7): the same function without
// the f32 cancellation of forming 1 + P/Cb first.
template <class Params>
__device__ __forceinline__ float inverse_hydrostatic_eos(const Params& P, float Ph) {
    const float y = Ph * P.Cb_inv;
    if (y > -1.0f) return P.rho0 * expm1f(log1pf(y) * (1.0f / 7.0f));
    return P.rho0 * (-powf(-(1.0f + y), 1.0f / 7.0f) - 1.0f);
}

// tau . gradW of the SPS stress built from S = s_fac dv (x) gw and rho_self
// (models/viscosity.py::_laminar_sps): dev_fac dv |gw|^2 + iso gw
template <int D, class Params>
__device__ __forceinline__ void sps_tau_dot_gw(const Params& P, float s_fac,
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

// What the pair (s, n) in support (d2 <= H2, n not s) adds to the self's
// sums acc[0 .. K): xij and d2 from pair_distance2; role_i is the
// density-diffusion role of the self (the caller's cell-centric rule).
template <int D, bool SPS, bool STORE, bool SHIFT, int FAM, int VISC, int DIFF, class Params>
__device__ __forceinline__ void add_pair(const Params& P, const Row& s, const Row& n,
                                         const float* xij, float d2, bool role_i,
                                         float* acc) {
    constexpr int K_W = 1 + D;                          // W, grad W
    constexpr int K_C = (1 + D) * (1 + (STORE ? 1 : 0));  // grad C, div r
    const bool cubic = (FAM == AT_RUN_TIME) ? P.family == CUBIC : FAM == CUBIC;
    const int viscosity = (VISC == AT_RUN_TIME) ? P.viscosity : VISC;
    const int diffusion = (DIFF == AT_RUN_TIME) ? P.diffusion : DIFF;

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
    if (diffusion != DIFF_ZERO) {
        float num = n.rho - s.rho;
        float gate = mlg;
        if (diffusion == DIFF_ZERO_GRAVITY_LINEAR) {
            gate = 1.0f;
        } else if (diffusion == DIFF_LINEAR) {
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
    if (viscosity == VISC_ARTIFICIAL) {
        if (vdotx < 0.0f) {
            // Monaghan: m0 alpha c0 mu / rho_bar, mu = h v.x/(d2+eta2)
            const float mu = P.h * vdotx / (d2 + P.eta2);
            A += P.m0 * P.alpha_c0 * mu / (0.5f * (s.rho + n.rho));
        }
    }
    const float Af = A * fac;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[1 + d] += Af * xij[d];
    if (viscosity >= VISC_LAMINAR) {
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
        acc[K_W] += cubic ? kernel_value<CUBIC>(P, q) : kernel_value<WENDLAND>(P, q);
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
