// The SPH smoothing kernels (Wendland C2, cubic spline) as device functions,
// shared by the CUDA sources of this directory.  The same forms as
// models/kernels.py: W(q) and grad W = fac * x_ij, q = d / h in [0, 2].
// ``Params`` is any struct with the f32 members alpha_d, wendland_fac
// (alpha_d * 5 / (8 h^2)), h_inv and eta2.

#pragma once

enum { WENDLAND = 0, CUBIC = 1 };

template <int FAM, class Params>
__device__ __forceinline__ float kernel_value(const Params& P, float q) {
    if constexpr (FAM == WENDLAND) {
        const float t = 1.0f - 0.5f * q;
        const float t2 = t * t;
        return P.alpha_d * (t2 * t2) * (2.0f * q + 1.0f);
    } else {
        if (q <= 1.0f) return P.alpha_d * (1.0f - 1.5f * q * q + 0.75f * q * q * q);
        const float t = 2.0f - q;
        return P.alpha_d * 0.25f * (t * t * t);
    }
}

// grad W = fac * x_ij, d = |x_ij|
template <int FAM, class Params>
__device__ __forceinline__ float grad_factor(const Params& P, float q, float d) {
    if constexpr (FAM == WENDLAND) {
        const float t = q - 2.0f;
        return P.wendland_fac * (t * t * t);
    } else {
        float dwdq;
        if (q <= 1.0f) {
            dwdq = P.alpha_d * (-3.0f * q + 2.25f * q * q);
        } else {
            const float t = 2.0f - q;
            dwdq = P.alpha_d * (-0.75f) * (t * t);
        }
        return dwdq * P.h_inv / (d + P.eta2);
    }
}
