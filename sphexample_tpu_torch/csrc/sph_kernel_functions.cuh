// Device functions shared by the CUDA sources of this directory.
//
// The SPH smoothing kernels (Wendland C2, cubic spline), in the same forms as
// models/kernels.py: W(q) and grad W = fac * x_ij, q = d / h in [0, 2].
// ``Params`` is any struct with the f32 members alpha_d, wendland_fac
// (alpha_d * 5 / (8 h^2)), h_inv and eta2.
//
// The packed particle row both neighbor sweeps read (pack_fields in
// ops/block_sweep.py): float4-aligned f32 rows with the GUARDED density
// (padding rows carry 1, never 0) and its reciprocal.

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

struct Row {
    float x[3];
    float v[3];
    float rho, rcp, p, ml;
};

// pack row: 3D (x,y,z,rho)(vx,vy,vz,rcp)(p,ml,-,-); 2D (x,y,vx,vy)(rho,rcp,p,ml);
// ``pack`` may point to global or shared memory
template <int D>
__device__ __forceinline__ Row load_row(const float4* pack, int i) {
    Row r;
    if constexpr (D == 3) {
        const float4 a = pack[3 * i], b = pack[3 * i + 1], c = pack[3 * i + 2];
        r.x[0] = a.x; r.x[1] = a.y; r.x[2] = a.z; r.rho = a.w;
        r.v[0] = b.x; r.v[1] = b.y; r.v[2] = b.z; r.rcp = b.w;
        r.p = c.x; r.ml = c.y;
    } else {
        const float4 a = pack[2 * i], b = pack[2 * i + 1];
        r.x[0] = a.x; r.x[1] = a.y; r.v[0] = a.z; r.v[1] = a.w;
        r.rho = b.x; r.rcp = b.y; r.p = b.z; r.ml = b.w;
    }
    return r;
}
