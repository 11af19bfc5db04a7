// The input pack of both neighbor sweeps (csrc/block_sweep.cu,
// csrc/cell_sweep.cu) for NVIDIA Hopper (sm_90a): each particle's position,
// velocity, density, pressure and motion limiter, in the state's dtype, into
// one float4-aligned f32 row.  Built by ops/_build.py with nvcc into a shared
// library with a plain C interface and bound with ctypes
// (ops/block_sweep.py:pack_fields).
//
// Replaces no TPU kernel: it does the work of the JAX package's XLA glue
// sphexample_tpu/ops/pallas_block_sweep.py::pack_block_fields, which the
// port's plain version ops/block_sweep.py:pack_fields_plain writes as a
// torch.cat of column pieces.  That cat writes each piece into a column of
// the 48-byte rows, 4 useful bytes a 32-byte sector for a one-column piece;
// past the 50 MB L2 the partial sectors go back to device memory piecemeal.
//
// Bound: device memory.  A 3D row reads 36 bytes (f32 state) and writes 48,
// a 2D row reads 28 and writes 32; nothing is read twice and there is no
// arithmetic to speak of.  A block takes PACK_THREADS consecutive rows: each
// thread computes its row into shared memory, then the block writes the
// rows' float4s out in order, consecutive threads on consecutive float4s, so
// a warp's store is 512 contiguous bytes - whole sectors, whole lines.  (A
// thread storing its own row's float4s straight to device memory, 48 bytes
// apart across a warp, ran at half this speed on an H100: 0.129 against
// 0.064 ms at 2.2M rows.)

// Rows (the layout the sweeps read):
//   3D  (x, y, z, rho) (vx, vy, vz, 1/rho) (p, ml, +0, +0)
//   2D  (x, y, vx, vy) (rho, 1/rho, p, ml)
// Bit for bit the plain version, in the input dtype T: the guard
// rho = d > 0 ? d : 1 (NaN, +0 and -0 take 1, as torch.where does), the
// reciprocal 1 / rho by IEEE division (no fast-math in the build, so it is
// correctly rounded, as torch's reciprocal is), then each value rounded to
// f32 to nearest even (__double2float_rn for a double state, as .to(float32)
// rounds).

#include <cuda_runtime.h>

namespace {

constexpr int PACK_THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) { return __double2float_rn(x); }

template <int D, typename T>
__global__ void __launch_bounds__(PACK_THREADS)
pack_fields_kernel(long long n, const T* __restrict__ pos, const T* __restrict__ vel,
                   const T* __restrict__ dens, const T* __restrict__ pres,
                   const T* __restrict__ ml, float4* __restrict__ out) {
    constexpr int Q = D == 3 ? 3 : 2;            // float4s a row
    __shared__ float4 tile[PACK_THREADS * Q];
    const long long r0 = (long long)blockIdx.x * PACK_THREADS;
    const long long r = r0 + threadIdx.x;
    if (r < n) {
        const T d = dens[r];
        const T rho = d > T(0) ? d : T(1);
        const T rcp = T(1) / rho;
        const T* x = pos + r * D;
        const T* v = vel + r * D;
        float4* row = tile + threadIdx.x * Q;
        if constexpr (D == 3) {
            row[0] = make_float4(to_f32(x[0]), to_f32(x[1]), to_f32(x[2]), to_f32(rho));
            row[1] = make_float4(to_f32(v[0]), to_f32(v[1]), to_f32(v[2]), to_f32(rcp));
            row[2] = make_float4(to_f32(pres[r]), to_f32(ml[r]), 0.0f, 0.0f);
        } else {
            row[0] = make_float4(to_f32(x[0]), to_f32(x[1]), to_f32(v[0]), to_f32(v[1]));
            row[1] = make_float4(to_f32(rho), to_f32(rcp), to_f32(pres[r]), to_f32(ml[r]));
        }
    }
    __syncthreads();
    const long long live = (n - r0 < PACK_THREADS ? n - r0 : PACK_THREADS) * Q;
    float4* dst = out + r0 * Q;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
        const int i = k * PACK_THREADS + threadIdx.x;
        if (i < live) dst[i] = tile[i];
    }
}

template <int D, typename T>
cudaError_t launch(long long n, const void* pos, const void* vel, const void* dens,
                   const void* pres, const void* ml, float* out, cudaStream_t st) {
    const long long blocks = (n + PACK_THREADS - 1) / PACK_THREADS;
    pack_fields_kernel<D, T><<<(unsigned)blocks, PACK_THREADS, 0, st>>>(
        n, static_cast<const T*>(pos), static_cast<const T*>(vel),
        static_cast<const T*>(dens), static_cast<const T*>(pres),
        static_cast<const T*>(ml), reinterpret_cast<float4*>(out));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dims 2 or 3; f64 = 1 for double fields, 0 for float; n rows; out holds
// n * 4 * dims floats, 16-byte aligned.  Returns 0, a cudaError_t code, or
// -1 for dims outside (2, 3) or more rows than one grid takes.
int sph_pack_fields(int dims, int f64, long long n, const void* pos, const void* vel,
                    const void* dens, const void* pres, const void* ml, float* out,
                    void* stream) {
    if (dims != 2 && dims != 3) return -1;
    if (n <= 0) return 0;
    if ((n + PACK_THREADS - 1) / PACK_THREADS > 0x7fffffffLL) return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dims == 3)
        err = f64 ? launch<3, double>(n, pos, vel, dens, pres, ml, out, st)
                  : launch<3, float>(n, pos, vel, dens, pres, ml, out, st);
    else
        err = f64 ? launch<2, double>(n, pos, vel, dens, pres, ml, out, st)
                  : launch<2, float>(n, pos, vel, dens, pres, ml, out, st);
    return static_cast<int>(err);
}

const char* sph_pack_error_string(int code) {
    if (code == -1) return "unknown dimension, or too many rows for one grid";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
