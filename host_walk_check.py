#!/usr/bin/env python3
"""Rehearse the sweep kernels' shared walk on the CPU, without a GPU.

    python3 host_walk_check.py [--quick] [--reference DIR]

Compiles ``sphexample_tpu_torch/csrc/block_sweep.cu`` and ``cell_sweep.cu``
for the host with g++: the CUDA built-ins are stubbed below, every thread of a
block is a std::thread, a warp's intrinsics (ballot, shuffle, reductions,
__syncwarp) meet on a std::barrier, blocks run in turn, and the ``<<<...>>>``
launches are rewritten.  The libraries keep their C interfaces and run on CPU
tensors.  Each state (a jittered lattice in every mode set; crowded, blob,
sheet and edge cells; tests/walk_tiles.py's stream states, whose tiles span
stencil rows, end part-full and touch rows of 1-3 candidates; inactive rows
inside the warps; the self windows of 3 slabs) is held: the block kernel against the cell kernel bit for bit, both
against the plain sweep below 1e-4 of each field's max, each window against
the single launch bit for bit, and with ``--reference DIR`` both kernels
against that checkout's bit for bit.  Host arithmetic is not the card's
(g++ fuses no multiply-add here): the bits, the timing and what nvcc accepts
only the card can show.  Exits 1 on the first disagreement.
"""

import ctypes
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import sphexample_tpu_torch as T
from sphexample_tpu_torch.models import equations as eq
from sphexample_tpu_torch.ops import block_sweep as bs
from sphexample_tpu_torch.ops import cell_list as cl
from sphexample_tpu_torch.ops import cell_sweep as cw
from sphexample_tpu_torch.ops import halo as halo_mod
from sphexample_tpu_torch.ops.interactions import PhysicsSpec
from sphexample_tpu_torch.state import allocate_particles

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from walk_tiles import stream_positions  # noqa: E402

CSRC = Path(__file__).resolve().parent / "sphexample_tpu_torch" / "csrc"
DX = 0.05
REL_TOL = 1e-4

HOST_CUDA_H = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline int2 make_int2(int x, int y) { return {x, y}; }
using cudaError_t = int;
using cudaStream_t = void*;
constexpr int cudaSuccess = 0;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
struct Idx { unsigned x = 0, y = 0, z = 0; };
inline thread_local Idx threadIdx, blockIdx;
inline Idx blockDim, gridDim;
struct WarpCtx { std::barrier<> bar{32}; long long vals[32]; };
inline thread_local WarpCtx* tl_warp = nullptr;
inline thread_local int tl_lane = 0;
inline thread_local std::barrier<>* tl_block = nullptr;
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline int __ffs(unsigned v) { return v ? __builtin_ctz(v) + 1 : 0; }
inline int __ffsll(long long v) { return v ? __builtin_ctzll((unsigned long long)v) + 1 : 0; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __popcll(unsigned long long v) { return __builtin_popcountll(v); }
inline void __syncwarp(unsigned = 0xffffffffu) { tl_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { tl_block->arrive_and_wait(); }
template <class F> inline long long warp_all(long long v, F f) {
    tl_warp->vals[tl_lane] = v;
    tl_warp->bar.arrive_and_wait();
    long long r = f(tl_warp->vals);
    tl_warp->bar.arrive_and_wait();
    return r;
}
inline unsigned __ballot_sync(unsigned, int p) {
    return (unsigned)warp_all(p ? 1 : 0, [](long long* v) {
        unsigned r = 0; for (int l = 0; l < 32; ++l) if (v[l]) r |= 1u << l; return (long long)r; });
}
inline int __shfl_sync(unsigned, int v, int src) {
    return (int)warp_all(v, [src](long long* a) { return a[src]; });
}
inline int __shfl_up_sync(unsigned, int v, unsigned d) {
    const int lane = tl_lane;
    return (int)warp_all(v, [lane, d](long long* a) { return a[lane >= (int)d ? lane - d : lane]; });
}
inline int __reduce_add_sync(unsigned, int v) {
    return (int)warp_all(v, [](long long* a) { long long r = 0; for (int l = 0; l < 32; ++l) r += a[l]; return r; });
}
inline int __reduce_min_sync(unsigned, int v) {
    return (int)warp_all(v, [](long long* a) { return *std::min_element(a, a + 32); });
}
inline int __reduce_max_sync(unsigned, int v) {
    return (int)warp_all(v, [](long long* a) { return *std::max_element(a, a + 32); });
}
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host error"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 3; return 0; }
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
    *n = 2; return 0;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
    std::memset(p, v, n); return 0;
}
namespace host {
inline void launch(unsigned grid, unsigned block, const std::function<void()>& fn) {
    blockDim.x = block; gridDim.x = grid;
    for (unsigned b = 0; b < grid; ++b) {
        std::barrier<> bb(block);
        std::vector<std::unique_ptr<WarpCtx>> warps;
        for (unsigned w = 0; w < (block + 31) / 32; ++w) warps.emplace_back(new WarpCtx);
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < block; ++t)
            ts.emplace_back([&, t, b] {
                threadIdx.x = t; blockIdx.x = b; tl_lane = t % 32;
                tl_warp = warps[t / 32].get(); tl_block = &bb;
                fn();
            });
        for (auto& t : ts) t.join();
    }
}
}  // namespace host
"""
LAUNCH = re.compile(r"([A-Za-z_][\w:]*(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),\s*[^,]+,\s*[^>]+>>>"
                    r"\((.*?)\);", re.S)


def build(csrc: Path, out: Path):
    """Host libraries of both sweep sources of ``csrc`` in ``out``."""
    (out / "cuda_runtime.h").write_text("")
    (out / "host_cuda.h").write_text(HOST_CUDA_H)

    def one(name):
        src = LAUNCH.sub(lambda m: f"host::launch({m.group(2)}, {m.group(3)}, [&] "
                                   f"{{ {m.group(1)}({m.group(4)}); }});",
                         (csrc / f"{name}.cu").read_text())
        cpp, lib = out / f"{name}.cpp", out / f"lib{name}.so"
        cpp.write_text(src)
        # -fno-gnu-unique: each library keeps its own function-local statics
        # (the shared memory of walk_shared), also where a reference build
        # with another WalkShared layout is loaded into the same process
        cmd = ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fno-gnu-unique", "-fPIC",
               "-shared", "-pthread", "-include", str(out / "host_cuda.h"), f"-I{out}",
               f"-I{csrc}", "-o", str(lib), str(cpp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"host_walk_check: g++ failed for {csrc / name}.cu:\n{proc.stderr}")
        return ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(2) as ex:
        blk, cel = ex.map(one, ("block_sweep", "cell_sweep"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    blk.sph_block_sweep.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp]
    listed = hasattr(cel, "sph_cell_sweep_list_size")
    cel.sph_cell_sweep.argtypes = [vp, ci, vp, vp, vp, vp] + ([vp] if listed else [])
    if listed:
        cel.sph_cell_sweep_list_size.argtypes = [vp]
    return blk, cel, listed


def run_block(lib, spec, grid, p, cs, f, self_off=0):
    blk = lib[0]
    n = p.capacity
    pack = bs.pack_fields(f["position"], f["velocity"], f["density"], f["pressure"],
                          f["motion_limiter"])
    out = torch.zeros((n, bs.n_sums(spec, grid.dims)), dtype=torch.float32)
    prm = bs.sweep_params(spec, grid, n, self_off)
    act, cell, cs = p.active.to(torch.uint8), p.cell.contiguous(), cs.contiguous()
    err = blk.sph_block_sweep(ctypes.addressof(prm), bs.kernel_variant(spec, grid.dims),
                              pack.data_ptr(), cell.data_ptr(), cs.data_ptr(), act.data_ptr(),
                              out.data_ptr(), None)
    if err:
        raise SystemExit(f"host_walk_check: block sweep returned {err}")
    return torch.where(p.active[:, None], out, torch.zeros_like(out))


def run_cell(lib, spec, grid, p, cs, f, self_off=0):
    cel, listed = lib[1], lib[2]
    n = p.capacity
    pack = bs.pack_fields(f["position"], f["velocity"], f["density"], f["pressure"],
                          f["motion_limiter"])
    out = torch.zeros((n, bs.n_sums(spec, grid.dims)), dtype=torch.float32)
    prm = cw.sweep_params(spec, grid, n, self_off)
    cs = cs.contiguous()
    args = [ctypes.addressof(prm), cw.kernel_variant(spec, grid.dims), pack.data_ptr(),
            cs.data_ptr()]
    if listed:
        groups = torch.empty(cel.sph_cell_sweep_list_size(ctypes.addressof(prm)),
                             dtype=torch.int32)
        args.append(groups.data_ptr())
    err = cel.sph_cell_sweep(*args, out.data_ptr(), None)
    if err:
        raise SystemExit(f"host_walk_check: cell sweep returned {err}")
    return torch.where(p.active[:, None], out, torch.zeros_like(out))


def state(dims, case, family="WENDLAND_C2", pad=23, seed=11):
    """Sorted f64 rows of ``case`` on the CPU, with inactive padding."""
    rng = np.random.default_rng(seed)
    kern = T.make_kernel(T.KernelFamily[family], dims, dx=DX)
    grid = None
    if case == "crowded":
        pos = np.concatenate([(rng.uniform(-0.45, 0.45, size=(150, dims)) + 2.0) * kern.H,
                              (rng.uniform(-1.4, 1.4, size=(250, dims)) + 2.0) * kern.H])
    elif case == "blob":
        pos = rng.uniform(-0.2, 0.2, size=(200, dims)) * kern.H + 3 * kern.H
    elif case == "sheet":
        pos = rng.uniform(0, 1.5, size=(300, dims))
        pos[:, -1] = 0.3 + rng.uniform(-0.01, 0.01, size=300) * DX
    elif case == "edge":
        pos = rng.uniform(-0.3, 0.3, size=(400, dims))
        grid = cl.grid_from_positions(pos, kern.H_inv, margin_cells=0)
        pos[:40] *= 1.5
    elif case in ("spans", "surface"):
        pos = stream_positions(dims, case, kern.H)
    else:
        n = 500 if dims == 3 else 300
        side = int(np.ceil(n ** (1 / dims)))
        pos = np.stack(np.meshgrid(*([np.arange(side) * DX] * dims), indexing="ij"),
                       axis=-1).reshape(-1, dims)[:n]
        pos = pos + rng.uniform(-0.4, 0.4, size=pos.shape) * DX
    n = len(pos)
    const = T.SimulationConstants(dx=DX, cfl=0.5)
    ptype = rng.choice([1, 2, 3], size=n, p=[0.7, 0.2, 0.1]).astype(np.int32)
    p = allocate_particles(pos, rng.uniform(990, 1040, size=n), ptype, np.ones(n, np.int32),
                           np.arange(1, n + 1), device="cpu", dtype=torch.float64,
                           capacity=n + pad)
    vel = np.zeros((n + pad, dims))
    vel[:n] = rng.normal(0, 0.5, size=(n, dims))
    p = p.replace(velocity=torch.as_tensor(vel), pressure=eq.pressure(p.density, const))
    grid = grid or cl.grid_from_positions(pos, kern.H_inv, margin_cells=3)
    sp, cs, _ = cl.rebuild(p, kern.H_inv, grid)
    return const, kern, grid, sp, cs


def spec_of(const, kern, family, visc, diff, extras):
    k = T.make_kernel(T.KernelFamily[family], kern.dims, h=kern.h, k=kern.k)
    return PhysicsSpec(constants=const, kernel=k, viscosity=T.ViscosityModel[visc],
                       diffusion=T.DensityDiffusionModel[diff],
                       shifting=T.ShiftingMode.PLANAR if extras else T.ShiftingMode.NONE,
                       kernel_output=(T.KernelOutputMode.STORE if extras
                                      else T.KernelOutputMode.NONE))


def fields(p):
    return {k: getattr(p, k).float() for k in
            ("position", "velocity", "density", "pressure", "motion_limiter")}


def check_state(libs, dims, case, modes, holes=False):
    const, kern, grid, p, cs = state(dims, case)
    if holes:
        act = p.active.clone()
        act[5::7] = False
        p = p.replace(active=act)
    f = fields(p)
    worst = 0.0
    for mode in modes:
        spec = spec_of(const, kern, *mode)
        outs = {tag: (run_block(lib, spec, grid, p, cs, f), run_cell(lib, spec, grid, p, cs, f))
                for tag, lib in libs.items()}
        blk, cel = outs["this"]
        if not torch.equal(blk, cel):
            raise SystemExit(f"host_walk_check: {dims}D {case} {mode}: block != cell")
        if "reference" in outs and not (torch.equal(blk, outs["reference"][0])
                                        and torch.equal(cel, outs["reference"][1])):
            raise SystemExit(f"host_walk_check: {dims}D {case} {mode}: != the reference")
        ref = bs.block_sweep_plain(spec, grid, p, cs, p.position, p.density, p.pressure,
                                   p.velocity)
        got = bs.collect(blk, p.active, torch.float64, dims, spec)
        for name in ("drhodt", "acceleration", "kernel_w", "kernel_grad", "grad_c", "div_r"):
            a, b = getattr(got, name), getattr(ref, name)
            if b is not None:
                worst = max(worst, float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)))
    if worst >= REL_TOL:
        raise SystemExit(f"host_walk_check: {dims}D {case}: {worst:.2e} of the field max "
                         "off the plain sweep")
    print(f"{dims}D {case}{' with holes' if holes else ''}: {len(modes)} mode sets, block = "
          f"cell{' = reference' if 'reference' in libs else ''} bit for bit, plain within "
          f"{worst:.2e} of the field max", flush=True)


def check_windows(libs, dims, case):
    const, kern, grid, p, cs = state(dims, case, pad=30)
    spec = spec_of(const, kern, "WENDLAND_C2", "LAMINAR_SPS", "COMPLEX", True)
    f = fields(p)
    lib = libs["this"]
    whole = run_block(lib, spec, grid, p, cs, f), run_cell(lib, spec, grid, p, cs, f)
    N = p.capacity
    C = N // 3
    for halo in (2 * C, 0):
        for r in range(3):
            base = r * C
            lo, hi, off = (0, N, base) if halo == 0 else (base - halo, base + C + halo, halo)

            def ext(a):
                zl = a.new_zeros((max(0, -lo),) + tuple(a.shape[1:]))
                zr = a.new_zeros((max(0, hi - N),) + tuple(a.shape[1:]))
                return torch.cat([zl, a[max(lo, 0):min(hi, N)], zr])

            pl = p.map(lambda a: a[base:base + C])
            cse = halo_mod.rebase(cs, lo, hi - lo)
            g = {k: ext(v) for k, v in f.items()}
            for run, w in ((run_block, whole[0]), (run_cell, whole[1])):
                if not torch.equal(run(lib, spec, grid, pl, cse, g, off), w[base:base + C]):
                    raise SystemExit(f"host_walk_check: {dims}D {case}: slab {r} of halo "
                                     f"{halo} differs from the single launch")
    print(f"{dims}D {case}: the windows of 3 slabs bit for bit the single launch", flush=True)


def main(argv):
    reference = None
    if "--reference" in argv:
        reference = Path(argv[argv.index("--reference") + 1]) / "sphexample_tpu_torch" / "csrc"
    quick = "--quick" in argv
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"this": build(CSRC, Path(tmp))}
        if reference:
            (Path(tmp) / "reference").mkdir()
            libs["reference"] = build(reference, Path(tmp) / "reference")
        main_modes = [(f, v, d, False) for f in ("WENDLAND_C2", "CUBIC_SPLINE")
                      for v in ("ZERO", "ARTIFICIAL") for d in ("ZERO", "LINEAR")]
        every = [(f, v, d, True) for f in ("WENDLAND_C2", "CUBIC_SPLINE")
                 for v in ("ZERO", "ARTIFICIAL", "LAMINAR", "LAMINAR_SPS")
                 for d in ("ZERO", "ZERO_GRAVITY_LINEAR", "LINEAR", "COMPLEX")]
        for dims in (2, 3):
            if quick:
                check_state(libs, dims, "lattice", main_modes[:2] + every[:2])
                continue
            for case in ("lattice", "crowded", "blob", "sheet", "edge", "spans", "surface"):
                modes = main_modes + every if case == "lattice" else [main_modes[3], every[13],
                                                                     every[31]]
                check_state(libs, dims, case, modes)
            check_state(libs, dims, "lattice", [main_modes[3], every[13]], holes=True)
            for case in ("lattice", "crowded", "spans", "surface"):
                check_windows(libs, dims, case)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
