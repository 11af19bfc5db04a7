#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device   - the card's name and power limit (no GPU: exit 1, no result);
2. build    - nvcc builds every ``sphexample_tpu_torch/csrc/*.cu``, one
              process per source, all started together, and prints each
              kernel instance's registers, spill and shared-memory bytes;
3. parity   - the block-sweep kernel against its plain PyTorch version on one
              sweep of the 3D dam break (dx 0.0085, fluid velocity (0,0,-1))
              and the 2D dam break (dx 0.01); relative-to-field-max
              differences must stay below 1e-4;
4. run      - the 3D dam break at dx 0.0085 (159,712 particles): 10 warm-up
              steps, then 200 timed steps through ``make_fixed_steps_fn``
              (its chunk graph captured before the timed steps; its capture
              and instantiate seconds, nodes per step and memory printed),
              with the physics checks (finite fields, fluid density within
              2% of rho0, the column falling, fixed walls unmoved) and the
              launch count (exactly 2 per step); every run phase prints a
              SHA-256 of its end state (``end_digest``);
5. breakdown - where a step's time goes: the sweep kernel, the rebuild and
              the rest, timed with CUDA events, and the device busy share
              over a profiled window;
6. parity_after_run - phase 3's comparison on the state the run ends in;
7. parity_mdbc_3d, parity_mdbc_2d - the mDBC moment kernel against its plain
              PyTorch version on the three-layer mDBC dam break (3D at dx
              0.0085: 131,736 ghost-carrying boundary particles + 117,300
              fluid; 2D at dx 0.01), fluid densities perturbed from a seeded
              generator; every moment column must agree below 1e-4 of the
              column's max, and the solve / Shepard / keep decisions and the
              corrected densities are compared with the rows within a hair
              of the |det| threshold counted and printed;
              parity_sweep_mdbc_3d - the block-sweep kernel against its plain
              version on that 3D state as the first sweep of a step sees it
              (pressure from the uncorrected density, then the mDBC correction,
              fluid velocity (0,0,-1));
8. run_mdbc - the 3D mDBC dam break (249,036 particles): 10 warm-up steps,
              then 200 timed steps, with the physics checks of phase 4,
              some boundary density moved off rho0 (the correction fired),
              no grid escapes, and the launch counts (exactly 1 mDBC launch
              and 2 block-sweep launches per step);
9. breakdown_mdbc - phase 5 for the mDBC run, with stage 04 timed as the
              step runs it (compaction + one call of the fused kernel) next
              to the parts it replaced (the moments alone, the solve, the
              decision tree, the unfused stage), each with its device
              launches per call;
10. parity_mdbc_after_run, parity_sweep_mdbc_after_run - phase 7's comparisons
              on the state the run ends in;
              parity_mdbc_fused_3d, parity_mdbc_fused_after_run - the fused
              kernel (moments, Cramer solve and decision tree in one call)
              against the unfused path on the card (the same kernel's
              moments mode, then ops/mdbc.py:_mdbc_apply) on the deck's start
              and end states: the moments it writes bit for bit the moments
              mode's, the corrected densities within 1e-4 (whether bit for
              bit is printed), no decision flipped away from the |det|
              threshold, fill slots parked; and the ghost grouping (groups,
              ghosts per group, staged rows against the candidate rows they
              serve, ops/mdbc_moments.py:ghost_groups);
11. parity_cell_3d, parity_cell_2d (with phase 3) - the cell-sweep kernel
              against its plain version on the states of phase 3 and on stirred
              copies of them (seeded density and velocity noise);
              parity_cell_modes_3d, parity_cell_modes_2d,
              parity_block_modes_3d, parity_block_modes_2d - both sweep
              kernels in every viscosity x density diffusion x kernel family
              with PLANAR shifting and kernel output STORE on the stirred
              states, all six fields below 1e-4 of the field's max against
              the plain version, and the block kernel against the cell kernel
              in the same mode below 1e-4 of the plain field's max (the two
              share csrc/sph_pair_math.cuh; how many modes agree bit for bit
              is printed);
12. run_large - the 3D dam break at dx 0.0034 (2,215,035 particles) through
              ``assemble_simulation`` with its defaults: the capacity rule must
              pick the cell sweep on its own.  10 warm-up + 200 timed steps,
              the physics checks of phase 4, exactly 2 cell-sweep and 0
              block-sweep launches per step, the kernel against its plain
              version before and after the run (parity_cell_large,
              parity_cell_large_after_run);
13. breakdown_large - phase 5 for the large run and, for the record only, the
              block-sweep kernel launched directly on the same end state: its
              time and its parity with the plain version;
14. run_moving_square - a procedural 2D moving-square case (262,276
              particles: a closed box of three fixed wall layers, 2.56 m x
              1.60 m inside at dp 0.004, filled with fluid around a solid
              0.2 m square of MOVING particles translating at 2.8 m/s in +x;
              the constants, kernel and models of examples/moving_square_2d.py:
              Wendland C2 with k = sqrt 2, LAMINAR_SPS, LINEAR, PLANAR, STORE,
              g = 0, f32, ``block_sweep=False``): 10 + 200 steps; the square on
              its prescribed track, walls still, finite fields, the fluid
              density within 1.5 v / c0 = 15 % of rho0 (an impulsively started
              body compresses the fluid ahead of it by about v / c0), a shift
              applied near the body, kernel sums
              positive on the fluid, 2 cell-sweep launches per step, no grid
              escapes, the kernel against its plain version on the end state
              (parity_cell_moving_square_after_run, all six fields);
              run_moving_square_block - the same deck as the example runs it,
              with the meta's default ``block_sweep=True``: the driver's rule
              picks the block sweep (its 2D all-extras instance); the gates of
              run_moving_square with 2 block-sweep launches per step and none
              of the cell sweep, all six fields against the plain version on
              the end state, and the end state within the bands of
              tests/test_trajectory.py:64-70 of the cell-sweep run;
15. kernels - one line, one entry per kernel: launches on the main path that
              runs it, time per call of the wrapper (CUDA events; pack +
              kernel + collect) and of the kernel alone (profiler), the plain
              version's time, the bound.  The block sweep runs on three paths:
              its entry holds the dam-break path's numbers and, under keys
              ending in ``_mdbc_path`` and ``_moving_square_path``, the other
              paths' own (the moving square's bound by the 2D all-extras
              operation count).  The cell sweep's entry holds the large path's
              numbers, the block sweep's time on that same state, and the
              moving-square path's under keys ending in
              ``_moving_square_path``; the sharded entries likewise.  Each
              sweep entry also holds, per path, the schedule of the kernels'
              shared walk on that path's state (``schedule``: groups, warp
              passes, mean member lanes, tiles, union rows over own
              candidates; ops/block_sweep.py:schedule_stats) and the
              registers, spill bytes and shared-memory bytes of every
              instance of its source (``instances``, from the build phase's
              ptxas report); the cell sweep's entry the time of the kernel
              that lists its occupied groups (``list_kernel_only_ms``).

16. the sharded path, P = 4 slabs of the global cell-sorted order on the
              cards visible (slab r on card r mod count; on one card they
              share it, each on its own stream), ranks as threads:
              sharded_rebuild - a state with every fluid position moved by
              less than h, cut into 4 slabs: ``rebuild_sharded`` (local sort +
              1-hop migration) against the single-device ``rebuild``: ``id``,
              ``cell``, ``cell_start`` bitwise, 0 < migration <= halo;
              sharded_parity_block, sharded_parity_cell_3d,
              sharded_parity_cell_2d, sharded_parity_mdbc - per slab, the
              windowed kernel against its plain version on the same
              halo-extended inputs (below 1e-4 of each field's max), the 4
              slabs' outputs concatenated against the single-device kernel on
              the same global state (gate 1e-6 of the field's max; whether
              bitwise is printed), the same through the real halo exchange of
              4 thread ranks, and (block, cell 3D) the ``halo = 0`` window,
              the whole gathered array;
              run_sharded - the main path, the 159,712-particle 3D dam break
              on 4 slabs, 10 + 200 steps: the gates of phase 4, exactly 2
              windowed block-sweep launches per step per slab and none of any
              other sweep, ``0 < max_halo <= halo``, every rank the same
              number of rebuilds, and the gathered end state against the
              single-device run of phase 4 within the trajectory bands of
              tests/test_trajectory.py:64-70;
              run_sharded_mdbc (249,036 particles, block sweep + mDBC on the
              halo), run_sharded_square (262,276 particles, the cell sweep
              on the halo) and run_sharded_square_block (the same deck, the
              block sweep on the halo in all extras; its end state bit for bit
              that of run_moving_square_block) with the gates of their
              single-device phases, sharded_parity_block_square;
              exchange - the bytes one slab sends per sweep and the time of
              one halo exchange.
              The kernel line then holds five entries: block_sweep,
              block_sweep_sharded, cell_sweep, cell_sweep_sharded,
              mdbc_moments (both of its uses: ``ms`` is the fused call of
              stage 04, ``moments_mode_ms`` the moments alone; the grouping,
              the grouping kernels' time, the fused stage's time and device
              launches, the parked slots on the halo).

17. the host loop a user runs, under a temporary directory removed at the end:
              run_simulation_main - the main deck with examples/dam_break_3d.py's
              meta (an output every 0.01 s, the grid-cells file) through
              ``run_simulation`` for 3 output intervals, a checkpoint (and
              VTKHDF where h5py imports) at every counter on the asynchronous
              saver: counters 1-4 saved, 2 block-sweep launches per step, the
              physics gates of phase 4, the end state bit for bit that of the
              same intervals with no save callback and with the saver
              synchronous; ms per step next to the fixed-steps loop's (phase 4,
              and the same steps from the same start), the HourGlass report,
              the save section's share of the wall time;
              checkpoint_resume - the checkpoint of counter 3 resumed into a
              freshly assembled deck and run one interval: the end state of
              run_simulation_main bit for bit;
              regrid - a constructed state: 64 fluid rows moved into a blob
              half a cell below the grid's top edge at +3 m/s; with
              ``auto_retune=False`` the escape raises and the pre-interval state
              keeps its SHA-256; by default the grid grows and the interval
              replays: no escapes left, every live row inside the grown grid, 2
              block-sweep launches per step taken, the kernel against its plain
              version on the end state over the grown grid (parity_after_regrid);
              run_simulation_mdbc - the mDBC deck for one interval with the
              checkpoint saver: 1 fused mDBC call (and its 4 grouping kernels)
              and 2 block-sweep launches per step, the checkpoint loads back
              equal; determinism - ``check_determinism`` (5 steps twice, every
              tensor bit for bit) on the main and the mDBC deck; output - h5py's
              version (or null), and where it imports the VTKHDF of
              run_simulation_main read back: 4 steps equal to the checkpoints
              of the same counters, 3 grid-cells steps (the initial snapshot
              has no cell list yet).

18. the deck CLIs a user runs (``python -m sphexample_tpu_torch.examples.<deck>``,
              called in this process with their log sent to a file), the
              sharded retune and the neighbor list, under a temporary
              directory removed at the end; every record holds the wall
              seconds, the steps taken, ms per step by the wall and by the
              interval loop, and the card's name and power limit:
              examples_main - dam_break_3d at its default dx 0.0085 (159,712
              particles), 3 intervals, a checkpoint per counter: checkpoints
              for counters 1-4 (the initial snapshot's included), the h5py
              line printed where h5py does not import (and no VTKHDF), the
              ParaView state file, exactly 2 block-sweep launches per step,
              the end state bit for bit that of run_simulation_main;
              neighbor_list - ops/neighbor_list.py's list sweep (plain
              PyTorch) against the block-sweep kernel on that end state below
              1e-4 of each field's max, build and sweep ms;
              examples_resume - ``--resume`` from counter 3 for one interval:
              the straight run's end digest;
              examples_shard - ``--shard 4``, one interval: 2 windowed
              block-sweep launches per step per slab, none single-device, the
              end state within the trajectory bands of the single-device CLI
              run's counter-2 checkpoint;
              examples_mdbc - dam_break_2d_mdbc on CSVs written from this
              script's 2D three-layer mDBC dam break (the deck's dx and
              constants): 1 mDBC call (+ 4 grouping kernels) and 2 block-sweep
              launches per step, mDBC fired;
              profile - ``--profile DIR`` over 2 intervals: a Chrome trace
              that names the block-sweep kernel;
              sharded_regrid - phase 17's escaping blob on 4 slabs through
              ``run_simulation``: re-gridded, re-sharded over the same mesh and
              replayed, the pre-interval slabs' SHA-256 unchanged, no escapes
              left, 2 windowed launches per rank step, the end state within
              the trajectory bands of the single-device regrid run (whether
              bit for bit is printed), B2 against its plain version on the
              grown grid (sharded_parity_after_regrid, every slab);
              sharded_halo_retune - the main deck on 4 slabs with the halo cut
              to 128 rows: the first interval overruns it, the driver
              re-shards with at least ``halo_floor`` (the JAX driver's
              ``min_halo``) and the replayed interval completes.

19. the main deck to its end time, under a temporary directory removed at
              the end: native_csv - the main deck written as DualSPHysics CSVs
              (boundary and fluid) and read back, the native reader
              (io/native.py, built with g++ in phase 2: a failed build fails
              there with the compiler's message) against the csv-module path
              bit for bit, each timed, then ``build_simulation`` from the two
              files: both served by the native reader, every tensor of the
              state that of the arrays' assembly (examples_mdbc gates its 3
              CSVs the same way);
              end_time_main - ``python -m sphexample_tpu_torch.examples.
              dam_break_3d`` with its defaults (159,712 particles, an output
              every 0.01 s) from t = 0 to 1.6 s, one checkpoint at the last
              counter, tools/analyze_dambreak.py's readings
              (utils/validation.py:dam_break_readings) at each of the 161
              outputs; gates from the JAX package's record
              (PERFORMANCE.md:36-68): no NaN or non-finite value, 17,846-18,206
              steps, the front at x >= 1.575 first at 0.50-0.70 s, peak |v|max
              before it 2.5-3.1 m/s, |v|max < 2 m/s at the end, fluid density
              in the JAX dam-break test's band (850, 1150) at every output
              (the rows outside the record's [990, 1010] counted), exactly 2
              block-sweep launches per step and no other sweep, fixed walls
              bitwise still, grid escapes re-gridded and replayed (counted),
              the checkpoint the end state; the X(T) series printed as the
              tool prints it (every 10th output, the arrival, the last);
              ``--series FILE`` writes every output's readings there as JSON;
              front_speed_2d, hydrostatic_2d - tests/test_physics_validation.py's
              2D cases through ``run_simulation`` on the card with their sizes
              and gates (front ratio in (0.51, 0.71), printed beside the CPU's;
              deep pressure within 15 % of rho g h), 2 launches per step.

20. the mDBC and moving-body decks to their end times, under a temporary
              directory removed at the end, on the procedural inputs of
              procedural_decks.py (the decks' own CSVs are not in the
              repository), each output read by utils/validation.py:case_readings
              (tools/analyze_case.py's readings and verdict, reduced on the
              card), a table of them printed: end_time_mdbc - the
              duckling_mdbc CLI on the 205,248-row still tank (150,000 fluid,
              55,248 wall rows with ghost nodes, 1.00 x 0.50 m, 0.30 m deep)
              from t = 0 to 1.0 s, 51 outputs: the analyzer's OK at every
              output with --band 950 1100, |v|max <= 0.32 m/s, no NaN or
              non-finite value, exactly 2 block-sweep launches, 1 mDBC call
              and its 4 grouping kernels per step, fixed walls bitwise still,
              no escape left; end_time_square - the moving_square_2d CLI
              with --dp 0.02 on the 129,536-row box (10 x 5 m, a 1 m square at
              2.8 m/s) from t = 0 to 2.5 s, 251 outputs: OK at every output
              with --band 900 1150 --allow-outliers 5 (the JAX package's own
              count on this case; hard band 775-1275) and the body mean
              within 1e-3 m of its track, every moving row
              within 2 steps ulp of its own, exactly 2 block-sweep launches
              per step; both print wall seconds, ms per step by the wall and
              by the interval loop, particle-steps/s, steps and replays;
              coarse_still_tank, coarse_moving_square - compare_case.py's
              coarse cases through the same CLIs, every output's readings
              against the JAX package's readings of the same case on the CPU
              (jax_case_readings.json) within 3 x the port-CPU vs JAX-CPU
              largest difference plus an f32 floor (TOL_FACTOR, TOL_FLOOR),
              and the same verdicts; c1_dam_break - the dam_break_3d CLI at dx 0.03
              to t = 0.7 s (the wall impact), dam_break_readings at every
              output against the JAX package's run of compare_dam_break.py.

21. chunk_graph_main, chunk_graph_mdbc, chunk_graph_moving_square - a chunk
              of steps as one CUDA graph (``core/step.py:make_chunk_body``)
              against the eager loop, a plain Python loop of ``sph_step``
              calls written here: on cells 1, 2 and 4 (the square through the
              cell sweep), from a state whose fluid falls at 1 m/s, 3
              intervals of about 90 steps each (a chunk of 64 and part of
              another; rebuilds inside the chunks) through
              ``make_interval_fn`` and through the eager loop: the same steps
              per interval and the same end digest, 2 sweep launches (+ 1
              mDBC call and 4 grouping kernels) per step, counted where they
              launch and at every replay (``ops/launch_count.py``), one host
              read per chunk with
              ``torch.cuda.set_sync_debug_mode("error")`` on for everything
              else; it prints the capture and instantiate seconds, nodes per
              step, the graph's memory, a state copy's ms, ms per step by the
              wall in turns (eager, graph, graph, eager) and each loop's device
              ms per step and busy share (profiler).  Phases 19-20 run the
              graph too (their CLIs call ``run_simulation``): the main deck
              must take the eager loop's 18,026 steps, the still tank and the
              square end on its digests (``0560d074``, ``043bef15``).

22. chunk_graph_sharded_main, chunk_graph_sharded_mdbc,
              chunk_graph_sharded_moving_square - phase 21's decks and
              intervals on 4 slabs of card 0 (the square through the cell
              sweep, B3s): the sharded interval function, whose chunk of every
              slab's steps is one CUDA graph replay (its capture under
              ``set_sync_debug_mode("error")``), against the ranks' eager
              chunk (``core/step.py:_eager_chunk``, the route of slabs on
              several cards) in turns (eager, graph, graph, eager): the same
              steps per interval and end digest, every rank the same rebuilds,
              2 windowed sweep launches (+ 1 mDBC call and 4 grouping kernels)
              a step a slab counted at the replays, one host read per chunk
              under sync-debug mode; it prints the route, capture and
              instantiate seconds, nodes per step, the graph's memory, wall ms
              per step in turns (every turn on the same digest) and each
              chunk's device ms per step and busy share: the graph's by CUDA
              events around its launches (its slabs' branches overlap, so a
              kernel sum would count time twice), the eager chunk's by the
              profiler over the first interval.

Then the card's name and power limit from nvidia-smi on a line of their own,
and last ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --reference DIR

also runs another checkout DIR (e.g. the parent commit, unpacked with ``git
archive``) in a child process: DIR's own package and chip_smoke.py run phase 8
(its mDBC deck, 10 + 200 steps) with their kernels built into this checkout's
``_build/reference/``, and time DIR's moment call, its moment kernel and its
stage 04 on the end state.  Two such runs alternate with this checkout's
calls (parent, change, change, parent; phase parent_mdbc); the end digests
and the moments on the end state are compared bit for bit.  The kernel
line's ``parent_*`` and ``*_in_turns`` keys hold them ("not measured"
without the option).
"""

import dataclasses
import hashlib
import inspect
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import procedural_decks as pd
import sphexample_tpu_torch as T
from sphexample_tpu_torch.core.step import (_eager_chunk, _initial_dx_acc, _sweep,
                                            make_chunk_loop, make_fixed_steps_fn, sph_step)
from sphexample_tpu_torch.io.casegen import dam_break_2d, dam_break_3d
from sphexample_tpu_torch.io import csv_io, native
from sphexample_tpu_torch.io.checkpoint import (load_checkpoint, resume_simulation,
                                                save_checkpoint)
from sphexample_tpu_torch.models import equations as eq
from sphexample_tpu_torch.ops import _build
from sphexample_tpu_torch.ops import block_sweep as bs
from sphexample_tpu_torch.ops import cell_list as cl
from sphexample_tpu_torch.ops import cell_sweep as cw
from sphexample_tpu_torch.ops import halo as halo_mod
from sphexample_tpu_torch.ops import mdbc
from sphexample_tpu_torch.ops import mdbc_moments as mm
from sphexample_tpu_torch.ops.interactions import candidates
from sphexample_tpu_torch.parallel.context import SINGLE
from sphexample_tpu_torch.parallel.mesh import (make_mesh, make_sharded_fixed_steps_fn,
                                                make_sharded_fn, shard_simulation)
from sphexample_tpu_torch.state import gather_state, split_state, state_tensors
from sphexample_tpu_torch.utils.validation import check_determinism, dam_break_readings

REL_TOL = 1e-4           # kernel vs plain, relative to the field's max
SLAB_TOL = 1e-6          # 4 slabs concatenated vs the single-device kernel
WARM_STEPS, STEPS = 10, 200
N_SLABS = 4              # the sharded phases
# the large-capacity path: io/casegen.py:dam_break_3d at this spacing has this
# many particles, past the block sweep's capacity limit of 2^21 rows
LARGE_DX, LARGE_N = 0.0034, 2215035
# f32 operations per candidate and per pair of the 3D Wendland / ARTIFICIAL
# / LINEAR instance of csrc/block_sweep.cu, counted from its source: a
# candidate costs the difference, squared distance and cutoff compare; an
# accepted pair the kernel gradient, continuity, LINEAR diffusion, pressure
# term and accumulation; an approaching pair (v.x < 0) the viscosity term.
OPS_CANDIDATE, OPS_PAIR, OPS_APPROACH = 9, 45, 9
# the same for the 2D all-extras instance of csrc/cell_sweep.cu with Wendland,
# LAMINAR_SPS and LINEAR (the moving-square model set), counted from its
# source: a candidate 6 (difference, squared distance, compare); an accepted
# pair 16 (distance, q, gradient factor, v_ij, v.x, x.gradW, limiter product)
# + 4 continuity + 13 LINEAR diffusion + 9 pressure term and accumulation + 9
# laminar term + 75 sub-particle-scale stress (13 for dv, gradW and their
# products, 2 x 28 for the two tau . gradW, 6 to scale and add) + 11 STORE +
# 10 PLANAR; no artificial term
OPS_2D_ALL_EXTRAS = (6, 147, 0)
# the same for the 3D Wendland instance of csrc/mdbc_moments.cu: a candidate
# costs the difference, squared distance and the cutoff and fluid compares; an
# accepted pair the density guard and the volume (2), the distance, q, kernel
# value (8) and gradient (4 + 3) and the 4 x (1 + 1 + 1 + 3 x 2) sums of b and A
MDBC_OPS_CANDIDATE, MDBC_OPS_PAIR = 10, 56
# and the fused epilogue per ghost, counted from the source: in 3D five 4x4
# determinants (4 x 14 + 7 each), 4 quotients for the solution, the gradient
# term (3 differences, 3 products, 3 sums), the Shepard quotient and 3
# compares; in 2D four 3x3 determinants, 3 quotients, 2 + 2 + 2, 1, 3
MDBC_OPS_SOLVE = {2: 69, 3: 332}
# the fused call's grouping kernels (csrc/mdbc_moments.cu steps 1-3)
GROUP_KERNELS = ("mdbc_wet_group", "mdbc_keys_group", "mdbc_cells_group", "mdbc_order_group")
# rows whose |det| lies within this share of the 1e-3 threshold may take the
# other branch in the kernel's summation order: counted, not compared
NEAR_DET = 0.05
RHO_TOL = 1e-4           # corrected densities, kernel vs plain moments (f32)
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def reset_counts():
    """Every launch count to 0 (before a path is driven)."""
    bs.launches = cw.launches = bs.window_launches = cw.window_launches = 0
    mm.launches = mm.group_launches = 0


def case_3d(dx=0.0085):
    """The main path: bench.py's 3D dam break (reference Dambreak3d.jl)."""
    const = T.SimulationConstants(dx=dx, c0=33.14, alpha=0.1, m0=1000 * dx**3, cfl=0.2)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 3, h=float(np.sqrt(3 * dx**2)))
    meta = T.SimulationMetaData(simulation_name="chip_smoke_3d",
                                save_location="out", dims=3)
    return dam_break_3d(dx), meta, const, kern


def case_2d(dx=0.01):
    """bench.py's 2D dam break (reference Dambreak2dMDBC.jl constants)."""
    const = T.SimulationConstants(dx=dx, c0=88.14487860902641, cfl=0.5, alpha=0.01)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=dx)
    meta = T.SimulationMetaData(simulation_name="chip_smoke_2d",
                                save_location="out", dims=2)
    return dam_break_2d(dx), meta, const, kern


def mdbc_dam_break(case):
    """The three-layer mDBC dam break of ``case`` (3D or 2D): the fluid block
    and tank extents of the dam break, its single wall layer replaced by
    three lattice layers (the original one and two further out: floor and
    sides, open top).  The boundary interface planes lie dx/2 inside the
    innermost layer; a boundary particle's ghost point is its reflection
    about every interface plane it lies beyond (edge and corner particles
    reflect in 2 or 3 axes) and its normal is ghost - position.  Boundary
    particles come first, with IDs from 1.  Returns (arrays, ghost_points,
    ghost_normals, meta, const, kern)."""
    (pos, _, ptype, _, _), meta, const, kern = case
    dims, dx = meta.dims, const.dx
    extents = (1.60, 0.67, 0.45) if dims == 3 else (1.60, 0.45)
    counts = [int(round(L / dx)) for L in extents]
    # lattice indices: two extra layers on every side but the open top
    axes = [np.arange(-2, n + 2) for n in counts[:-1]] + [np.arange(-2, counts[-1])]
    idx = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, dims)
    hi = np.array([n - 2 for n in counts[:-1]] + [np.iinfo(np.int64).max])
    wall = np.any((idx < 1) | (idx > hi), axis=-1)
    walls = (idx[wall] + 0.5) * dx
    # reflect about the interface planes x = dx and x = (n - 1) dx
    top = np.array([(n - 1) * dx for n in counts[:-1]] + [np.inf])
    ghost = np.where(walls < dx, 2 * dx - walls, walls)
    ghost = np.where(walls > top, 2 * top - walls, ghost)
    fluid = pos[ptype == int(T.ParticleType.FLUID)]
    nb, nf = len(walls), len(fluid)
    arrays = (
        np.concatenate([walls, fluid]),
        np.full(nb + nf, 1000.0),
        np.concatenate([np.full(nb, int(T.ParticleType.FIXED)),
                        np.full(nf, int(T.ParticleType.FLUID))]).astype(np.int32),
        np.concatenate([np.full(nb, 1), np.full(nf, 2)]).astype(np.int32),
        np.arange(1, nb + nf + 1),
    )
    meta = T.replace(meta, simulation_name=meta.simulation_name + "_mdbc",
                     mdbc=T.MDBCMode.SIMPLE)
    return arrays, ghost, ghost - walls, meta, const, kern


SQUARE_SPEED = 2.8       # m/s in +x (examples/moving_square_2d.py:54-56)


def moving_square_case(dp=0.004, nx=640, nz=400, wall_layers=3,
                       square=(100, 150, 175, 225), block_sweep=True):
    """A procedural MovingSquare case (the deck's input CSVs are not in the
    repository): a closed box of ``wall_layers`` fixed lattice layers around
    ``nx`` x ``nz`` interior lattice sites at spacing ``dp``, filled with
    fluid except for a solid square of MOVING particles (interior site
    indices ``square`` = x0, x1, z0, z1) that translates at 2.8 m/s in +x.
    Constants, kernel and modes of examples/moving_square_2d.py:39-41, 59-73;
    ``block_sweep`` the meta's own default (True), as the example runs it.
    Group markers as in the deck (1 fixed, 2 fluid, 3 square); IDs from 1,
    square first.  Lattice sites sit at (i + 0.5) dp, a quarter of a cell
    off the nearest cell boundary (the cell pitch is 2 dp).  Returns (arrays, geometries, meta,
    const, kern, viscosity, diffusion)."""
    const = T.SimulationConstants(dx=dp, c0=28.0, delta_sph=0.1, g=0.0, Cb=112000.0,
                                  alpha=1e-6, cfl=0.2)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=dp, k=float(np.sqrt(2)))
    w = wall_layers
    ix, iz = np.meshgrid(np.arange(-w, nx + w), np.arange(-w, nz + w), indexing="ij")
    ix, iz = ix.ravel(), iz.ravel()
    wall = (ix < 0) | (ix >= nx) | (iz < 0) | (iz >= nz)
    x0, x1, z0, z1 = square
    body = (ix >= x0) & (ix < x1) & (iz >= z0) & (iz < z1)
    ptype = np.where(wall, int(T.ParticleType.FIXED),
                     np.where(body, int(T.ParticleType.MOVING),
                              int(T.ParticleType.FLUID))).astype(np.int32)
    order = np.argsort(-ptype, kind="stable")       # square, walls, fluid
    ptype = ptype[order]
    pos = (np.stack([ix, iz], axis=-1)[order] + 0.5) * dp
    marker = np.select([ptype == int(T.ParticleType.FIXED),
                        ptype == int(T.ParticleType.FLUID)], [1, 2], 3).astype(np.int32)
    n = len(pos)
    arrays = (pos, np.full(n, const.rho0), ptype, marker, np.arange(1, n + 1))
    geometries = (
        T.Geometry("", 1, T.ParticleType.FIXED),
        T.Geometry("", 2, T.ParticleType.FLUID),
        T.Geometry("", 3, T.ParticleType.MOVING,
                   T.MotionDetails(velocity=SQUARE_SPEED, start_time=0.0, duration=3.0,
                                   direction=(1.0, 0.0))),
    )
    meta = T.SimulationMetaData(
        simulation_name="chip_smoke_moving_square", save_location="out", dims=2,
        shifting=T.ShiftingMode.PLANAR, kernel_output=T.KernelOutputMode.STORE,
        block_sweep=block_sweep)
    return (arrays, geometries, meta, const, kern, T.ViscosityModel.LAMINAR_SPS,
            T.DensityDiffusionModel.LINEAR)


def assemble_moving_square(case, device="cuda"):
    (pos, dens, ptype, grp, idp), geometries, meta, const, kern, visc, diff = case
    return T.assemble_simulation(pos, dens, ptype, grp, idp, meta, const, kern,
                                 visc, diff, geometries=geometries, device=device)


def moving_square_checks(sim, case, state, sweep_out, label, total_steps):
    """The moving-square gates beyond ``run_phase``'s: the square on its
    prescribed track, a shift applied near the body, kernel sums positive on
    the fluid."""
    pos0, ptype0 = case[0][0], case[0][2]
    p = state.particles
    order = torch.argsort(p.id)               # IDs are 1..n in input order
    order = order[p.id[order] > 0]            # padding rows (a sharded run's) out
    x_now = p.position[order][:, 0].double().cpu().numpy()
    body = ptype0 == int(T.ParticleType.MOVING)
    t = float(state.total_time)
    track_err = float(np.abs(x_now[body] - (pos0[body, 0] + SQUARE_SPEED * t)).max())
    # each of the 2 advances of a step rounds the f32 position by at most
    # half a unit in the last place; twice that as the band
    track_tol = 2 * total_steps * float(np.spacing(np.float32(x_now[body].max())))
    # the stage-11 shift of this state's own sweep (core/step.py): A = 2,
    # A_FSM = D, zero where the free-surface scaling is negative
    h = sim.cfg.spec.kernel.h
    a_fsc = sweep_out.div_r / float(p.dims)
    vmag = p.velocity.norm(dim=-1)
    shift = (a_fsc.clamp(min=0) * 2.0 * h * vmag * state.current_dt
             * sweep_out.grad_c.norm(dim=-1) * p.motion_limiter)
    fluid = p.ptype == int(T.ParticleType.FLUID)
    near = fluid & (sweep_out.grad_c.norm(dim=-1) > 0)
    res = {
        "phase": label + "_checks", "square_rows": int(body.sum()),
        "square_displacement_m": SQUARE_SPEED * t, "track_max_err_m": track_err,
        "track_tol_m": track_tol, "fluid_rows_with_grad_c": int(near.sum()),
        "grad_c_max": float(sweep_out.grad_c.norm(dim=-1)[fluid].max()),
        "shift_max_m": float(shift.max()), "rows_shifted": int((shift > 0).sum()),
        "fluid_kernel_w_min": float(p.kernel_w[fluid].min()),
        "fluid_kernel_w_max": float(p.kernel_w[fluid].max()),
    }
    res["ok"] = (track_err <= track_tol and res["shift_max_m"] > 0
                 and res["fluid_kernel_w_min"] > 0)
    emit(res)
    if not res["ok"]:
        fail(f"{label}: square off its track, no shift applied, or kernel sums not positive")
    return res


def ptxas_report(log):
    """Registers, spill-store bytes and static shared-memory bytes of every
    kernel instance in nvcc's ``-Xptxas -v`` output, keyed by the kernel's
    name and template arguments (``block_sweep_kernel<3,0,1,2,0,0,0>``:
    dims, family, viscosity, diffusion - -1 for a run-time choice - then SPS,
    STORE, PLANAR; ``mdbc_moments_kernel<3,0,f>``: dims, family, f32 or f64
    state; a kernel without template arguments by its name)."""
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"([a-z][a-z_]*_kernel)(?:I((?:L[ib]n?\d+E|[fd])+)E)?",
                          m.group(1))
            args = re.findall(r"L[ib](n?)(\d+)E|([fd])", k.group(2) or "") if k else []
            name = (k.group(1) + (f"<{','.join(t or ('-' if neg else '') + v for neg, v, t in args)}>"
                                  if args else "") if k else m.group(1))
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            out[name] = [int(m.group(1)), spill, int(smem.group(1)) if smem else 0]
            name = None
    return out


def instances(report, kernel):
    """The ptxas numbers of one kernel's instances: {instance: {registers,
    spill_bytes, smem_bytes}}."""
    return {k: dict(zip(("registers", "spill_bytes", "smem_bytes"), v))
            for k, v in report.items() if k == kernel or k.startswith(kernel + "<")}


def schedule(sim, p, cs, mod=bs, lo=0, hi=None, sample=300, queue=None):
    """The walk's schedule of this state's sweep (ops/block_sweep.py:
    schedule_stats): groups, warp passes, mean member lanes, tiles, and the
    union rows a lane tests over its own candidates; with ``lo`` / ``hi``
    that of the selves [lo, hi) launched on the whole state as a window.
    ``bodies``: the pair bodies per pass of ``sample`` seeded passes by how
    the compute is batched (ops/block_sweep.py:pass_bodies), divided by the
    passes, and the share of their tiles that take the cooperative path."""
    grid = sim.cfg.grid
    hi = p.capacity if hi is None else hi
    sched = (bs.block_schedule(grid, p.map(lambda a: a[lo:hi]), cs) if mod is bs
             else cw.cell_schedule(grid, cs, hi - lo, lo))
    stats = bs.schedule_stats(sched, grid, cs)
    n_pass = stats["warp_passes"]
    pick = torch.randperm(n_pass, generator=torch.Generator().manual_seed(0))[:sample]
    bodies = bs.pass_bodies(sched, grid, cs, p.position, sim.cfg.spec.kernel.H2,
                            pick.to(cs.device), lo,
                            queue=queue or bs.walk_queue(bs.n_sums(sim.cfg.spec, grid.dims)))
    stats["bodies"] = {k: v if k == "cooperative_tiles" else v / bodies["passes"]
                       for k, v in bodies.items() if k != "passes"}
    stats["bodies"]["sampled_passes"] = bodies["passes"]
    return stats


def device_events(fn, reps=5):
    """The device events (kernels, copies, fills) of ``reps`` calls of
    ``fn`` under the profiler, after one call outside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def kernel_only_ms(fn, name, reps=5, per_call=False):
    """Device time of the kernel ``name`` (or of the kernels of a tuple of
    names) alone (profiler, device events only) over ``reps`` calls of
    ``fn``: per launch, or with ``per_call`` per call of ``fn``; "not
    measured" without device events."""
    names = (name,) if isinstance(name, str) else name
    mine = [e for e in device_events(fn, reps) if any(f"{n}_kernel" in e.key for n in names)]
    count = sum(e.count for e in mine)
    if not count:
        return "not measured"
    return sum(e.self_device_time_total for e in mine) / 1e3 / (reps if per_call else count)


def launches_per_call(fn, reps=5):
    """(device launches, device ms) per call of ``fn`` (profiler)."""
    ev = device_events(fn, reps)
    if not ev:
        return "not measured", "not measured"
    return (sum(e.count for e in ev) / reps,
            sum(e.self_device_time_total for e in ev) / 1e3 / reps)


def assemble(case):
    (pos, dens, ptype, grp, idp), meta, const, kern = case
    return T.assemble_simulation(pos, dens, ptype, grp, idp, meta, const, kern,
                                 T.ViscosityModel.ARTIFICIAL,
                                 T.DensityDiffusionModel.LINEAR, device="cuda")


def assemble_mdbc(case):
    (pos, dens, ptype, grp, idp), ghost, normals, meta, const, kern = mdbc_dam_break(case)
    return T.assemble_simulation(pos, dens, ptype, grp, idp, meta, const, kern,
                                 T.ViscosityModel.ARTIFICIAL,
                                 T.DensityDiffusionModel.LINEAR, device="cuda",
                                 ghost_points=ghost, ghost_normals=normals)


def falling_state(sim):
    """Rebuilt cell list, fluid velocity pointing down (bench.py:96-100),
    so that the viscous terms are live."""
    p, cs, _ = cl.rebuild(sim.state.particles, sim.cfg.spec.kernel.H_inv, sim.cfg.grid)
    down = torch.zeros(p.dims, dtype=p.position.dtype, device=p.device)
    down[-1] = -1.0
    return p.replace(velocity=down * p.motion_limiter[:, None]), cs


def perturbed_state(sim, seed=0):
    """Rebuilt cell list, fluid densities within +-1% of rho0 from a seeded
    generator, so that the moment systems are not degenerate."""
    p, cs, _ = cl.rebuild(sim.state.particles, sim.cfg.spec.kernel.H_inv, sim.cfg.grid)
    noise = np.random.default_rng(seed).uniform(-0.01, 0.01, size=p.capacity)
    noise = torch.as_tensor(noise, dtype=p.density.dtype).to(p.device)
    return p.replace(density=p.density * (1 + noise * p.motion_limiter)), cs


def first_sweep_state(sim, p, cs):
    """``p`` as the first sweep of an mDBC step sees it: pressure from the
    uncorrected density, then the stage-04 density correction; fluid velocity
    pointing down so that the viscous terms are live."""
    p = p.replace(pressure=eq.pressure(p.density, sim.cfg.spec.constants))
    p = p.replace(density=mdbc.mdbc_density_correction(
        sim.cfg.spec, sim.cfg.grid, p, cs, sim.cfg.boundary_capacity))
    down = torch.zeros(p.dims, dtype=p.position.dtype, device=p.device)
    down[-1] = -1.0
    return p.replace(velocity=down * p.motion_limiter[:, None])


SWEEP_FIELDS = (("drhodt", "drhodt"), ("acc", "acceleration"), ("kernel_w", "kernel_w"),
                ("kernel_grad", "kernel_grad"), ("grad_c", "grad_c"), ("div_r", "div_r"))


def sweep_diff(k, ref, label, scale=None):
    """Largest difference of every field the mode set has, absolute and
    relative to the field's max in ``ref`` (or in ``scale``); fails on a
    non-finite value."""
    res = {}
    for name, field in SWEEP_FIELDS:
        a, b = getattr(k, field), getattr(ref, field)
        if (a is None) != (b is None):
            fail(f"{label}: {field} present in one version only")
        if a is None:
            continue
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"{label}: non-finite {name}")
        d = float((a - b).abs().max())
        res[f"{name}_max_abs"] = d
        top = b if scale is None else getattr(scale, field)
        res[f"{name}_rel"] = d / max(float(top.abs().max()), 1e-30)
    return res


def compare(sim, p, cs, label, mod=bs):
    """A sweep kernel (``mod``: the block or the cell sweep) against its plain
    version on the same inputs.  Returns the record and the kernel's output."""
    args = (sim.cfg.spec, sim.cfg.grid, p, cs, p.position, p.density,
            p.pressure, p.velocity)
    sweep, plain = ((bs.block_sweep, bs.block_sweep_plain) if mod is bs
                    else (cw.cell_sweep, cw.cell_sweep_plain))
    k = sweep(*args)
    ref = plain(*args, block_size=4096)
    torch.cuda.synchronize()
    res = {"phase": label, "n": int(p.active.sum()), **sweep_diff(k, ref, label)}
    res["max_rel"] = max(v for key, v in res.items() if key.endswith("_rel"))
    res["max_abs"] = max(v for key, v in res.items() if key.endswith("_max_abs"))
    res["ok"] = res["max_rel"] < REL_TOL
    emit(res)
    if not res["ok"]:
        fail(f"{label}: kernel and plain version disagree")
    return res, k


def stirred_state(sim, seed=1):
    """Rebuilt cell list, fluid densities within +-1% of rho0 and fluid
    velocities of ~0.5 m/s in every direction from a seeded generator, the
    pressure from that density: every term of every model is live."""
    p, cs = perturbed_state(sim, seed)
    rng = np.random.default_rng(seed + 1000)
    vel = torch.as_tensor(rng.normal(0, 0.5, size=tuple(p.velocity.shape)),
                          dtype=p.velocity.dtype).to(p.device)
    return p.replace(velocity=vel * p.motion_limiter[:, None],
                     pressure=eq.pressure(p.density, sim.cfg.spec.constants)), cs


def compare_modes(sim, p, cs, label_cell, label_block):
    """Both sweep kernels against their plain version for every viscosity x
    density diffusion x kernel family, PLANAR shifting and kernel output STORE
    on: all six fields of all 32 mode sets, the plain version run once per
    mode; and the block kernel against the cell kernel in the same mode (the
    two share their pair physics).  Emits one line per kernel."""
    spec0 = sim.cfg.spec
    kern = spec0.kernel
    args = (sim.cfg.grid, p, cs, p.position, p.density, p.pressure, p.velocity)
    worst = {"cell": (0.0, None), "block": (0.0, None), "pair": (0.0, None)}
    per_mode = {"cell": {}, "block": {}, "pair": {}}
    bitwise = 0
    for family in T.KernelFamily:
        fam_kern = T.make_kernel(family, kern.dims, h=kern.h, k=kern.k)
        for visc in T.ViscosityModel:
            for diff in T.DensityDiffusionModel:
                spec = dataclasses.replace(
                    spec0, kernel=fam_kern, viscosity=visc, diffusion=diff,
                    shifting=T.ShiftingMode.PLANAR,
                    kernel_output=T.KernelOutputMode.STORE)
                mode = f"{family.name}/{visc.name}/{diff.name}"
                ref = bs.block_sweep_plain(spec, *args, block_size=4096)
                outs = {"cell": cw.cell_sweep(spec, *args), "block": bs.block_sweep(spec, *args)}
                torch.cuda.synchronize()
                diffs = {name: sweep_diff(o, ref, f"{name}:{mode}") for name, o in outs.items()}
                # the two kernels' difference relative to the plain field's max
                pair = sweep_diff(outs["block"], outs["cell"], f"block-cell:{mode}",
                                  scale=ref)
                for name, d in diffs.items():
                    if sum(k.endswith("_rel") for k in d) != len(SWEEP_FIELDS):
                        fail(f"{name}:{mode}: not all six fields compared")
                    per_mode[name][mode] = max(v for k, v in d.items() if k.endswith("_rel"))
                per_mode["pair"][mode] = max(v for k, v in pair.items() if k.endswith("_rel"))
                bitwise += all(v == 0.0 for k, v in pair.items() if k.endswith("_max_abs"))
                for name in worst:
                    if per_mode[name][mode] >= worst[name][0]:
                        worst[name] = (per_mode[name][mode], mode)
    n = int(p.active.sum())
    cell = {"phase": label_cell, "n": n, "modes": len(per_mode["cell"]),
            "fields": len(SWEEP_FIELDS), "max_rel": worst["cell"][0],
            "worst_mode": worst["cell"][1], "max_rel_per_mode": per_mode["cell"],
            "ok": worst["cell"][0] < REL_TOL}
    block = {"phase": label_block, "n": n, "modes": len(per_mode["block"]),
             "fields": len(SWEEP_FIELDS), "max_rel": worst["block"][0],
             "worst_mode": worst["block"][1], "max_rel_per_mode": per_mode["block"],
             "vs_cell_kernel_max_rel": worst["pair"][0],
             "vs_cell_kernel_worst_mode": worst["pair"][1],
             "modes_bitwise_equal_to_cell_kernel": bitwise,
             "ok": worst["block"][0] < REL_TOL and worst["pair"][0] < REL_TOL}
    emit(cell)
    emit(block)
    return cell, block


def moment_args(sim, p, cs):
    """The moment wrapper's arguments on this state, as stage 04 makes them."""
    bidx, bvalid = mdbc.compact_ghosts(p, sim.cfg.boundary_capacity)
    return bidx, (sim.cfg.spec, sim.cfg.grid, p.ghost_points[bidx], bvalid,
                  p.position, p.density, p.motion_limiter, cs)


def compare_mdbc(sim, p, cs, label):
    """The moment kernel against its plain version on the same inputs: every
    moment column relative to its max; then both sets of moments through the
    solve and the decision tree."""
    bidx, args = moment_args(sim, p, cs)
    gpoint, bvalid = args[2], args[3]
    B = gpoint.shape[0]
    bk, Ak = mm.mdbc_moments(*args)
    bp, Ap = mm.mdbc_moments_plain(*args)
    torch.cuda.synchronize()
    k = torch.cat([bk, Ak.reshape(B, -1)], dim=1)
    ref = torch.cat([bp, Ap.reshape(B, -1)], dim=1)
    if not (torch.isfinite(k).all() and torch.isfinite(ref).all()):
        fail(f"{label}: non-finite moments")
    col_max = ref.abs().amax(dim=0)
    col_err = (k - ref).abs().amax(dim=0)
    col_rel = col_err / col_max.clamp(min=1e-30)
    rho_k, dec_k = mdbc._mdbc_apply(sim.cfg.spec, p, bidx, bvalid, gpoint, bk, Ak)
    rho_p, dec_p = mdbc._mdbc_apply(sim.cfg.spec, p, bidx, bvalid, gpoint, bp, Ap)
    det = mdbc._det_solve(Ap, bp)[0].abs()
    # near a threshold: |det| within NEAR_DET of 1e-3, or (below it) an A00
    # that is zero in one version and a vanishing W > 0 in the other - a
    # single neighbour on the rim of the support, where the two versions'
    # roundings of d2 may decide the cutoff differently
    a00p, a00k = Ap[:, 0, 0], Ak[:, 0, 0]
    rim = 1e-6 * a00p.max()
    near = ((det - mdbc.DET_THRESHOLD).abs() <= NEAR_DET * mdbc.DET_THRESHOLD) | (
        (det < mdbc.DET_THRESHOLD) & ((a00p > 0) != (a00k > 0))
        & (a00p <= rim) & (a00k <= rim))
    flipped = (dec_k != dec_p) & bvalid
    excluded = (near | flipped) & bvalid
    held = bvalid & ~excluded
    a, b = rho_k[bidx][held], rho_p[bidx][held]
    rho_rel = float(((a - b).abs() / b.abs()).max()) if a.numel() else 0.0
    res = {
        "phase": label, "ghost_slots": B, "valid_ghosts": int(bvalid.sum()),
        "ghosts_with_fluid_neighbour": int(((bp[:, 0] > 0) & bvalid).sum()),
        "decisions_plain": {name: int(((dec_p == v) & bvalid).sum())
                            for name, v in (("solve", 2), ("shepard", 1), ("keep", 0))},
        "decisions_kernel": {name: int(((dec_k == v) & bvalid).sum())
                             for name, v in (("solve", 2), ("shepard", 1), ("keep", 0))},
        "moment_max_abs": float(col_err.max()), "moment_max_rel": float(col_rel.max()),
        "moment_col_rel": [float(v) for v in col_rel],
        "rho_max_rel": rho_rel, "rows_near_threshold_excluded": int(excluded.sum()),
        "decision_flips": int(flipped.sum()),
        "decision_flips_far_from_threshold": int((flipped & ~near).sum()),
    }
    res["ok"] = (res["moment_max_rel"] < REL_TOL and rho_rel < RHO_TOL
                 and res["decision_flips_far_from_threshold"] == 0
                 and res["ghosts_with_fluid_neighbour"] > 0
                 and bool(torch.isfinite(rho_k).all()))
    emit(res)
    if not res["ok"]:
        fail(f"{label}: moment kernel and plain version disagree")
    return res


def fill_slots(bidx):
    """Slots of the compacted list past the ghost count (b > 0 at row 0)."""
    return (torch.arange(bidx.shape[0], device=bidx.device) > 0) & (bidx == 0)


def compare_fused(sim, p, cs, label):
    """The fused kernel (stage 04 in one call) against the unfused path on the
    card - the same kernel's moments mode, then ``_mdbc_apply`` - on the same
    state: moments bit for bit on every slot that computes (zeros on parked
    ones), corrected densities within RHO_TOL (bit for bit is printed),
    decisions equal away from the |det| threshold; and the grouping."""
    spec, grid, B = sim.cfg.spec, sim.cfg.grid, sim.cfg.boundary_capacity
    bidx, args = moment_args(sim, p, cs)
    gpoint, bvalid = args[2], args[3]
    rho_f, dec_f, mom_f = mm.mdbc_correct(spec, grid, p, bidx, bvalid, p.position, p.density,
                                          p.motion_limiter, cs, moments=True)
    bk, Ak = mm.mdbc_moments(*args)
    rho_u, dec_u = mdbc._mdbc_apply(spec, p, bidx, bvalid, gpoint, bk, Ak)
    torch.cuda.synchronize()
    live = bvalid & ~fill_slots(bidx)
    mom_u = torch.cat([bk, Ak.reshape(B, -1)], dim=1).float()
    moments_bitwise = bool(torch.equal(mom_f[live], mom_u[live]) and not mom_f[~live].any())
    det = mdbc._det_solve(Ak, bk)[0].abs()
    near = (det - mdbc.DET_THRESHOLD).abs() <= NEAR_DET * mdbc.DET_THRESHOLD
    flips = (dec_f != dec_u) & live
    rows = bidx[live & ~near]
    rel = ((rho_f[rows] - rho_u[rows]).abs() / rho_u[rows].abs())
    stats = mm.schedule_stats(mm.ghost_groups(spec, grid, gpoint, bvalid, bidx=bidx,
                                              cell_start=cs, motion_limiter=p.motion_limiter))
    res = {"phase": label, "ghost_slots": B, "computing_slots": int(live.sum()),
           "moments_vs_moments_mode_bitwise": moments_bitwise,
           "rho_bitwise": bool(torch.equal(rho_f, rho_u)),
           "rho_max_abs": float((rho_f - rho_u).abs().max()),
           "rho_max_rel_away_from_threshold": float(rel.max()) if rel.numel() else 0.0,
           "rows_differing": int((rho_f != rho_u).sum()),
           "decision_flips": int(flips.sum()),
           "decision_flips_far_from_threshold": int((flips & ~near).sum()),
           "fill_slot_decisions_nonzero": int(dec_f[~live].ne(0).sum()),
           **stats}
    res["ok"] = (moments_bitwise and res["rho_max_rel_away_from_threshold"] < RHO_TOL
                 and res["decision_flips_far_from_threshold"] == 0
                 and res["fill_slot_decisions_nonzero"] == 0
                 and bool(torch.isfinite(rho_f).all()))
    emit(res)
    if not res["ok"]:
        fail(f"{label}: the fused kernel disagrees with the unfused path")
    return res


def time_cuda(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def sweep_work(sim, p, cs, reads_cell=True, lo=0, hi=None,
               op_costs=None):
    """Candidates, pairs in support and approaching pairs of this state's
    sweep (what the kernel really evaluates), and the bytes it must move;
    with ``lo`` / ``hi`` the work of the selves [lo, hi) alone (a slab's)."""
    kern = sim.cfg.spec.kernel
    starts, ends = cl.row_segments(p.cell, sim.cfg.grid, cs)
    act = p.active
    hi = p.capacity if hi is None else hi
    n_cand = n_pair = n_appr = 0
    for b0 in range(lo, hi, 8192):
        i, j = candidates(starts, ends, b0, min(b0 + 8192, hi))
        live = act[i]
        i, j = i[live], j[live]
        xij = p.position[i] - p.position[j]
        d2 = (xij * xij).sum(-1)
        keep = (d2 <= kern.H2) & (i != j)
        vdotx = ((p.velocity[i] - p.velocity[j]) * xij).sum(-1)
        n_cand += int(i.numel())
        n_pair += int(keep.sum())
        n_appr += int((keep & (vdotx < 0)).sum())
    n, d = p.position.shape
    # inputs read once (position, velocity, density, pressure, motion
    # limiter, active, cell_start; the block sweep reads the cell coordinates
    # too) + the [N, K] f32 output (K = 1+D without STORE and PLANAR)
    k_out = bs.n_sums(sim.cfg.spec, d)
    nbytes = (n * (2 * d + 3) * p.position.element_size() + n
              + (n * d * 4 if reads_cell else 0) + cs.numel() * 4 + n * k_out * 4)
    c_cand, c_pair, c_appr = op_costs or (OPS_CANDIDATE, OPS_PAIR, OPS_APPROACH)
    ops = c_cand * n_cand + c_pair * n_pair + c_appr * n_appr
    return n_cand, n_pair, n_appr, nbytes, ops


def sweep_numbers(sim, p, cs, mod=bs, plain_reps=2, op_costs=None):
    """A sweep kernel (the block or the cell sweep) on this state: the
    wrapper's and the plain version's time per call (CUDA events), this
    state's work and the bound it gives.  The work count is that of the
    ARTIFICIAL + LINEAR model set without extras, or ``op_costs``."""
    n_cand, n_pair, n_appr, nbytes, ops = sweep_work(sim, p, cs, reads_cell=mod is bs,
                                                     op_costs=op_costs)
    args = (sim.cfg.spec, sim.cfg.grid, p, cs, p.position, p.density,
            p.pressure, p.velocity)
    sweep, plain = ((bs.block_sweep, bs.block_sweep_plain) if mod is bs
                    else (cw.cell_sweep, cw.cell_sweep_plain))
    ms = time_cuda(lambda: sweep(*args), 20)
    plain_ms = time_cuda(lambda: plain(*args, block_size=4096), plain_reps)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "candidates": n_cand, "pairs": n_pair, "approaching_pairs": n_appr,
            "bytes": nbytes, "ops": ops, "schedule": schedule(sim, p, cs, mod)}


def mdbc_work(sim, args, groups, own_rows=None):
    """Candidates and in-support fluid pairs of the slots the kernel computes,
    and the bytes and operations of the function on this run's data.
    ``groups`` is :func:`mm.ghost_groups` of these slots: a parked slot
    needs no work, a dry one (no fluid row in its stencil) only the test of
    its 3^D cells' fluid flags, and only the grouped (wet) slots need their
    candidates and, fused, the solve.  Without ``own_rows`` the moments: the
    computing slots' ghost points, every slot's validity, the candidate
    arrays and cell_start read once, the [B, K] f32 moments written.  With
    ``own_rows`` (the rows of the particles whose density is corrected) the
    fused function: per computing slot its ghost point, its row's position,
    its row index, validity and decision; the candidates; the density read
    and the corrected density written."""
    spec, grid, gpoint, bvalid, position, density, ml, cs = args
    kern = spec.kernel
    gcoords = cl.clamp_coords(cl.cell_coords(gpoint, kern.H_inv), grid)
    starts, ends = cl.row_segments(gcoords, grid, cs)
    B, d = gpoint.shape
    wet = groups["keys"] >= 0
    n_wet, n_dry = int(wet.sum()), int(groups["dry"].sum())
    rows = n_wet + n_dry                       # the slots that are not parked
    n_cand = n_pair = 0
    for b0 in range(0, B, 8192):
        i, j = candidates(starts, ends, b0, min(b0 + 8192, B))
        keep = wet[i]
        i, j = i[keep], j[keep]
        xij = gpoint[i] - position[j]
        n_cand += int(i.numel())
        n_pair += int((((xij * xij).sum(-1) <= kern.H2) & (ml[j] > 0.5)).sum())
    n = position.shape[0]
    ops = MDBC_OPS_CANDIDATE * n_cand + MDBC_OPS_PAIR * n_pair + 3 ** d * n_dry
    el = gpoint.element_size()
    cand_bytes = n * (d + 2) * position.element_size() + cs.numel() * 4
    if own_rows is None:
        nbytes = rows * d * el + B + cand_bytes + B * mm.n_moments(d) * 4
        return n_cand, n_pair, nbytes, ops
    nbytes = rows * (2 * d * el + 8 + 1 + 1) + cand_bytes + 2 * own_rows * el
    return n_cand, n_pair, nbytes, ops + MDBC_OPS_SOLVE[d] * n_wet


def run_phase(sim, label, mdbc_on, sweep="block", falling=True, rho_band=0.02):
    """10 warm-up + 200 timed steps through ``make_fixed_steps_fn`` with the
    launch counts set to 0 just before the timed steps and read just after,
    and the physics checks.  ``sweep`` names the kernel the path must take:
    2 launches of it per step, none of the other.  Returns (end state, the
    emitted record)."""
    if sim.cfg.sweep_kernel != sweep:
        fail(f"{label}: assemble_simulation chose the {sim.cfg.sweep_kernel} sweep, not {sweep}")
    ids0 = sim.state.particles.id.clone()
    pos0 = sim.state.particles.position.clone()
    fixed0 = sim.state.particles.ptype == int(T.ParticleType.FIXED)
    state = make_fixed_steps_fn(sim.cfg, WARM_STEPS)(sim.state)
    fixed = make_fixed_steps_fn(sim.cfg, STEPS)
    build_graph(fixed, sim.cfg, state)
    torch.cuda.synchronize()
    rebuilds0 = int(state.rebuilds)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = fixed(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"block": bs.launches, "cell": cw.launches}
    sweep_launches, mdbc_launches = counts[sweep], mm.launches
    group_launches = mm.group_launches
    other_launches = sum(v for k, v in counts.items() if k != sweep)
    n = sim.n_live
    run = {
        "phase": label, "n": n, "steps": STEPS, "wall_s": wall,
        "particle_steps_per_s": n * STEPS / wall, "ms_per_step": 1e3 * wall / STEPS,
        "device": torch.cuda.get_device_name(0), "rebuilds": int(state.rebuilds) - rebuilds0,
        "sim_time_s": float(state.total_time), "dt": float(state.current_dt),
        **physics(sim, ids0, pos0, fixed0, state),
        "sweep_kernel": sweep, "launches": sweep_launches,
        "block_sweep_launches": counts["block"], "cell_sweep_launches": counts["cell"],
        "mdbc_launches": mdbc_launches, "mdbc_group_launches": group_launches,
        "ghosts": sim.cfg.boundary_capacity if mdbc_on else 0,
        "max_occupancy": int(state.max_occupancy), "max_segment": int(state.max_segment),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        **graph_numbers(fixed.chunk),
        "end_digest": end_digest(state),
    }
    emit(run)
    physics_gates(sim, run, label, rho_band, falling)
    if sweep_launches != 2 * STEPS or other_launches != 0:
        fail(f"{label}: {sweep}-sweep launches {sweep_launches} != 2 x {STEPS} steps, "
             f"or the other sweep was launched ({other_launches})")
    if mdbc_launches != (STEPS if mdbc_on else 0) or group_launches != len(
            GROUP_KERNELS) * mdbc_launches:
        fail(f"{label}: mDBC launches {mdbc_launches} (grouping {group_launches}) in "
             f"{STEPS} steps")
    if mdbc_on and run["boundary_rows_off_rho0"] == 0:
        fail(f"{label}: no boundary density moved off rho0 - mDBC did not fire")
    return state, run


def build_graph(fixed, cfg, state):
    """Capture the chunk graph of ``fixed`` (a ``make_fixed_steps_fn``
    function) before a timed window: a chunk of one step from ``state``
    (the accumulator at 1 + h, so that the step rebuilds, as a run's first
    does), whose result is dropped.  That step is the one the chunk runs
    eagerly before its capture.  A sharded ``state``: the tuple of slab
    states, the graph of every slab's step."""
    lead = state[0] if isinstance(state, tuple) else state
    fixed.chunk(state, math.inf, _initial_dx_acc(cfg, state), int(lead.iteration) + 1)
    if fixed.chunk.graph is None:
        fail("build_graph: the chunk built no graph")


def graph_numbers(chunk):
    """What a chunk's graph (``core/step.py:ChunkGraph``) took to build."""
    g = chunk.graph
    return {"graph_steps": g.steps, "graph_capture_s": g.capture_s,
            "graph_instantiate_s": g.instantiate_s, "graph_nodes_per_step": g.nodes_per_step,
            "graph_memory_mb": g.memory_bytes / 2**20}


def physics(sim, ids0, pos0, fixed0, state):
    """The physics readings of a run's end ``state`` (the start's ids,
    positions and fixed-row mask given): finite fields, the fluid's density
    range and least vertical velocity, the boundary's density range, fixed
    rows unmoved (bitwise, by id), grid escapes."""
    p = state.particles
    finite = all(bool(torch.isfinite(getattr(p, f)).all()) for f in
                 ("position", "velocity", "acceleration", "density", "pressure"))
    fluid = p.ptype == int(T.ParticleType.FLUID)
    rho0 = sim.cfg.spec.constants.rho0
    rho_f = p.density[fluid]
    order_now = torch.argsort(p.id)
    order0 = torch.argsort(ids0)
    walls_still = bool(torch.equal(p.position[order_now][fixed0[order0]],
                                   pos0[order0][fixed0[order0]]))
    rho_b = p.density[(p.ptype == int(T.ParticleType.FIXED)) & p.active]
    return {
        "fluid_rho_min": float(rho_f.min()), "fluid_rho_max": float(rho_f.max()),
        "fluid_vz_min": float(p.velocity[fluid][:, -1].min()),
        "boundary_rho_min": float(rho_b.min()), "boundary_rho_max": float(rho_b.max()),
        "boundary_rows_off_rho0": int((rho_b != rho0).sum()),
        "finite": finite, "walls_still": walls_still,
        "grid_escapes": int(state.grid_escapes),
    }


def physics_gates(sim, rec, label, rho_band=0.02, falling=True):
    """Fail unless the readings of :func:`physics` in ``rec`` pass: finite,
    fluid density within ``rho_band`` of rho0, (``falling``) the column
    falling, fixed walls still, no grid escapes."""
    rho0 = sim.cfg.spec.constants.rho0
    if not rec["finite"]:
        fail(f"{label}: non-finite fields after the run")
    if not (abs(rec["fluid_rho_min"] / rho0 - 1) <= rho_band
            and abs(rec["fluid_rho_max"] / rho0 - 1) <= rho_band):
        fail(f"{label}: fluid density left rho0 +- {100 * rho_band:g}%")
    if falling and not rec["fluid_vz_min"] < 0:
        fail(f"{label}: the fluid column is not falling")
    if not rec["walls_still"]:
        fail(f"{label}: fixed boundary particles moved")
    if rec["grid_escapes"] != 0:
        fail(f"{label}: particles escaped the static grid")


def breakdown_phase(sim, state, run, label):
    """Where a step's time goes (CUDA events; profiler for busy share)."""
    pf, csf = state.particles, state.cell_start
    sweep_ms = time_cuda(lambda: _sweep(sim.cfg, pf, csf, pf.position, pf.density,
                                        pf.pressure, pf.velocity), 20)
    rebuild_ms = time_cuda(lambda: cl.rebuild(pf, sim.cfg.spec.kernel.H_inv,
                                              sim.cfg.grid), 10)
    dx_far = torch.full((), 1e9, dtype=state.total_time.dtype, device="cuda")
    dx_none = torch.zeros((), dtype=state.total_time.dtype, device="cuda")
    step_rebuild_ms = time_cuda(lambda: sph_step(sim.cfg, state, dx_far), 10)
    step_plain_ms = time_cuda(lambda: sph_step(sim.cfg, state, dx_none), 10)
    step_ms = run["ms_per_step"]
    brk = {
        "phase": label, "step_ms": step_ms,
        "sweep_ms": sweep_ms, "two_sweeps_share": 2 * sweep_ms / step_ms,
        "rebuild_ms": rebuild_ms, "rebuilds_per_step": run["rebuilds"] / STEPS,
        "step_ms_with_rebuild": step_rebuild_ms, "step_ms_without_rebuild": step_plain_ms,
    }
    if sim.cfg.meta.mdbc is T.MDBCMode.SIMPLE:
        spec, grid, B = sim.cfg.spec, sim.cfg.grid, sim.cfg.boundary_capacity
        # stage 04 as the step runs it: compaction, then one fused call
        stage = lambda: mdbc.mdbc_density_correction(spec, grid, pf, csf, B)  # noqa: E731
        bidx, args = moment_args(sim, pf, csf)
        gpoint, bvalid = args[2], args[3]
        fused = lambda: mm.mdbc_correct(spec, grid, pf, bidx, bvalid, pf.position,  # noqa: E731
                                        pf.density, pf.motion_limiter, csf)

        def unfused():
            # the stage before the fusion: compaction, gather, moments,
            # solve, decision tree, scatter
            bi, bv = mdbc.compact_ghosts(pf, B)
            gp = pf.ghost_points[bi]
            bk, Ak = mm.mdbc_moments(spec, grid, gp, bv, pf.position, pf.density,
                                     pf.motion_limiter, csf)
            return mdbc._mdbc_apply(spec, pf, bi, bv, gp, bk, Ak)

        bvec, Amat = mm.mdbc_moments(*args)
        stage_ms = time_cuda(stage, 20)
        stage_launches, stage_device_ms = launches_per_call(stage)
        unfused_launches, unfused_device_ms = launches_per_call(unfused)
        brk.update(
            mdbc_stage_ms=stage_ms, mdbc_stage_share=stage_ms / step_ms,
            mdbc_stage_launches=stage_launches, mdbc_stage_device_ms=stage_device_ms,
            mdbc_compact_ms=time_cuda(lambda: mdbc.compact_ghosts(pf, B), 20),
            mdbc_fused_call_ms=time_cuda(fused, 20),
            mdbc_group_kernels_ms=kernel_only_ms(fused, GROUP_KERNELS, per_call=True),
            mdbc_unfused_stage_ms=time_cuda(unfused, 20),
            mdbc_unfused_stage_launches=unfused_launches,
            mdbc_unfused_stage_device_ms=unfused_device_ms,
            mdbc_moments_ms=time_cuda(lambda: mm.mdbc_moments(*args), 20),
            mdbc_solve_ms=time_cuda(lambda: mdbc._det_solve(Amat, bvec), 20),
            mdbc_apply_ms=time_cuda(lambda: mdbc._mdbc_apply(spec, pf, bidx, bvalid, gpoint,
                                                             bvec, Amat), 20))
    brk.update(prof_window(sim, state))
    emit(brk)
    return brk


# --- --reference DIR: another checkout's own mDBC stage, in turns with this one -----

# run by a child process with DIR's package and DIR's chip_smoke.py: its mDBC
# deck as phase 8 runs it (10 + 200 steps), its kernels built into OUT (in this
# checkout), its moments on the end state saved to OUT, its end digest and
# times on the end state printed as the last line
REFERENCE_CHILD = """
import hashlib, json, sys
from pathlib import Path
ref, out = sys.argv[1], Path(sys.argv[2])
sys.path.insert(0, ref)
import torch
from sphexample_tpu_torch.ops import _build
_build.BUILD = out
import chip_smoke as C
from sphexample_tpu_torch.core.step import make_fixed_steps_fn
from sphexample_tpu_torch.ops import mdbc, mdbc_moments as mm
@END_DIGEST@
sim = C.assemble_mdbc(C.case_3d())
state = make_fixed_steps_fn(sim.cfg, C.WARM_STEPS)(sim.state)
state = make_fixed_steps_fn(sim.cfg, C.STEPS)(state)
p, cs = state.particles, state.cell_start
_, args = C.moment_args(sim, p, cs)
moments = lambda: mm.mdbc_moments(*args)
b, A = moments()
torch.save(torch.cat([b, A.reshape(b.shape[0], -1)], 1).float().cpu(), out / "moments.pt")
stage = lambda: mdbc.mdbc_density_correction(sim.cfg.spec, sim.cfg.grid, p, cs,
                                             sim.cfg.boundary_capacity)
print(json.dumps({"end_digest": end_digest(state), "ms": C.time_cuda(moments, 20),
                  "kernel_only_ms": C.kernel_only_ms(moments, "mdbc_moments"),
                  "stage_ms": C.time_cuda(stage, 20)}))
"""
REFERENCE_KEYS = ("parent_ms", "parent_kernel_only_ms", "parent_stage_ms", "ms_in_turns",
                  "moments_mode_ms_in_turns", "kernel_only_ms_in_turns", "stage_ms_in_turns",
                  "end_state_vs_parent_bitwise", "moments_vs_parent_bitwise",
                  "moments_vs_parent_max_abs")


def reference_turns(ref_dir, run_digest, args, fused, stage):
    """DIR's own mDBC run (a child process, as REFERENCE_CHILD) and this
    checkout's calls on phase 8's end state (``args`` of the moment
    wrapper, the ``fused`` call, the ``stage`` 04), in turns parent /
    change / change / parent on this card: the end digests, the moments on
    the end state bit for bit, and the times per call (CUDA events) and per
    launch (profiler).  "not measured" without DIR."""
    if ref_dir is None:
        return {k: "not measured" for k in REFERENCE_KEYS}
    out = _build.BUILD / "reference"
    out.mkdir(parents=True, exist_ok=True)
    code = REFERENCE_CHILD.replace("@END_DIGEST@", inspect.getsource(end_digest))
    cmd = [sys.executable, "-c", code, str(Path(ref_dir).resolve()), str(out)]
    env = {**os.environ, "PYTHONDONTWRITEBYTECODE": "1"}
    turns = {k: [] for k in REFERENCE_KEYS[:7]}
    digests = []
    for who in ("parent", "change", "change", "parent"):
        if who == "parent":
            proc = subprocess.run(cmd, cwd=out, env=env, capture_output=True, text=True)
            if proc.returncode:
                fail(f"the reference checkout's mDBC run failed:\n{proc.stderr[-3000:]}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            digests.append(got["end_digest"])
            for k in ("ms", "kernel_only_ms", "stage_ms"):
                turns[f"parent_{k}"].append(got[k])
        else:
            turns["ms_in_turns"].append(time_cuda(fused, 20))
            turns["moments_mode_ms_in_turns"].append(
                time_cuda(lambda: mm.mdbc_moments(*args), 20))
            turns["kernel_only_ms_in_turns"].append(kernel_only_ms(fused, "mdbc_moments"))
            turns["stage_ms_in_turns"].append(time_cuda(stage, 20))
    bk, Ak = mm.mdbc_moments(*args)
    mine = torch.cat([bk, Ak.reshape(bk.shape[0], -1)], 1).float().cpu()
    theirs = torch.load(out / "moments.pt")
    res = {**turns, "parent_end_digests": digests,
           "end_state_vs_parent_bitwise": all(d == run_digest for d in digests),
           "moments_vs_parent_bitwise": bool(torch.equal(mine, theirs)),
           "moments_vs_parent_max_abs": float((mine - theirs).abs().max())}
    emit({"phase": "parent_mdbc", **res})
    return res


# --- the sharded path: P slabs, ranks as threads ---------------------------------

def unsharded(sim_sh):
    """The single-device view of a sharded simulation: its gathered global
    state (capacity padded to the slabs) under an unsharded config."""
    cfg = dataclasses.replace(sim_sh.cfg, ctx=SINGLE, halo=0)
    return T.Simulation(cfg=cfg, state=gather_state(sim_sh.state, "cuda:0"),
                        meta=sim_sh.meta, n_live=sim_sh.n_live)


def through_ranks(sim_sh, p, cs, fn):
    """``fn(cfg_r, slab particles, cell_start)`` on every slab of the global
    sorted state (p, cs) at once, through the thread ranks and their real
    collectives; the results in rank order, moved to card 0."""
    states = split_state(sim_sh.state[0].replace(particles=p, cell_start=cs,
                                                 position_half=p.position),
                         sim_sh.mesh.devices)
    run, _ = make_sharded_fn(sim_sh.cfg, sim_sh.mesh,
                             lambda c: lambda st: fn(c, st.particles, st.cell_start))
    return run(states)


def on0(t):
    return None if t is None else t.to("cuda:0")


def cat_sweeps(outs):
    fields = {}
    for _, field in SWEEP_FIELDS:
        parts = [getattr(o, field) for o in outs]
        fields[field] = None if parts[0] is None else torch.cat([on0(a) for a in parts])
    return type(outs[0])(**fields)


def slab_window(p, cs, r, halo):
    """Slab r's window of the global sorted state, built by slicing: (slab
    particles, rebased cell_start, the extended sweep fields, self_off).  Rows
    past the global ends are zeros, as the end ranks receive them."""
    N = p.capacity
    C = N // N_SLABS
    base = r * C
    lo, hi, self_off = (0, N, base) if halo == 0 else (base - halo, base + C + halo, halo)

    def ext(a):
        zl = a.new_zeros((max(0, -lo),) + tuple(a.shape[1:]))
        zr = a.new_zeros((max(0, hi - N),) + tuple(a.shape[1:]))
        return torch.cat([zl, a[max(lo, 0):min(hi, N)], zr])

    fields = {k: ext(getattr(p, k)) for k in
              ("position", "density", "pressure", "velocity", "motion_limiter")}
    return (p.map(lambda a: a[base:base + C]), halo_mod.rebase(cs, lo, hi - lo),
            fields, self_off)


def compare_window(sim_sh, simg, p, cs, label, mod, spec=None, halos=None):
    """A windowed sweep kernel (``mod``) on the 4 slabs of the global state
    (p, cs): per slab against its plain version on the same extended inputs;
    the slabs' outputs concatenated against the single-device kernel on the
    global state; and the same through the real exchange of 4 thread ranks."""
    spec = spec or simg.cfg.spec
    grid = simg.cfg.grid
    window, plain, single = ((bs.block_sweep_window, bs.block_sweep_plain, bs.block_sweep)
                             if mod is bs else
                             (cw.cell_sweep_window, cw.cell_sweep_plain, cw.cell_sweep))
    ref_single = single(spec, grid, p, cs, p.position, p.density, p.pressure, p.velocity)
    res = {"phase": label, "n": int(p.active.sum()), "slabs": N_SLABS}
    for halo in (halos or (sim_sh.cfg.halo,)):
        tag = f"halo_{halo}"
        outs, worst, worst_abs = [], 0.0, 0.0
        for r in range(N_SLABS):
            pl, cs_ext, f, self_off = slab_window(p, cs, r, halo)
            args = (spec, grid, pl, cs_ext, f["position"], f["density"], f["pressure"],
                    f["velocity"])
            k = window(*args, f["motion_limiter"], self_off)
            ref = plain(*args, block_size=4096, motion_limiter=f["motion_limiter"],
                        self_off=self_off)
            torch.cuda.synchronize()
            d = sweep_diff(k, ref, f"{label}:{tag}:slab{r}")
            worst = max(worst, max(v for key, v in d.items() if key.endswith("_rel")))
            worst_abs = max(worst_abs,
                            max(v for key, v in d.items() if key.endswith("_max_abs")))
            outs.append(k)
        d = sweep_diff(cat_sweeps(outs), ref_single, f"{label}:{tag}:concatenated")
        res[f"{tag}_rows"] = int(f["position"].shape[0])
        res[f"{tag}_window_vs_plain_max_rel"] = worst
        res[f"{tag}_window_vs_plain_max_abs"] = worst_abs
        res[f"{tag}_slabs_vs_single_max_rel"] = max(
            v for key, v in d.items() if key.endswith("_rel"))
        res[f"{tag}_slabs_vs_single_max_abs"] = max(
            v for key, v in d.items() if key.endswith("_max_abs"))
        res[f"{tag}_slabs_vs_single_bitwise"] = res[f"{tag}_slabs_vs_single_max_abs"] == 0.0
    # the same sweep through sweep_sharded: pack, halo exchange, launch
    sharded = bs.block_sweep_sharded if mod is bs else cw.cell_sweep_sharded
    outs = through_ranks(sim_sh, p, cs, lambda c, pl, csl: sharded(
        spec, grid, c.halo, pl, csl, pl.position, pl.density, pl.pressure, pl.velocity,
        c.ctx))
    d = sweep_diff(cat_sweeps(outs), ref_single, f"{label}:exchange")
    res["exchange_vs_single_max_rel"] = max(v for key, v in d.items() if key.endswith("_rel"))
    res["exchange_vs_single_bitwise"] = all(
        v == 0.0 for key, v in d.items() if key.endswith("_max_abs"))
    rels = [v for key, v in res.items() if key.endswith("_window_vs_plain_max_rel")]
    slabs = [v for key, v in res.items() if key.endswith("_vs_single_max_rel")]
    res["ok"] = max(rels) < REL_TOL and max(slabs) < SLAB_TOL
    emit(res)
    if not res["ok"]:
        fail(f"{label}: windowed kernel, plain version and single-device kernel disagree")
    return res


def compare_window_mdbc(sim_sh, simg, p, cs, label):
    """The moment kernel on the halo: per slab, the slab's own ghosts against
    the extended position / density / limiter, kernel vs plain; the corrected
    densities of the 4 slabs concatenated against the single-device
    correction, sliced windows and the real exchange alike."""
    spec, grid, B = simg.cfg.spec, simg.cfg.grid, simg.cfg.boundary_capacity
    halo = sim_sh.cfg.halo
    rho_single = mdbc.mdbc_density_correction(spec, grid, p, cs, B)
    ks, refs, dens, ghosts = [], [], [], []
    for r in range(N_SLABS):
        pl, cs_ext, f, _ = slab_window(p, cs, r, halo)
        bidx, bvalid = mdbc.compact_ghosts(pl, B)
        args = (spec, grid, pl.ghost_points[bidx], bvalid, f["position"], f["density"],
                f["motion_limiter"], cs_ext)
        bk, Ak = mm.mdbc_moments(*args)
        bp, Ap = mm.mdbc_moments_plain(*args)
        torch.cuda.synchronize()
        ks.append(torch.cat([bk, Ak.reshape(B, -1)], dim=1))
        refs.append(torch.cat([bp, Ap.reshape(B, -1)], dim=1))
        if not (torch.isfinite(ks[-1]).all() and torch.isfinite(refs[-1]).all()):
            fail(f"{label}: non-finite moments on slab {r}")
        # fill slots repeat row 0, so count the rows, not the valid slots
        ghosts.append(int((torch.any(pl.ghost_points != 0, dim=-1) & pl.active).sum()))
        dens.append(mdbc._mdbc_apply(spec, pl, bidx, bvalid, args[2], bk, Ak)[0])
    # every moment column relative to its max over all four slabs, the measure
    # of the single-device phase (the top slab's ghosts see the fluid only at
    # the rim of their support: its own column maxima are all but zero)
    k, ref = torch.cat(ks), torch.cat(refs)
    col_rel = (k - ref).abs().amax(dim=0) / ref.abs().amax(dim=0).clamp(min=1e-30)
    worst = float(col_rel.max())
    worst_abs = float((k - ref).abs().max())
    sliced = float((torch.cat(dens) - rho_single).abs().max())
    outs = through_ranks(sim_sh, p, cs, lambda c, pl, csl: mdbc.mdbc_density_correction_sharded(
        spec, grid, pl, csl, B, c.ctx, c.halo))
    exchanged = float((torch.cat([on0(a) for a in outs]) - rho_single).abs().max())
    rho_max = float(rho_single.abs().max())
    res = {"phase": label, "slabs": N_SLABS, "halo": halo, "ghosts_per_slab": ghosts,
           "window_vs_plain_moment_max_rel": worst,
           "window_vs_plain_moment_max_abs": worst_abs,
           "slabs_vs_single_rho_max_abs": sliced, "slabs_vs_single_bitwise": sliced == 0.0,
           "exchange_vs_single_rho_max_abs": exchanged,
           "exchange_vs_single_bitwise": exchanged == 0.0}
    res["ok"] = (worst < REL_TOL and sliced <= SLAB_TOL * rho_max
                 and exchanged <= SLAB_TOL * rho_max and sum(ghosts) == B)
    emit(res)
    if not res["ok"]:
        fail(f"{label}: the moment kernel on the halo disagrees")
    return res


def sharded_rebuild_phase(sim_sh, simg, label="sharded_rebuild"):
    """``rebuild_sharded`` on 4 slabs against the single-device ``rebuild``
    after every fluid particle moved by less than h."""
    kern, grid = simg.cfg.spec.kernel, simg.cfg.grid
    p, _ = stirred_state(simg)
    rng = np.random.default_rng(5)
    step = rng.uniform(-1, 1, size=tuple(p.position.shape)) * (0.9 * kern.h / np.sqrt(p.dims))
    step = torch.as_tensor(step, dtype=p.position.dtype).to(p.device)
    moved = p.replace(position=p.position + step * p.motion_limiter[:, None])
    ref, cs_ref, occ_ref = cl.rebuild(moved, kern.H_inv, grid)
    outs = through_ranks(sim_sh, moved, simg.state.cell_start,
                         lambda c, pl, csl: cl.rebuild_sharded(pl, kern.H_inv, grid, c.ctx,
                                                               c.halo))
    torch.cuda.synchronize()
    migration = int(outs[0][3])
    same = {f: bool(torch.equal(torch.cat([on0(getattr(o[0], f)) for o in outs]),
                                getattr(ref, f)))
            for f in ("id", "cell", "position", "density", "active")}
    same["cell_start"] = all(bool(torch.equal(on0(o[1]), cs_ref)) for o in outs)
    same["max_occupancy"] = all(int(o[2]) == int(occ_ref) for o in outs)
    res = {"phase": label, "n": simg.n_live, "slabs": N_SLABS, "halo": sim_sh.cfg.halo,
           "migration_need": migration, "bitwise_equal": same,
           "rows_that_changed_place": int((ref.id != p.id).sum())}
    res["ok"] = all(same.values()) and 0 < migration <= sim_sh.cfg.halo
    emit(res)
    if not res["ok"]:
        fail(f"{label}: the distributed rebuild differs from the single-device one, "
             "or nothing migrated")
    return res


def by_id(state, field):
    """A field of the live particles in ID order, on the host, as float64."""
    p = state.particles
    ids = p.id.cpu()
    order = torch.argsort(ids)
    order = order[ids[order] > 0]
    return getattr(p, field).cpu()[order].double().numpy()


def end_digest(state):
    """SHA-256 of the live particles' position, velocity and density in ID
    order, in the state's dtype: two runs that end bit for bit alike print
    the same digest."""
    p = state.particles
    order = torch.argsort(p.id)
    order = order[p.id[order] > 0]
    h = hashlib.sha256()
    for field in ("position", "velocity", "density"):
        h.update(getattr(p, field)[order].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def end_summary(state):
    """What a later sharded run of the same steps is held against."""
    return {"pos": by_id(state, "position"), "vel": by_id(state, "velocity"),
            "dens": by_id(state, "density"), "total_time": float(state.total_time),
            "dt": float(state.current_dt), "rebuilds": int(state.rebuilds)}


def in_trajectory_bands(end, ref):
    """The bands of tests/test_trajectory.py:64-70; the largest differences."""
    scale = float(np.abs(ref["pos"]).max())
    diffs = {k: float(np.abs(end[k] - ref[k]).max()) for k in ("pos", "vel", "dens")}
    ok = bool(
        abs(end["total_time"] - ref["total_time"]) <= 1e-12 * abs(ref["total_time"])
        and abs(end["dt"] - ref["dt"]) <= 1e-12 * abs(ref["dt"])
        and np.allclose(end["pos"], ref["pos"], rtol=1e-9, atol=1e-9 * scale)
        and np.allclose(end["vel"], ref["vel"], rtol=1e-7, atol=1e-8)
        and np.allclose(end["dens"], ref["dens"], rtol=1e-9, atol=1e-6))
    return ok, diffs


def run_sharded_phase(sim, single_end, label, mdbc_on, sweep="block", falling=True,
                      rho_band=0.02):
    """``run_phase`` for 4 slabs: the same 10 + 200 steps through
    ``make_sharded_fixed_steps_fn``, its physics gates on the gathered end
    state, the windowed launch counts (2 per step per slab of the chosen
    sweep, none of the other, none of a single-device entry), the halo guard,
    the ranks' rebuild counts, and the end state against the single-device
    run's (``single_end``) within the bands of tests/test_trajectory.py:64-70."""
    sim_sh = shard_simulation(sim, make_mesh(N_SLABS))
    cfg, halo = sim_sh.cfg, sim_sh.cfg.halo
    if cfg.sweep_kernel != sweep:
        fail(f"{label}: shard_simulation chose the {cfg.sweep_kernel} sweep, not {sweep}")
    g0 = gather_state(sim_sh.state, "cuda:0")
    ids0, pos0 = g0.particles.id.clone(), g0.particles.position.clone()
    fixed0 = g0.particles.ptype == int(T.ParticleType.FIXED)
    del g0
    states = make_sharded_fixed_steps_fn(cfg, sim_sh.mesh, WARM_STEPS)(sim_sh.state)
    fixed = make_sharded_fixed_steps_fn(cfg, sim_sh.mesh, STEPS)
    build_graph(fixed, cfg, states)
    torch.cuda.synchronize()
    rebuilds0 = [int(s.rebuilds) for s in states]
    torch.cuda.reset_peak_memory_stats()
    bs.launches = bs.window_launches = 0
    cw.launches = cw.window_launches = 0
    mm.launches = mm.group_launches = 0
    t0 = time.perf_counter()
    states = fixed(states)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"block": bs.window_launches, "cell": cw.window_launches}
    single_entry = bs.launches + cw.launches
    sweep_launches, mdbc_launches = counts[sweep], mm.launches
    group_launches = mm.group_launches
    other_launches = sum(v for k, v in counts.items() if k != sweep)
    rebuilds = [int(s.rebuilds) - r0 for s, r0 in zip(states, rebuilds0)]
    scalars_agree = all(
        float(s.total_time) == float(states[0].total_time)
        and int(s.iteration) == int(states[0].iteration)
        and int(s.max_halo) == int(states[0].max_halo)
        and bool(torch.equal(on0(s.cell_start), on0(states[0].cell_start)))
        for s in states)
    state = gather_state(states, "cuda:0")
    p = state.particles
    n = sim.n_live
    end = end_summary(state)
    in_bands, diffs = in_trajectory_bands(end, single_end)
    C = p.capacity // N_SLABS
    run = {
        "phase": label, "n": n, "slabs": N_SLABS, "cards": torch.cuda.device_count(),
        "slab_devices": [str(d) for d in sim_sh.mesh.devices], "chunk": fixed.chunk.route,
        "slab_rows": C, "halo": halo, "window_rows": C + 2 * halo if halo else p.capacity,
        "max_halo": int(state.max_halo), "steps": STEPS, "wall_s": wall,
        "particle_steps_per_s": n * STEPS / wall, "ms_per_step": 1e3 * wall / STEPS,
        "rebuilds_per_rank": rebuilds,
        "rebuilds_total_per_rank": [int(s.rebuilds) for s in states],
        "rebuilds_total_single_device": single_end["rebuilds"],
        "ranks_agree_on_scalars": scalars_agree,
        "sim_time_s": end["total_time"], "dt": end["dt"],
        **physics(sim, ids0, pos0, fixed0, state),
        "sweep_kernel": sweep, "launches": sweep_launches,
        "launches_per_step_per_slab": sweep_launches / STEPS / N_SLABS,
        "block_window_launches": counts["block"], "cell_window_launches": counts["cell"],
        "single_device_entry_launches": single_entry, "mdbc_launches": mdbc_launches,
        "mdbc_group_launches": group_launches,
        "vs_single_device_max_abs": diffs,
        "vs_single_device_bitwise": all(v == 0.0 for v in diffs.values()),
        "vs_single_device_in_bands": in_bands,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        **(graph_numbers(fixed.chunk) if fixed.chunk.graph is not None else {}),
    }
    emit(run)
    physics_gates(sim, run, label, rho_band, falling)
    if run["chunk"] != chunk_route(sim_sh.mesh) or (run["chunk"] == "graph") != (
            fixed.chunk.graph is not None):
        fail(f"{label}: the chunk took the {run['chunk']} route on {run['slab_devices']}")
    if (sweep_launches != 2 * STEPS * N_SLABS or other_launches != 0 or single_entry != 0):
        fail(f"{label}: windowed {sweep}-sweep launches {sweep_launches} != 2 x {STEPS} "
             f"steps x {N_SLABS} slabs, or another sweep entry was launched "
             f"({other_launches}, {single_entry})")
    if mdbc_launches != (STEPS * N_SLABS if mdbc_on else 0) or group_launches != len(
            GROUP_KERNELS) * mdbc_launches:
        fail(f"{label}: mDBC launches {mdbc_launches} (grouping {group_launches}) in "
             f"{STEPS} steps on {N_SLABS} slabs")
    if mdbc_on and run["boundary_rows_off_rho0"] == 0:
        fail(f"{label}: no boundary density moved off rho0 - mDBC did not fire")
    if not 0 < run["max_halo"] <= halo:
        fail(f"{label}: max_halo {run['max_halo']} outside (0, halo = {halo}]")
    if (len(set(rebuilds)) != 1 or not scalars_agree
            or int(states[0].rebuilds) != single_end["rebuilds"]):
        fail(f"{label}: the ranks took different branches: rebuilds {rebuilds} "
             f"(single device: {single_end['rebuilds']} in all)")
    if not in_bands:
        fail(f"{label}: the sharded end state left the trajectory bands of the "
             f"single-device run: {diffs}")
    return sim_sh, states, state, run


def chunk_route(mesh):
    """The chunk route a sharded run must take on ``mesh``: one graph of
    every slab's steps when all slabs lie on one card, else the eager
    chunk (``core/step.py:make_chunk_body``)."""
    return "graph" if len(set(mesh.devices)) == 1 else "eager"


def exchange_phase(sim_sh, states, label="exchange", reps=50):
    """One halo exchange of the packed rows (``ops.halo.extend``: H rows each
    way, the two neighbours' rows copied device to device, the window
    concatenated), on all slabs at once: CUDA-event time on each rank's
    stream and host time per exchange, and the bytes one slab sends."""
    halo = sim_sh.cfg.halo

    def make(c):
        def fn(st):
            p = st.particles
            pack = bs.pack_fields(p.position, p.velocity, p.density, p.pressure,
                                  p.motion_limiter)
            halo_mod.extend(c.ctx, pack, c.halo)
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            t0.record()
            for _ in range(reps):
                ext, _, _ = halo_mod.extend(c.ctx, pack, c.halo)
            t1.record()
            t1.synchronize()
            host_ms = 1e3 * (time.perf_counter() - h0) / reps
            # the rendezvous alone: the two barrier waits of one collective,
            # and one reduction of a scalar (as stages 00 and 01 make three)
            h1 = time.perf_counter()
            for _ in range(reps):
                c.ctx.group.wait(c.ctx.rank())
                c.ctx.group.wait(c.ctx.rank())
            h2 = time.perf_counter()
            for _ in range(reps):
                c.ctx.pmax(st.total_time)
            h3 = time.perf_counter()
            return (t0.elapsed_time(t1) / reps, host_ms,
                    pack.shape[1] * pack.element_size(), ext.shape[0],
                    1e3 * (h2 - h1) / reps, 1e3 * (h3 - h2) / reps)
        return fn

    outs = make_sharded_fn(sim_sh.cfg, sim_sh.mesh, make)[0](states)
    row_bytes = outs[0][2]
    res = {"phase": label, "slabs": N_SLABS, "halo_rows": halo, "row_bytes": row_bytes,
           "bytes_sent_per_slab_per_sweep": 2 * halo * row_bytes,
           "bytes_sent_each_way": halo * row_bytes, "window_rows": outs[0][3],
           "exchange_ms_device_per_rank": [o[0] for o in outs],
           "exchange_ms_host_per_rank": [o[1] for o in outs],
           "two_barrier_waits_ms_host": max(o[4] for o in outs),
           "scalar_pmax_ms_host": max(o[5] for o in outs)}
    emit(res)
    return res


def window_numbers(simg, p, cs, mod, halo, r=1, plain_reps=2, op_costs=None):
    """A windowed sweep kernel on slab ``r``'s window of the global state: the
    wrapper's and the plain version's time per call, the slab's own work
    (``sweep_work`` restricted to its selves) and the bound it gives."""
    C = p.capacity // N_SLABS
    pl, cs_ext, f, self_off = slab_window(p, cs, r, halo)
    n_cand, n_pair, n_appr, _, ops = sweep_work(simg, p, cs, reads_cell=mod is bs,
                                                lo=r * C, hi=(r + 1) * C,
                                                op_costs=op_costs)
    ne, d = f["position"].shape
    # the window's fields read once, the slab's cell / active, cell_start, and
    # the slab's [C, K] f32 output
    nbytes = (ne * (2 * d + 3) * p.position.element_size() + C
              + (C * d * 4 if mod is bs else 0) + cs.numel() * 4
              + C * bs.n_sums(simg.cfg.spec, d) * 4)
    window, plain = ((bs.block_sweep_window, bs.block_sweep_plain) if mod is bs
                     else (cw.cell_sweep_window, cw.cell_sweep_plain))
    args = (simg.cfg.spec, simg.cfg.grid, pl, cs_ext, f["position"], f["density"],
            f["pressure"], f["velocity"])
    call = lambda: window(*args, f["motion_limiter"], self_off)  # noqa: E731
    ms = time_cuda(call, 20)
    name = "block_sweep" if mod is bs else "cell_sweep"
    plain_ms = time_cuda(lambda: plain(*args, block_size=4096,
                                       motion_limiter=f["motion_limiter"],
                                       self_off=self_off), plain_reps)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return {"ms": ms, "ms_per_launch": ms, "kernel_only_ms": kernel_only_ms(call, name),
            "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None, "slab": r, "slab_rows": C, "window_rows": ne,
            "candidates": n_cand, "pairs": n_pair, "approaching_pairs": n_appr,
            "bytes": nbytes, "ops": ops,
            "schedule": schedule(simg, p, cs, mod, r * C, (r + 1) * C)}


# --- 17: the host loop a user runs (run_simulation, checkpoints, VTKHDF) ------------

HOST_INTERVALS = 3       # output intervals of run_simulation_main (0.01 s each)
BLOB_ROWS, BLOB_SPEED = 64, 3.0   # the regrid phase's constructed escape


def host_case(tmp, name):
    """The main deck with examples/dam_break_3d.py's meta: an output every
    0.01 s, the grid-cells file on, saved under ``tmp/name``."""
    arrays, meta, const, kern = case_3d()
    meta = T.replace(meta, simulation_name="DamBreak3D", save_location=str(tmp / name),
                     output_times=0.01, export_grid_cells=True)
    return arrays, meta, const, kern


def h5py_version():
    """h5py's version where it imports (the VTKHDF writers need it), else None."""
    try:
        import h5py
    except ImportError:
        return None
    return h5py.__version__


def full_digest(state):
    """SHA-256 of every tensor of a state: a state nothing wrote into keeps it."""
    h = hashlib.sha256()
    for k, v in state_tensors(state).items():
        h.update(k.encode())
        h.update(v.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def saver(sim, directory, vtk):
    """A save callback: a checkpoint at every counter (with the grid the
    snapshot was stepped on) and, with ``vtk``, the VTKHDF files.  Records
    the counters, the seconds the callback took and the seconds of its first
    copy to the host (one field: the wait for the kernels queued before it
    on the default stream, and the transfer)."""
    record = {"counters": [], "seconds": 0.0, "first_copy_s": 0.0}

    def save(counter, state):
        t0 = time.perf_counter()
        state.particles.position.cpu()
        record["first_copy_s"] += time.perf_counter() - t0
        save_checkpoint(str(directory / f"ckpt_{counter:06d}.npz"), state, counter,
                        grid=sim.cfg.grid)
        if vtk is not None:
            vtk(counter, state)
        record["counters"].append(counter)
        record["seconds"] += time.perf_counter() - t0

    return save, record


def timed_run(sim, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T.run_simulation(sim, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def run_simulation_main(tmp, run):
    """The main deck through ``run_simulation`` for HOST_INTERVALS output
    intervals with a checkpoint (and VTKHDF where h5py imports) at every
    counter on the asynchronous saver; then the same intervals with no save
    callback, and with the saver synchronous, and the same number of steps
    through ``make_fixed_steps_fn`` - all from the same start state."""
    h5 = h5py_version()
    sim = assemble(host_case(tmp, "main"))
    start = sim.state
    ids0, pos0 = start.particles.id.clone(), start.particles.position.clone()
    fixed0 = start.particles.ptype == int(T.ParticleType.FIXED)
    vtk = None
    if h5 is not None:
        from sphexample_tpu_torch.io.output import make_save_callback

        vtk = make_save_callback(sim)
    (tmp / "ckpt").mkdir()
    save, record = saver(sim, tmp / "ckpt", vtk)
    reset_counts()
    wall = timed_run(sim, save_callback=save, max_intervals=HOST_INTERVALS)
    launches = {"block": bs.launches, "cell": cw.launches, "mdbc": mm.launches}
    hg = sim.hourglass
    report = hg.report()
    if vtk is not None:
        vtk.close()
    state = sim.state
    steps = int(state.iteration) - int(start.iteration)
    loop_s, save_s = hg.totals["00 SimulationLoop"], hg.totals["13 Save Particle Data"]
    # the same intervals with no save callback; with the saver synchronous
    bare = assemble(host_case(tmp, "bare"))
    bare_wall = timed_run(bare, max_intervals=HOST_INTERVALS)
    sync = assemble(host_case(tmp, "sync"))
    sync.meta = T.replace(sync.meta, async_output=False)
    (tmp / "ckpt_sync").mkdir()
    save_sync, record_sync = saver(sync, tmp / "ckpt_sync", None)
    sync_wall = timed_run(sync, save_callback=save_sync, max_intervals=HOST_INTERVALS)
    # the fixed-steps loop over the same number of steps (no output times),
    # its graph captured first
    fixed = make_fixed_steps_fn(sim.cfg, steps)
    build_graph(fixed, sim.cfg, start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fixed(start)
    torch.cuda.synchronize()
    fixed_wall = time.perf_counter() - t0
    n = sim.n_live
    rec = {
        "phase": "run_simulation_main", "n": n, "intervals": HOST_INTERVALS,
        "steps": steps, "sim_time_s": float(state.total_time),
        "counters_saved": record["counters"], "h5py": h5,
        "wall_s": wall, "wall_ms_per_step": 1e3 * wall / steps,
        "particle_steps_per_s": n * steps / wall,
        "loop_ms_per_step": 1e3 * loop_s / steps,
        "no_save_wall_ms_per_step": 1e3 * bare_wall / steps,
        "sync_save_wall_ms_per_step": 1e3 * sync_wall / steps,
        "fixed_steps_ms_per_step_same_steps": 1e3 * fixed_wall / steps,
        "interval_graph": graph_numbers(sim.interval_fn.chunk),
        "run_phase_fixed_steps_ms_per_step": run["ms_per_step"],
        "save_section_s": save_s, "save_share_of_wall": save_s / wall,
        "save_callback_s": record["seconds"],
        "sync_save_callback_s": record_sync["seconds"],
        "save_first_copy_s": record["first_copy_s"],
        "sync_save_first_copy_s": record_sync["first_copy_s"],
        "retunes": hg.counts.get("02b Retune neighbor windows", 0),
        "block_sweep_launches": launches["block"], "cell_sweep_launches": launches["cell"],
        "mdbc_launches": launches["mdbc"],
        "hourglass": {k: [hg.counts[k], hg.totals[k]] for k in hg.totals},
        "hourglass_report": report,
        **physics(sim, ids0, pos0, fixed0, state),
        "end_digest": end_digest(state), "no_save_end_digest": end_digest(bare.state),
        "sync_save_end_digest": end_digest(sync.state),
    }
    emit(rec)
    physics_gates(sim, rec, "run_simulation_main")
    if rec["counters_saved"] != list(range(1, HOST_INTERVALS + 2)):
        fail(f"run_simulation_main: saved counters {rec['counters_saved']}")
    if launches != {"block": 2 * steps, "cell": 0, "mdbc": 0}:
        fail(f"run_simulation_main: launches {launches} in {steps} steps")
    if not rec["end_digest"] == rec["no_save_end_digest"] == rec["sync_save_end_digest"]:
        fail("run_simulation_main: saving changed the run's end state")
    if rec["retunes"]:
        fail("run_simulation_main: the main deck re-gridded")
    return sim, rec


def checkpoint_resume(tmp, main_rec):
    """The checkpoint of counter 3 resumed into a freshly assembled main deck
    and run one more interval: the straight run's end state, bit for bit."""
    sim, counter = resume_simulation(assemble(host_case(tmp, "resume")),
                                     str(tmp / "ckpt" / "ckpt_000003.npz"))
    on_card = sim.state.particles.position.device.type == "cuda"
    it0 = int(sim.state.iteration)
    reset_counts()
    wall = timed_run(sim, start_counter=counter, max_intervals=1)
    rec = {"phase": "checkpoint_resume", "counter": counter, "on_card": on_card,
           "steps": int(sim.state.iteration) - it0, "wall_s": wall,
           "block_sweep_launches": bs.launches, "end_digest": end_digest(sim.state)}
    rec["end_state_vs_straight_run_bitwise"] = rec["end_digest"] == main_rec["end_digest"]
    emit(rec)
    if counter != 3 or not on_card:
        fail(f"checkpoint_resume: counter {counter}, on the card {on_card}")
    if not rec["end_state_vs_straight_run_bitwise"]:
        fail("checkpoint_resume: the resumed run ends off the straight run")


def escaping_blob(sim):
    """A constructed state: the main deck with its BLOB_ROWS highest fluid
    rows moved into a 4 x 4 x 4 lattice (spacing dx) centred half a cell
    below the static grid's top edge, above the open tank, at +BLOB_SPEED m/s
    in z: they leave the grid within the first output interval."""
    p = sim.state.particles
    H, dx = sim.cfg.spec.kernel.H, sim.cfg.spec.constants.dx
    grid = sim.cfg.grid
    z_top = (grid.cmin[2] + grid.shape[2] - 0.5) * H
    fluid = torch.nonzero(p.ptype == int(T.ParticleType.FLUID)).squeeze(1)
    rows = fluid[torch.argsort(p.position[fluid, 2], descending=True)[:BLOB_ROWS]]
    lattice = torch.stack(torch.meshgrid(*[torch.arange(4.0)] * 3, indexing="ij"),
                          dim=-1).reshape(-1, 3).to(p.position) * dx
    centre = torch.cat([p.position[:, :2].mean(0), p.position.new_tensor([z_top - H / 2])])
    pos, vel = p.position.clone(), p.velocity.clone()
    pos[rows] = centre + lattice - lattice.mean(0)
    vel[rows] = vel.new_tensor([0.0, 0.0, BLOB_SPEED])
    sim.state = sim.state.replace(particles=p.replace(position=pos, velocity=vel))
    return {"constructed_state": f"{BLOB_ROWS} fluid rows moved into a blob H/2 below "
                                 f"the grid's top edge at +{BLOB_SPEED} m/s in z",
            "blob_z_m": float(centre[2]), "grid_top_m": z_top}


def regrid(tmp):
    """A grid escape on the card: with ``auto_retune=False`` the driver
    raises and leaves the pre-interval state as it was; by default it grows
    the grid and replays the interval on the grown grid."""
    sim = assemble(host_case(tmp, "regrid"))
    rec = {"phase": "regrid", **escaping_blob(sim)}
    first = sim.state
    digest0 = full_digest(first)
    grid0 = sim.cfg.grid
    t0 = time.perf_counter()
    try:
        T.run_simulation(sim, max_intervals=1, auto_retune=False)
    except RuntimeError as e:
        rec["auto_retune_off_error"] = str(e)
    rec["failed_interval_s"] = time.perf_counter() - t0
    rec["pre_interval_state_unchanged"] = (sim.state is first
                                           and full_digest(first) == digest0)
    calls, restore = counted_steps()
    reset_counts()
    try:
        wall = timed_run(sim, max_intervals=1)
    finally:
        restore()
    launches = {"block": bs.launches, "cell": cw.launches}
    state, grid = sim.state, sim.cfg.grid
    p = state.particles
    c = cl.cell_coords(p.position[p.active], sim.cfg.spec.kernel.H_inv)
    inside = bool((c == cl.clamp_coords(c, grid)).all())
    rec.update(
        grid_shape_before=list(grid0.shape), grid_shape_after=list(grid.shape),
        grid_cmin_before=list(grid0.cmin), grid_cmin_after=list(grid.cmin),
        replays=sim.hourglass.counts.get("02b Retune neighbor windows", 0),
        retune_s=sim.hourglass.totals.get("02b Retune neighbor windows", 0.0),
        wall_s=wall, steps_taken=calls[0], steps_kept=int(state.iteration),
        block_sweep_launches=launches["block"], cell_sweep_launches=launches["cell"],
        grid_escapes=int(state.grid_escapes), live_rows_inside_grid=inside)
    emit(rec)
    if "escaped" not in rec.get("auto_retune_off_error", ""):
        fail("regrid: auto_retune=False did not raise on the escape")
    if not rec["pre_interval_state_unchanged"]:
        fail("regrid: the failed interval wrote into the pre-interval state")
    if not (grid.ncells > grid0.ncells and rec["replays"] >= 1):
        fail("regrid: the grid did not grow")
    if rec["grid_escapes"] != 0 or not inside:
        fail("regrid: particles outside the grown grid after the replay")
    if launches != {"block": 2 * calls[0], "cell": 0}:
        fail(f"regrid: launches {launches} in {calls[0]} steps")
    compare(sim, p, state.cell_start, "parity_after_regrid")
    return end_summary(state), rec


def run_simulation_mdbc(tmp):
    """The mDBC deck for one output interval through ``run_simulation`` with
    the checkpoint saver: one fused mDBC call (and its 4 grouping kernels)
    per step, and the checkpoint written at the end loads back equal."""
    arrays, meta, const, kern = case_3d()
    meta = T.replace(meta, save_location=str(tmp / "mdbc"), output_times=0.01)
    sim = assemble_mdbc((arrays, meta, const, kern))
    start = sim.state
    ids0, pos0 = start.particles.id.clone(), start.particles.position.clone()
    fixed0 = start.particles.ptype == int(T.ParticleType.FIXED)
    (tmp / "ckpt_mdbc").mkdir()
    save, record = saver(sim, tmp / "ckpt_mdbc", None)
    reset_counts()
    wall = timed_run(sim, save_callback=save, max_intervals=1)
    launches = {"block": bs.launches, "cell": cw.launches, "mdbc": mm.launches,
                "grouping": mm.group_launches}
    state = sim.state
    steps = int(state.iteration) - int(start.iteration)
    back, counter = load_checkpoint(str(tmp / "ckpt_mdbc" / "ckpt_000002.npz"), state)
    ta, tb = state_tensors(back), state_tensors(state)
    rec = {"phase": "run_simulation_mdbc", "n": sim.n_live, "steps": steps,
           "wall_s": wall, "wall_ms_per_step": 1e3 * wall / steps,
           "counters_saved": record["counters"], "save_callback_s": record["seconds"],
           **{f"{k}_launches": v for k, v in launches.items()},
           **physics(sim, ids0, pos0, fixed0, state),
           "checkpoint_counter": counter,
           "checkpoint_loads_back_equal": all(torch.equal(ta[k], tb[k]) for k in ta)
           and int(back.rebuilds) == int(state.rebuilds),
           "end_digest": end_digest(state)}
    emit(rec)
    physics_gates(sim, rec, "run_simulation_mdbc")
    if launches != {"block": 2 * steps, "cell": 0, "mdbc": steps,
                    "grouping": len(GROUP_KERNELS) * steps}:
        fail(f"run_simulation_mdbc: launches {launches} in {steps} steps")
    if rec["boundary_rows_off_rho0"] == 0:
        fail("run_simulation_mdbc: no boundary density moved off rho0 - mDBC did not fire")
    if record["counters"] != [1, 2] or counter != 2 or not rec["checkpoint_loads_back_equal"]:
        fail("run_simulation_mdbc: the checkpoint does not load back equal")


def determinism():
    """``check_determinism`` (5 steps twice, every tensor bit for bit) on the
    main deck (the block sweep) and the mDBC deck (block sweep + mDBC)."""
    rec = {"phase": "determinism", "steps": 5,
           "main_deck": check_determinism(assemble(case_3d()), 5),
           "mdbc_deck": check_determinism(assemble_mdbc(case_3d()), 5)}
    emit(rec)
    if not (rec["main_deck"] and rec["mdbc_deck"]):
        fail(f"determinism: {rec}")


def output_phase(tmp, main_sim):
    """The VTKHDF of run_simulation_main read back with the port's reader,
    where h5py imports: 4 steps, each step's positions and densities those
    of the checkpoint of the same counter, cast to the file's dtype; and a
    grid-cells file of 3 steps: the initial snapshot has no cell list yet
    (its ``cell_start`` is all zeros until the first step rebuilds), so it
    writes no grid step - as in the JAX package."""
    h5 = h5py_version()
    rec = {"phase": "output", "h5py": h5}
    if h5 is None:
        rec["note"] = "h5py does not import here: no VTKHDF written or read"
        emit(rec)
        return
    import h5py

    from sphexample_tpu_torch.io.vtkhdf import read_transient_polydata

    base = tmp / "main" / "DamBreak3D"
    n = main_sim.n_live
    with h5py.File(f"{base}.vtkhdf", "r", locking=False) as f:
        rec["NSteps"] = int(f["VTKHDF"]["Steps"].attrs["NSteps"])
    with h5py.File(f"{base}_GridCells.vtkhdf", "r", locking=False) as f:
        rec["grid_cells_NSteps"] = int(f["VTKHDF"]["Steps"].attrs["NSteps"])
    equal = []
    for k, (t, pts, data) in enumerate(read_transient_polydata(
            f"{base}.vtkhdf", variables=["Density"]), start=1):
        ck, _ = load_checkpoint(str(tmp / "ckpt" / f"ckpt_{k:06d}.npz"), main_sim.state)
        pos = ck.particles.position[:n].cpu().numpy().astype(pts.dtype)
        rho = ck.particles.density[:n].cpu().numpy().astype(data["Density"].dtype)
        equal.append(bool(np.array_equal(pts, pos) and np.array_equal(data["Density"], rho)
                          and t == float(ck.total_time)))
    rec["steps_equal_to_checkpoints"] = equal
    emit(rec)
    if rec["NSteps"] != HOST_INTERVALS + 1 or rec["grid_cells_NSteps"] != HOST_INTERVALS:
        fail(f"output: {rec['NSteps']} particle steps, {rec['grid_cells_NSteps']} grid steps")
    if equal != [True] * (HOST_INTERVALS + 1):
        fail(f"output: the file's steps differ from the checkpoints: {equal}")


def host_loop_phases(run):
    """Phases 17: the host loop on the main and mDBC decks, under a temporary
    directory removed at the end.  Returns the main run's record and the
    re-gridded run's end state (what phase 18 holds its runs against)."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        main_sim, main_rec = run_simulation_main(tmp, run)
        checkpoint_resume(tmp, main_rec)
        regrid_end, regrid_rec = regrid(tmp)
        run_simulation_mdbc(tmp)
        determinism()
        output_phase(tmp, main_sim)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return main_rec, regrid_end, regrid_rec


# --- 18: the deck CLIs a user runs, the sharded retune, the neighbor list ----------

CLI_INTERVALS = 3        # examples_main: output intervals of the 3D dam break deck
HALO_CUT = 128           # sharded_halo_retune: the halo the main deck's slabs get


def cli(deck, argv, tmp, name, card, on_save=None):
    """``python -m sphexample_tpu_torch.examples.<deck> argv`` in this process,
    its standard output (the run's log) into ``tmp/name.log``, its standard
    error kept; every checkpoint it writes is also copied to
    ``tmp/name_ckpt/<counter>.npz``; ``on_save(counter, state)``, if given,
    is called on every snapshot before the deck's own save callback.  Launch
    counts start from 0.  Returns (simulation, record, the checkpoints'
    directory): wall seconds, the steps taken (per slab), ms per step by the
    wall and by the interval loop, the checkpoints' counters, the card, what
    it said on stderr."""
    import contextlib
    import importlib
    import io

    from sphexample_tpu_torch.core import driver
    from sphexample_tpu_torch.io import checkpoint as ck

    kept = tmp / f"{name}_ckpt"
    kept.mkdir(exist_ok=True)
    counters = []
    real = ck.save_checkpoint

    def save_checkpoint(path, state, counter, grid=None):
        real(path, state, counter, grid=grid)
        shutil.copy(path, kept / f"{counter}.npz")
        counters.append(counter)

    real_run = driver.run_simulation

    def run_simulation(sim, save_callback=None, **kw):
        def save(counter, state):
            on_save(counter, state)
            if save_callback is not None:
                save_callback(counter, state)

        return real_run(sim, save_callback=save, **kw)

    mod = importlib.import_module(f"sphexample_tpu_torch.examples.{deck}")
    err = io.StringIO()
    ck.save_checkpoint = save_checkpoint
    if on_save is not None:
        driver.run_simulation = run_simulation
    calls, restore = counted_steps()
    reset_counts()
    try:
        with open(tmp / f"{name}.log", "w") as out, contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim = mod.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        ck.save_checkpoint = real
        driver.run_simulation = real_run
        restore()
    slabs = len(sim.state) if isinstance(sim.state, tuple) else 1
    lead = sim.state[0] if slabs > 1 else sim.state
    hg = sim.hourglass
    steps = calls[0]
    chunk = getattr(sim.interval_fn, "chunk", None)
    rec = {"phase": name, "deck": deck, "argv": argv, "n": sim.n_live, "card": card,
           "wall_s": wall, "steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
           "loop_ms_per_step": 1e3 * hg.totals["00 SimulationLoop"] / steps,
           "iteration": int(lead.iteration), "sim_time_s": float(lead.total_time),
           "retunes": hg.counts.get("02b Retune neighbor windows", 0),
           "checkpoint_counters": counters, "stderr": err.getvalue()[-2000:],
           "chunk": getattr(chunk, "route", None),
           "graph": graph_numbers(chunk) if getattr(chunk, "graph", None) else None,
           "launches": {"block": bs.launches, "cell": cw.launches,
                        "block_window": bs.window_launches, "cell_window": cw.window_launches,
                        "mdbc": mm.launches, "grouping": mm.group_launches}}
    return sim, rec, kept


def deck_launches(steps, mdbc_on):
    """The launch counts a single-device deck on the block sweep takes in
    ``steps`` steps: 2 block-sweep launches a step and, with mDBC, 1 fused
    mDBC call and its grouping kernels."""
    return {"block": 2 * steps, "cell": 0, "block_window": 0, "cell_window": 0,
            "mdbc": steps if mdbc_on else 0,
            "grouping": len(GROUP_KERNELS) * steps if mdbc_on else 0}


def examples_main(tmp, main_rec, card):
    """The 3D dam break deck as a user runs it, at its default dx (159,712
    particles), CLI_INTERVALS intervals with a checkpoint per counter: the
    end state bit for bit that of run_simulation_main (the same deck, meta
    and intervals through run_simulation)."""
    from sphexample_tpu_torch.examples._runner import NO_H5PY

    h5 = h5py_version()
    save = tmp / "cli_main"
    sim, rec, kept = cli(
        "dam_break_3d", ["--max-intervals", str(CLI_INTERVALS), "--checkpoint-every", "1",
                         "--save", str(save)], tmp, "examples_main", card)
    state, steps = sim.state, rec["steps"]
    rec.update(
        h5py=h5, h5py_notice=NO_H5PY in rec["stderr"],
        paraview_state_file=(save / "DamBreak3D_SingleVTKHDFStateFile.py").is_file(),
        vtkhdf_files=sorted(f.name for f in save.glob("*.vtkhdf")),
        end_digest=end_digest(state),
        end_digest_run_simulation_main=main_rec["end_digest"])
    rec["end_state_vs_run_simulation_main_bitwise"] = (
        rec["end_digest"] == main_rec["end_digest"])
    emit(rec)
    if sim.n_live != main_rec["n"]:
        fail(f"examples_main: {sim.n_live} particles, not run_simulation_main's "
             f"{main_rec['n']}")
    if rec["checkpoint_counters"] != list(range(1, CLI_INTERVALS + 2)):
        fail(f"examples_main: checkpoints for counters {rec['checkpoint_counters']}")
    if rec["h5py_notice"] != (h5 is None) or (h5 is None) == bool(rec["vtkhdf_files"]):
        fail(f"examples_main: h5py {h5}, notice printed {rec['h5py_notice']}, "
             f"files {rec['vtkhdf_files']}")
    if rec["launches"] != deck_launches(steps, mdbc_on=False):
        fail(f"examples_main: launches {rec['launches']} in {steps} steps")
    if not rec["paraview_state_file"]:
        fail("examples_main: no ParaView state file")
    if not rec["end_state_vs_run_simulation_main_bitwise"]:
        fail("examples_main: the CLI run ends off run_simulation_main")
    return sim, rec, kept


def examples_resume(tmp, main_rec, kept, card):
    """``--resume`` from the examples_main checkpoint of counter 3, one
    interval: the straight run's end state."""
    save = tmp / "cli_main"
    sim, rec, _ = cli(
        "dam_break_3d", ["--resume", str(kept / "3.npz"), "--max-intervals", "1",
                         "--save", str(save)], tmp, "examples_resume", card)
    rec["end_digest"] = end_digest(sim.state)
    rec["end_state_vs_straight_run_bitwise"] = rec["end_digest"] == main_rec["end_digest"]
    emit(rec)
    if not rec["end_state_vs_straight_run_bitwise"]:
        fail("examples_resume: the resumed CLI run ends off the straight run")
    if rec["iteration"] != main_rec["iteration"] or rec["launches"]["block"] != 2 * rec["steps"]:
        fail("examples_resume: a different number of steps, or not 2 launches a step")


def examples_shard(tmp, main_kept, card):
    """``--shard 4``, one interval: 2 windowed block-sweep launches per step
    per slab and no single-device launch; the end state within the
    trajectory bands of the single-device CLI run's state at counter 2."""
    sim, rec, _ = cli(
        "dam_break_3d", ["--shard", str(N_SLABS), "--max-intervals", "1",
                         "--save", str(tmp / "cli_shard")], tmp, "examples_shard", card)
    steps = rec["steps"]
    state = gather_state(sim.state, "cuda:0")
    ref, counter = load_checkpoint(str(main_kept / "2.npz"), state)
    in_bands, diffs = in_trajectory_bands(end_summary(state), end_summary(ref))
    rec.update(slabs=len(sim.state), halo=sim.cfg.halo, sweep_kernel=sim.cfg.sweep_kernel,
               vs_single_device_cli_in_bands=in_bands, vs_single_device_cli_max_abs=diffs,
               vs_single_device_cli_bitwise=all(v == 0.0 for v in diffs.values()),
               max_halo=int(state.max_halo))
    emit(rec)
    want = {"block": 0, "cell": 0, "block_window": 2 * steps * N_SLABS, "cell_window": 0,
            "mdbc": 0, "grouping": 0}
    if rec["launches"] != want or counter != 2:
        fail(f"examples_shard: launches {rec['launches']} in {steps} steps on {N_SLABS} "
             "slabs")
    if rec["chunk"] != chunk_route(sim.mesh) or (rec["chunk"] == "graph") != bool(rec["graph"]):
        fail(f"examples_shard: the chunk took the {rec['chunk']} route")
    if not (in_bands and (rec["halo"] == 0 or 0 < rec["max_halo"] <= rec["halo"])):
        fail(f"examples_shard: off the single-device CLI run: {diffs}")


def examples_mdbc(tmp, card):
    """The 2D mDBC dam-break deck (dam_break_2d_mdbc, its file layout) on
    CSVs written from this script's own 2D three-layer mDBC dam break (the
    deck's dx and constants): one interval, exactly one mDBC call (and its
    grouping kernels) and two block-sweep launches per step."""
    (pos, dens, _, _, idp), ghost, normals, _, _, _ = mdbc_dam_break(case_2d())
    nb = len(ghost)
    root = tmp / "input" / "dam_break_2d"
    root.mkdir(parents=True)
    base = root / "DamBreak2d_Dp0.02_MDBC"

    def xz(a):
        return np.stack([a[:, 0], np.zeros(len(a)), a[:, 1]], axis=-1)

    def write(path, header, rows):
        with open(path, "w") as fh:
            fh.write(header + "\n")
            for row in rows:
                fh.write(",".join(repr(float(v)) for v in row) + "\n")

    cols = "Points:0,Points:1,Points:2,Idp,Rhop"
    parts = np.concatenate([xz(pos), (idp - 1)[:, None], dens[:, None]], axis=1)
    write(f"{base}_Bound_ThreeLayers.csv", cols, parts[:nb])
    write(f"{base}_Fluid_ThreeLayers.csv", cols, parts[nb:])
    write(f"{base}_GhostNodes_ThreeLayers.csv",
          "Normal:0,Normal:1,Normal:2,Points:0,Points:1,Points:2",
          np.concatenate([xz(normals), xz(pos[:nb])], axis=1))
    before = dict(native.calls)
    sim, rec, _ = cli(
        "dam_break_2d_mdbc", ["--input", str(tmp / "input"), "--max-intervals", "1",
                              "--save", str(tmp / "cli_mdbc")], tmp, "examples_mdbc", card)
    rec["csv_readers"] = {k: native.calls[k] - before[k] for k in before}
    state, steps = sim.state, rec["steps"]
    p = state.particles
    rho_b = p.density[(p.ptype == int(T.ParticleType.FIXED)) & p.active]
    rec.update(ghosts=sim.cfg.boundary_capacity,
               finite=bool(torch.isfinite(p.density).all() and torch.isfinite(p.position).all()),
               boundary_rows_off_rho0=int((rho_b != 1000.0).sum()),
               grid_escapes=int(state.grid_escapes))
    emit(rec)
    if rec["launches"] != deck_launches(steps, mdbc_on=True):
        fail(f"examples_mdbc: launches {rec['launches']} in {steps} steps")
    if sim.cfg.boundary_capacity != nb or not rec["finite"] or not rec["boundary_rows_off_rho0"]:
        fail("examples_mdbc: the deck did not load its ghosts, or mDBC did not fire")
    if rec["csv_readers"] != {"native": 3, "python": 0}:
        fail(f"examples_mdbc: the native reader did not serve its 3 CSVs: "
             f"{rec['csv_readers']}")


def examples_profile(tmp, card):
    """``--profile DIR`` over two intervals: a Chrome trace of the second
    that names the block-sweep kernel."""
    prof = tmp / "profile"
    _, rec, _ = cli(
        "dam_break_3d", ["--max-intervals", "2", "--profile", str(prof),
                         "--save", str(tmp / "cli_profile")], tmp, "profile", card)
    trace = prof / "trace.json"
    text = trace.read_text() if trace.is_file() else ""
    events = json.loads(text)["traceEvents"] if text else []
    kernels = [e for e in events if e.get("cat") == "kernel"]
    rec.update(trace_bytes=len(text), names_block_sweep_kernel="block_sweep_kernel" in text,
               kernel_events=len(kernels),
               block_sweep_kernel_events=sum("block_sweep_kernel" in e.get("name", "")
                                             for e in kernels))
    del rec["stderr"]
    emit(rec)
    if not rec["names_block_sweep_kernel"]:
        fail("profile: the trace does not name the block-sweep kernel")


def slab_digests(states):
    return [full_digest(s) for s in states]


def counted_steps():
    """Count the steps the interval loop takes (a replayed interval's
    included; a sharded run's loop steps every slab at once) until the
    returned function restores the count's hook; returns (calls list,
    restore).  The steps are read from the iteration the loop reads after
    each chunk (``core/step.py:_check_interval_progress``): in a chunk graph
    ``sph_step`` runs only while the graph is captured."""
    from sphexample_tpu_torch.core import step as step_mod

    calls = [0]
    real = step_mod._check_interval_progress

    def counted(t, it, t_out, it_before):
        calls[0] += it - it_before
        return real(t, it, t_out, it_before)

    step_mod._check_interval_progress = counted
    return calls, lambda: setattr(step_mod, "_check_interval_progress", real)


def sharded_regrid(tmp, regrid_end, card):
    """Phase 17's escaping blob on 4 slabs through ``run_simulation``: the
    failed interval re-gridded, re-sharded over the same mesh and replayed;
    the pre-interval slabs untouched; B2 against its plain version on the
    grown grid; the end state against the single-device regrid run's."""
    sim = assemble(host_case(tmp, "sregrid"))
    blob = escaping_blob(sim)
    sim_sh = shard_simulation(sim, make_mesh(N_SLABS))
    del sim
    first, grid0, halo0, mesh0 = sim_sh.state, sim_sh.cfg.grid, sim_sh.cfg.halo, sim_sh.mesh
    digests0 = slab_digests(first)
    calls, restore = counted_steps()
    reset_counts()
    try:
        wall = timed_run(sim_sh, max_intervals=1)
    finally:
        restore()
    launches = {"block": bs.launches, "block_window": bs.window_launches,
                "cell": cw.launches + cw.window_launches}
    state = gather_state(sim_sh.state, "cuda:0")
    hg = sim_sh.hourglass
    end = end_summary(state)
    in_bands, diffs = in_trajectory_bands(end, regrid_end)
    rec = {"phase": "sharded_regrid", **blob, "slabs": N_SLABS, "card": card,
           "grid_shape_before": list(grid0.shape), "grid_shape_after": list(sim_sh.cfg.grid.shape),
           "halo_before": halo0, "halo_after": sim_sh.cfg.halo, "same_mesh": sim_sh.mesh == mesh0,
           "replays": hg.counts.get("02b Retune neighbor windows", 0),
           "retune_s": hg.totals.get("02b Retune neighbor windows", 0.0), "wall_s": wall,
           "chunk": sim_sh.interval_fn.chunk.route,
           "graph": (graph_numbers(sim_sh.interval_fn.chunk)
                     if sim_sh.interval_fn.chunk.graph is not None else None),
           "steps_taken": calls[0], "rank_steps_taken": calls[0] * N_SLABS,
           "steps_kept": int(state.iteration),
           "wall_ms_per_step_kept": 1e3 * wall / max(int(state.iteration), 1),
           "launches": launches, "grid_escapes": int(state.grid_escapes),
           "max_halo": int(state.max_halo),
           "pre_interval_slabs_unchanged": slab_digests(first) == digests0,
           "vs_single_device_regrid_in_bands": in_bands,
           "vs_single_device_regrid_max_abs": diffs,
           "vs_single_device_regrid_bitwise": all(v == 0.0 for v in diffs.values()),
           "end_digest": end_digest(state)}
    emit(rec)
    if not (rec["replays"] >= 1 and sim_sh.cfg.grid.ncells > grid0.ncells
            and isinstance(sim_sh.state, tuple) and rec["same_mesh"]):
        fail("sharded_regrid: the failed interval was not re-gridded and re-sharded")
    if not rec["pre_interval_slabs_unchanged"]:
        fail("sharded_regrid: the failed interval wrote into the pre-interval slabs")
    if rec["grid_escapes"] or not (sim_sh.cfg.halo == 0
                                   or 0 < rec["max_halo"] <= sim_sh.cfg.halo):
        fail("sharded_regrid: escapes or a halo overrun left after the replay")
    if launches != {"block": 0, "block_window": 2 * rec["rank_steps_taken"], "cell": 0}:
        fail(f"sharded_regrid: launches {launches} in {rec['rank_steps_taken']} rank steps")
    if rec["chunk"] != chunk_route(sim_sh.mesh) or (rec["chunk"] == "graph") != bool(rec["graph"]):
        fail(f"sharded_regrid: the chunk took the {rec['chunk']} route")
    if not in_bands:
        fail(f"sharded_regrid: off the single-device regrid run: {diffs}")
    simg = unsharded(sim_sh)
    compare_window(sim_sh, simg, state.particles, state.cell_start,
                   "sharded_parity_after_regrid", bs)


def sharded_halo_retune(tmp, card):
    """The main deck on 4 slabs with the halo cut to HALO_CUT rows: the first
    interval overruns it, the driver re-shards with at least the JAX
    package's floor (``halo_floor``) and replays; the interval completes."""
    from sphexample_tpu_torch.parallel.mesh import halo_floor, make_sharded_interval_fn

    sim_sh = shard_simulation(assemble(host_case(tmp, "shalo")), make_mesh(N_SLABS))
    halo_full = sim_sh.cfg.halo
    cut = dataclasses.replace(sim_sh.cfg, halo=HALO_CUT)
    sim_sh.interval_fn, sim_sh.cfg = make_sharded_interval_fn(cut, sim_sh.mesh)
    inner, needs = sim_sh.interval_fn, []

    def spy(states, t_out, progress=None):
        states = inner(states, t_out, progress)
        needs.append(int(states[0].max_halo))
        return states

    sim_sh.interval_fn = spy
    calls, restore = counted_steps()
    reset_counts()
    try:
        wall = timed_run(sim_sh, max_intervals=1)
    finally:
        restore()
    state = gather_state(sim_sh.state, "cuda:0")
    C = state.particles.capacity // N_SLABS
    floor = halo_floor(needs[0], HALO_CUT) if needs else None
    rec = {"phase": "sharded_halo_retune", "slabs": N_SLABS, "card": card,
           "halo_assembled": halo_full, "halo_cut": HALO_CUT, "failed_max_halo": needs[:1],
           "jax_floor": floor, "slab_rows": C, "halo_after": sim_sh.cfg.halo,
           "replays": sim_sh.hourglass.counts.get("02b Retune neighbor windows", 0),
           "wall_s": wall,
           "chunk": getattr(getattr(sim_sh.interval_fn, "chunk", None), "route", None),
           "steps_taken": calls[0], "rank_steps_taken": calls[0] * N_SLABS,
           "steps_kept": int(state.iteration),
           "max_halo": int(state.max_halo), "window_launches": bs.window_launches,
           "finite": bool(torch.isfinite(state.particles.position).all())}
    emit(rec)
    want = floor if floor is not None and -(-floor // 128) * 128 <= C else 0
    if not (rec["replays"] == 1 and needs and needs[0] > HALO_CUT):
        fail("sharded_halo_retune: the cut halo did not overrun and retune once")
    if not (sim_sh.cfg.halo >= want and (want or sim_sh.cfg.halo == 0)):
        fail(f"sharded_halo_retune: halo {sim_sh.cfg.halo} below the floor {floor}")
    if not (state.iteration > 0 and rec["max_halo"] <= sim_sh.cfg.halo and rec["finite"]):
        fail("sharded_halo_retune: the replayed interval did not complete")
    if bs.window_launches != 2 * rec["rank_steps_taken"]:
        fail(f"sharded_halo_retune: {bs.window_launches} window launches in "
             f"{rec['rank_steps_taken']} rank steps")
    if rec["chunk"] != chunk_route(sim_sh.mesh):
        fail(f"sharded_halo_retune: the chunk took the {rec['chunk']} route")


def neighbor_list_phase(sim, card):
    """ops/neighbor_list.py (plain PyTorch: the JAX module reaches no Pallas
    kernel) on the main deck's CLI end state: the list sweep against the
    block-sweep kernel below 1e-4 of each field's max; build and sweep ms."""
    from sphexample_tpu_torch.ops.neighbor_list import build_neighbor_list, pair_sweep_list

    spec, grid = sim.cfg.spec, sim.cfg.grid
    state = sim.state
    p, cs = state.particles, state.cell_start
    starts, ends = cl.row_segments(p.cell, grid, cs)
    cseg = int((ends - starts).max())
    K0 = int(starts.shape[1]) * cseg
    block = 2048
    nbr, count = build_neighbor_list(spec.kernel, grid, cseg, K0, block, p, cs)
    K = int(count)
    nbr = nbr[:, :K].contiguous()
    args = (p, p.position, p.density, p.pressure, p.velocity)
    out = pair_sweep_list(spec, grid, nbr, block, *args)
    k = bs.block_sweep(spec, grid, p, cs, *args[1:])
    torch.cuda.synchronize()
    d = sweep_diff(k, out, "neighbor_list")
    rec = {"phase": "neighbor_list", "n": sim.n_live, "card": card, "cseg": cseg,
           "max_count": K, "list_entries": int((nbr < p.capacity).sum()),
           **d, "max_rel": max(v for key, v in d.items() if key.endswith("_rel")),
           "build_ms": time_cuda(lambda: build_neighbor_list(spec.kernel, grid, cseg, K,
                                                             block, p, cs), 3),
           "list_sweep_ms": time_cuda(lambda: pair_sweep_list(spec, grid, nbr, block,
                                                              *args), 3),
           "block_sweep_ms": time_cuda(lambda: bs.block_sweep(spec, grid, p, cs, *args[1:]),
                                       20)}
    emit(rec)
    if rec["max_rel"] >= REL_TOL:
        fail("neighbor_list: the list sweep and the block-sweep kernel disagree")


def cli_phases(main_rec, regrid_end, card):
    """Phases 18, under a temporary directory removed at the end."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        sim, rec, kept = examples_main(tmp, main_rec, card)
        neighbor_list_phase(sim, card)
        del sim
        examples_resume(tmp, rec, kept, card)
        examples_shard(tmp, kept, card)
        examples_mdbc(tmp, card)
        examples_profile(tmp, card)
        torch.cuda.empty_cache()
        sharded_regrid(tmp, regrid_end, card)
        torch.cuda.empty_cache()
        sharded_halo_retune(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- 19: the main deck to its end time, the native CSV reader, the 2D physics -------

# the JAX package's record of the full run (PERFORMANCE.md:36-68, read with
# tools/analyze_dambreak.py): 18,026 steps to t = 1.6 s, the front at the far
# wall (x = 1.6 - 3 dx) by t ~ 0.6 s, a peak surge speed of 2.8 m/s, fluid
# density within [991.7, 1007.8], |v|max ~ 1.1 m/s at the end, no NaN
END_OUTPUTS = 161        # the initial snapshot and one per 0.01 s to t = 1.6 s
END_STEPS = (17846, 18206)       # 18,026 +- 1 %
END_STEPS_EAGER = 18026          # the eager loop's step count on the card (PERF.md §6)
FAR_WALL_X = 1.575               # 1.6 - 3 dx
ARRIVAL_S = (0.50, 0.70)         # the first output time with x_front >= FAR_WALL_X
SURGE_MS = (2.5, 3.1)            # the largest |v|max before that output
SETTLED_MS = 2.0                 # |v|max at t = 1.6 s stays below
# The record's density band, +-1 %, is not the JAX package's own: on this
# deck at its dx 0.0085 (to t = 0.03 s, compare_dam_break.py on the CPU) it
# reads 1017.21 at t = 0.03 s, as the port does here, and at dx 0.04 (to
# t = 1.6 s) the extremes the port reads, to 0.01 kg/m^3: both leave the
# band at the column's first compression and at the wall impact.  The
# gate on every output is the band of the JAX package's dam-break test
# (tests/test_physics_validation.py:69-71); the particles outside the
# record's band are counted and printed.
RECORD_RHO = (990.0, 1010.0)
END_RHO = (850.0, 1150.0)
XT_EVERY = 10                    # rows of the printed X(T) table
# tests/test_physics_validation.py's 2D front-speed case through either
# package on the CPU (tests/test_torch_physics_validation.py)
CPU_FRONT_RATIO = 0.6086415165946446


def fixed_rows(state):
    """The fixed particles' positions in ID order (a copy)."""
    p = state.particles
    order = torch.argsort(p.id)
    keep = (p.id[order] > 0) & (p.ptype[order] == int(T.ParticleType.FIXED))
    return p.position[order][keep].clone()


def xt_table(readings):
    """The X(T) series as tools/analyze_dambreak.py prints it."""
    lines = [f"{'t [s]':>8} {'T=t√(2g/L)':>11} {'x_front':>9} {'X=x/L':>7} "
             f"{'rho_min':>9} {'rho_max':>9} {'|v|_max':>8} {'NaN':>5}"]
    for r in readings:
        lines.append(f"{r['t']:8.4f} {r['T']:11.3f} {r['x_front']:9.4f} {r['X']:7.3f} "
                     f"{r['rho_min']:9.2f} {r['rho_max']:9.2f} {r['vmax']:8.3f} "
                     f"{r['nan']:5d}")
    return lines


def native_csv_phase(tmp, card):
    """The main deck's particles written as DualSPHysics CSVs (boundary and
    fluid, ``Idp`` from 0) and read back: the native reader against the
    csv-module path bit for bit, each timed; then ``build_simulation`` from
    the two files on the card: every tensor of its state that of the
    arrays' assembly, and the native reader served both files."""
    case = case_3d()
    (pos, dens, ptype, _, idp), meta, const, kern = case
    paths = []
    for kind, name in ((T.ParticleType.FIXED, "Bound"), (T.ParticleType.FLUID, "Fluid")):
        rows = ptype == int(kind)
        path = tmp / f"DamBreak3d_Dp0.0085_{name}.csv"
        with open(path, "w") as fh:
            fh.write('"Idp","Points:0","Points:1","Points:2","Rhop"\n')
            fh.writelines(f"{i},{x!r},{y!r},{z!r},{r!r}\n" for i, (x, y, z), r in zip(
                (idp[rows] - 1).tolist(), pos[rows].tolist(), dens[rows].tolist()))
        paths.append(str(path))
    cols = ["Points:0", "Points:1", "Points:2", "Rhop", "Idp"]
    t0 = time.perf_counter()
    fast = [native.read_csv_columns(p, cols) for p in paths]
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = [csv_io.read_csv_columns_plain(p, cols) for p in paths]
    plain_s = time.perf_counter() - t0
    bitwise = all(a is not None and a.shape == b.shape
                  and np.array_equal(a.view(np.int64), b.view(np.int64))
                  for a, b in zip(fast, slow))
    before = dict(native.calls)
    geoms = [T.Geometry(paths[0], 1, T.ParticleType.FIXED),
             T.Geometry(paths[1], 2, T.ParticleType.FLUID)]
    sim = T.build_simulation(geoms, meta, const, kern, T.ViscosityModel.ARTIFICIAL,
                             T.DensityDiffusionModel.LINEAR, device="cuda")
    served = {k: native.calls[k] - before[k] for k in before}
    same = full_digest(sim.state) == full_digest(assemble(case).state)
    rec = {"phase": "native_csv", "card": card, "rows": [len(a) for a in slow],
           "bytes": sum(os.path.getsize(p) for p in paths), "native_s": native_s,
           "plain_s": plain_s, "native_vs_plain_bitwise": bitwise,
           "build_simulation_readers": served,
           "build_simulation_state_vs_arrays_bitwise": same}
    emit(rec)
    if not bitwise:
        fail("native_csv: the native reader and the csv-module path disagree")
    if served != {"native": 2, "python": 0} or not same:
        fail(f"native_csv: build_simulation from the CSVs: readers {served}, "
             f"state as the arrays' {same}")


def end_time_main(tmp, card, series_path=None):
    """``python -m sphexample_tpu_torch.examples.dam_break_3d`` as a user runs
    it, from t = 0 to its end time 1.6 s (159,712 particles, an output every
    0.01 s, one checkpoint, at the last counter), with the readings of
    tools/analyze_dambreak.py reduced on the card at every output; held to
    the JAX package's record of the same run (the bands above)."""
    readings, walls = [], {}

    def on_save(counter, state):
        if counter == 1:
            walls["start"] = fixed_rows(state)
        p = state.particles
        rho = p.density[p.active & (p.ptype == int(T.ParticleType.FLUID))]
        outside = int(((rho < RECORD_RHO[0]) | (rho > RECORD_RHO[1])).sum())
        readings.append({"counter": counter, **dam_break_readings(state),
                         "outside_record_rho": outside})

    sim, rec, kept = cli(
        "dam_break_3d", ["--checkpoint-every", str(END_OUTPUTS), "--save",
                         str(tmp / "end_time")], tmp, "end_time_main", card, on_save=on_save)
    state = sim.state
    readings.sort(key=lambda r: r["counter"])
    kept_steps = rec["iteration"]
    arrival = next((r for r in readings if r["x_front"] >= FAR_WALL_X), None)
    before = [r["vmax"] for r in readings if arrival is None or r["t"] < arrival["t"]]
    last = readings[-1]
    ckpt = kept / f"{END_OUTPUTS}.npz"
    ckpt_digest = end_digest(load_checkpoint(str(ckpt), state)[0]) if ckpt.is_file() else None
    walls_still = bool(torch.equal(fixed_rows(state), walls["start"]))
    rec.update(
        outputs=len(readings), counters=[readings[0]["counter"], last["counter"]],
        steps_to_end=kept_steps, step_calls=rec["steps"],
        replays=rec["retunes"], grid_escapes_regridded=rec["retunes"],
        particle_steps_per_s=sim.n_live * kept_steps / rec["wall_s"],
        wall_ms_per_kept_step=1e3 * rec["wall_s"] / kept_steps,
        dt=float(state.current_dt),
        arrival_t=arrival["t"] if arrival else None, far_wall_x=FAR_WALL_X,
        peak_vmax_before_arrival=max(before),
        vmax_end=last["vmax"], x_front_end=last["x_front"],
        fluid_rho_min=min(r["rho_min"] for r in readings),
        fluid_rho_max=max(r["rho_max"] for r in readings),
        fluid_rows=int((state.particles.ptype == int(T.ParticleType.FLUID)).sum()),
        outputs_outside_record_rho=sum(r["outside_record_rho"] > 0 for r in readings),
        most_rows_outside_record_rho=max(r["outside_record_rho"] for r in readings),
        nan=sum(r["nan"] for r in readings), nonfinite=sum(r["nonfinite"] for r in readings),
        walls_still=walls_still, end_digest=end_digest(state),
        checkpoint_end_digest=ckpt_digest,
        grid_escapes_left=int(state.grid_escapes))
    del rec["stderr"]
    emit(rec)
    shown = readings[::XT_EVERY] + [r for r in (arrival, last) if r is not None]
    shown = sorted({r["counter"]: r for r in shown}.values(), key=lambda r: r["counter"])
    print("\n".join(xt_table(shown)), flush=True)
    if series_path:
        Path(series_path).parent.mkdir(parents=True, exist_ok=True)
        Path(series_path).write_text(json.dumps({"card": card, "readings": readings}))
    if rec["nan"] or rec["nonfinite"]:
        fail(f"end_time_main: {rec['nan']} NaNs, {rec['nonfinite']} non-finite values")
    if not (END_RHO[0] < rec["fluid_rho_min"] and rec["fluid_rho_max"] < END_RHO[1]):
        fail(f"end_time_main: fluid density left {END_RHO}")
    if not END_STEPS[0] <= kept_steps <= END_STEPS[1] or last["t"] < sim.meta.simulation_time:
        fail(f"end_time_main: {kept_steps} steps to t = {last['t']}")
    if kept_steps != END_STEPS_EAGER:
        fail(f"end_time_main: {kept_steps} steps, not the {END_STEPS_EAGER} of the eager "
             "loop's runs")
    if arrival is None or not ARRIVAL_S[0] <= arrival["t"] <= ARRIVAL_S[1]:
        fail(f"end_time_main: the front reached x = {FAR_WALL_X} at "
             f"{arrival['t'] if arrival else 'no output'}")
    if not SURGE_MS[0] <= rec["peak_vmax_before_arrival"] <= SURGE_MS[1]:
        fail(f"end_time_main: peak |v|max before the arrival "
             f"{rec['peak_vmax_before_arrival']} m/s")
    if not last["vmax"] < SETTLED_MS:
        fail(f"end_time_main: |v|max {last['vmax']} m/s at the end")
    if rec["launches"] != deck_launches(rec["steps"], mdbc_on=False):
        fail(f"end_time_main: launches {rec['launches']} in {rec['steps']} steps")
    if not walls_still or rec["grid_escapes_left"]:
        fail("end_time_main: fixed walls moved, or escapes left after the re-grids")
    if rec["checkpoint_counters"] != [END_OUTPUTS] or ckpt_digest != rec["end_digest"]:
        fail(f"end_time_main: checkpoints {rec['checkpoint_counters']}, the last one "
             "not the end state")


def dam_break_2d_case(tmp, name, dx, const, t_end, t_out):
    """tests/test_physics_validation.py's 2D dam break (io/casegen.py) through
    ``run_simulation`` on the card; the end state and the launch counts."""
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=dx)
    meta = T.SimulationMetaData(simulation_name=name, save_location=str(tmp / name), dims=2,
                                simulation_time=t_end, output_times=t_out,
                                dtype="float32", block_size=256)
    arrays = dam_break_2d(dx)
    sim = T.assemble_simulation(*arrays, meta, const, kern, T.ViscosityModel.ARTIFICIAL,
                                T.DensityDiffusionModel.LINEAR, device="cuda")
    reset_counts()
    wall = timed_run(sim)
    p = sim.state.particles
    host = {f: getattr(p, f)[p.active].cpu().numpy()
            for f in ("position", "density", "pressure")}
    host["fluid"] = p.ptype[p.active].cpu().numpy() == int(T.ParticleType.FLUID)
    steps = int(sim.state.iteration)
    rec = {"phase": name, "n": sim.n_live, "steps": steps, "wall_s": wall,
           "sim_time_s": float(sim.state.total_time), "launches": bs.launches,
           "other_launches": cw.launches + mm.launches}
    if rec["launches"] != 2 * steps or rec["other_launches"]:
        fail(f"{name}: launches {bs.launches} / {rec['other_launches']} in {steps} steps")
    return arrays, host, rec


def physics_2d(tmp, card):
    """The front-speed and hydrostatic-settling cases of
    tests/test_physics_validation.py on the card, with their sizes and gates."""
    arrays, h, rec = dam_break_2d_case(
        tmp, "front_speed_2d", 0.02,
        T.SimulationConstants(dx=0.02, c0=34.0, cfl=0.3, alpha=0.02), 0.15, 0.05)
    fluid0 = arrays[0][arrays[2] == int(T.ParticleType.FLUID)]
    x = h["position"][h["fluid"], 0]
    z = h["position"][h["fluid"], 1]
    rho = h["density"][h["fluid"]]
    advance = np.quantile(x, 0.99) - fluid0[:, 0].max()
    ratio = advance / (np.sqrt(9.81 * fluid0[:, 1].max()) * rec["sim_time_s"])
    rec.update(card=card, front_speed_ratio=float(ratio), cpu_ratio=CPU_FRONT_RATIO,
               x_max=float(x.max()), z_min=float(z.min()),
               fluid_rho_min=float(rho.min()), fluid_rho_max=float(rho.max()))
    emit(rec)
    if not (0.51 < ratio < 0.71 and x.max() < 1.65 and z.min() > -0.05
            and rho.min() > 850 and rho.max() < 1150):
        fail(f"front_speed_2d: ratio {ratio}, or the fluid left the tank or its density band")
    _, h, rec = dam_break_2d_case(
        tmp, "hydrostatic_2d", 0.02, T.SimulationConstants(dx=0.02, c0=40.0, cfl=0.4),
        0.4, 0.1)
    z = h["position"][h["fluid"], 1]
    pres = h["pressure"][h["fluid"]]
    deep = z < np.quantile(z, 0.1)
    expected = 1000 * 9.81 * (np.quantile(z, 0.95) - np.median(z[deep]))
    ratio = np.median(pres[deep]) / expected
    rec.update(card=card, deep_pressure_ratio=float(ratio))
    emit(rec)
    if not 0.85 < ratio < 1.15:
        fail(f"hydrostatic_2d: deep pressure {ratio} of rho g h")


def end_time_phases(card, series_path=None):
    """Phases 19, under a temporary directory removed at the end."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_end_"))
    try:
        native_csv_phase(tmp, card)
        torch.cuda.empty_cache()
        end_time_main(tmp, card, series_path)
        physics_2d(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- 20: the mDBC and moving-body decks to their end times, the coarse cases ---------

# the JAX package's readings of the same procedural cases on the CPU (written by
# compare_case.py --jax-readings and compare_dam_break.py --out; the card has
# no JAX): the coarse still tank, the coarse moving square, C1's dam break
JAX_READINGS = Path(__file__).resolve().with_name("jax_case_readings.json")
TANK_OUTPUTS = 51        # the initial snapshot and one per 0.02 s to t = 1.0 s
SQUARE_OUTPUTS = 251     # the initial snapshot and one per 0.01 s to t = 2.5 s
# the gates of the JAX record's runs of these decks (PERFORMANCE.md:646-667,
# read with tools/analyze_case.py), which the JAX package's coarse runs of the
# same procedural cases meet (jax_case_readings.json): the still tank
# --band 950 1100 and |v|max <= 0.32 m/s; the square --band 900 1150 (hard
# band 775-1275, the tool's default) and the body mean on its track within
# the tool's --track-tol 1e-3 m.  The record's --allow-outliers 2 is not the
# JAX package's own on the full square: continued from the card's state at
# t = 0.49 s (compare_case.py --square-dp 0.02 --resume), it reads 5 fluid
# rows outside the band at t = 0.63 s, 1.2-1.5 dp off the body's faces (the
# transient compression the tool's --allow-outliers help describes); the
# allowance is that count, under the record's share of the fluid (2 of
# 33,020 rows, 7 of the case's 122,500)
# the end digests (end_digest) of the eager loop's runs of the two decks on
# the card (PERF.md §6): the chunk graph must end on them.  Any change to the
# rounding of the sweeps' sums moves them; they were last taken when each
# pair's terms came to be rounded apart from the fold (pair_terms / fold_terms)
TANK_DIGEST_EAGER, SQUARE_DIGEST_EAGER = "0560d074", "043bef15"
TANK_GATE = {"band": (950.0, 1100.0)}
TANK_VMAX = 0.32
SQUARE_GATE = {"band": (900.0, 1150.0), "allow_outliers": 5, "track_marker": 3,
               "speed": SQUARE_SPEED}
C1_DX, C1_T_END = 0.03, 0.7
# the card's runs of the cases the JAX package ran on the CPU are held to its
# readings at every output within TOL_FACTOR times the largest difference
# between the port's CPU run and the JAX run over the same outputs
# (``cpu_port_vs_jax`` in jax_case_readings.json), plus a floor at the f32
# scale of each reading; body positions are compared through the track error
TOL_FACTOR = 3
TOL_FLOOR = {"t": 1e-6, "x_front": 1e-4, "rho_min": 0.01, "rho_max": 0.01, "vmax": 1e-3,
             "body_err": 1e-6}


def case_table(readings, every=1):
    """The readings as tools/analyze_case.py prints them."""
    track = "body_err" in readings[0]
    lines = [f"{'t [s]':>8} {'rho_min':>9} {'rho_max':>9} {'|v|_max':>8} {'NaN':>5} "
             f"{'out':>4}" + ("  body_err" if track else "")]
    for r in readings[::every] + ([readings[-1]] if (len(readings) - 1) % every else []):
        lines.append(f"{r['t']:8.3f} {r['rho_min']:9.2f} {r['rho_max']:9.2f} "
                     f"{r['vmax']:8.2f} {r['nan']:5d} {r['out_band']:4d}"
                     + (f"  {r['body_err']:9.2e}" if track else "")
                     + ("" if r["ok"] else "  " + ",".join(r["flags"])))
    return lines


def moving_rows_x(state):
    """The MOVING rows' x in ID order (a copy, on the device)."""
    p = state.particles
    order = torch.argsort(p.id)
    keep = (p.id[order] > 0) & (p.ptype[order] == int(T.ParticleType.MOVING))
    return p.position[order][keep][:, 0].clone()


def end_time_case(tmp, card, name, deck, argv, gate, outputs, per_row_track=False):
    """A deck CLI from t = 0 to its end time with ``case_readings`` (the
    readings and verdict of tools/analyze_case.py, reduced on the card) at
    every output; with ``per_row_track``, every MOVING row's distance from its
    prescribed track x0 + 2.8 t against 2 steps ulp (moving_square_checks'
    band).  Returns (simulation, record, readings)."""
    from sphexample_tpu_torch.utils.validation import CaseReader

    reader, walls, track = CaseReader(**gate), {}, []

    def on_save(counter, state):
        if counter == 1:
            walls["start"] = fixed_rows(state)
            walls["body"] = moving_rows_x(state)
        r = reader(state)
        r["counter"] = counter
        if per_row_track:
            x = moving_rows_x(state).double()
            err, x_max = torch.stack([(x - walls["body"].double() - SQUARE_SPEED * r["t"])
                                      .abs().max(), x.max()]).tolist()
            tol = 2 * int(state.iteration) * float(np.spacing(np.float32(x_max)))
            track.append((err, tol))
            r.update(row_track_err=float(err), row_track_tol=tol)

    sim, rec, _ = cli(deck, argv, tmp, name, card, on_save=on_save)
    readings = sorted(reader.readings, key=lambda r: r["counter"])
    state = sim.state
    steps = rec["iteration"]
    rec.update(
        outputs=len(readings), t_end=readings[-1]["t"], steps_to_end=steps,
        step_calls=rec["steps"], replays=rec["retunes"],
        particle_steps_per_s=sim.n_live * steps / rec["wall_s"],
        wall_ms_per_kept_step=1e3 * rec["wall_s"] / steps, dt=float(state.current_dt),
        fluid_rho_min=min(r["rho_min"] for r in readings),
        fluid_rho_max=max(r["rho_max"] for r in readings),
        vmax_max=max(r["vmax"] for r in readings),
        most_rows_out_band=max(r["out_band"] for r in readings),
        bad_snapshots=reader.bad, nan=sum(r["nan"] for r in readings),
        nonfinite=sum(r["nonfinite"] for r in readings),
        walls_still=bool(torch.equal(fixed_rows(state), walls["start"])),
        grid_escapes_left=int(state.grid_escapes), end_digest=end_digest(state), gate=gate)
    if "body_err" in readings[0]:
        rec["body_err_max"] = max(r["body_err"] for r in readings)
    if per_row_track:
        rec.update(row_track_err_max=max(e for e, _ in track),
                   row_track_within_band=all(e <= tol for e, tol in track),
                   row_track_tol_end=track[-1][1])
    del rec["stderr"]
    emit(rec)
    fails = []
    if rec["nan"] or rec["nonfinite"]:
        fails.append(f"{rec['nan']} NaNs, {rec['nonfinite']} non-finite values")
    if rec["outputs"] != outputs or rec["t_end"] < sim.meta.simulation_time:
        fails.append(f"{rec['outputs']} outputs to t = {rec['t_end']}")
    if reader.bad:
        bad = [r for r in readings if not r["ok"]]
        fails.append(f"{reader.bad} bad snapshots (tools/analyze_case.py's verdict), "
                     f"the first at t = {bad[0]['t']}: {bad[0]['flags']}")
    if not rec["walls_still"] or rec["grid_escapes_left"]:
        fails.append("fixed walls moved, or escapes left after the re-grids")
    if per_row_track and not rec["row_track_within_band"]:
        fails.append(f"a moving row off its track by {rec['row_track_err_max']} m")
    return sim, rec, readings, fails


def end_time_mdbc(tmp, card):
    """``python -m sphexample_tpu_torch.examples.duckling_mdbc`` on the full
    procedural still tank (205,248 rows: 150,000 fluid, 55,248 wall rows with
    ghost nodes) from t = 0 to 1.0 s: the still-tank gates, 2 block-sweep
    launches, 1 fused mDBC call and its 4 grouping kernels per step."""
    case = pd.write_still_tank(str(tmp / "input"), "full")
    nb, nf = len(case["boundary"]), len(case["fluid"])
    sim, rec, readings, fails = end_time_case(
        tmp, card, "end_time_mdbc", "duckling_mdbc",
        ["--input", str(tmp / "input"), "--save", str(tmp / "end_time_mdbc")],
        TANK_GATE, TANK_OUTPUTS)
    print("\n".join(case_table(readings, 5)), flush=True)
    if rec["launches"] != deck_launches(rec["steps"], mdbc_on=True):
        fails.append(f"launches {rec['launches']} in {rec['steps']} steps")
    if sim.n_live != nb + nf or sim.cfg.boundary_capacity != nb:
        fails.append(f"{sim.n_live} rows, {sim.cfg.boundary_capacity} ghosts: not the "
                     f"case's {nb + nf}, {nb}")
    if rec["vmax_max"] > TANK_VMAX:
        fails.append(f"|v|max {rec['vmax_max']} m/s above {TANK_VMAX}")
    if not rec["end_digest"].startswith(TANK_DIGEST_EAGER):
        fails.append(f"end digest {rec['end_digest'][:8]}, not the eager loop's "
                     f"{TANK_DIGEST_EAGER}")
    if fails:
        fail("end_time_mdbc: " + "; ".join(fails))
    return rec


def end_time_square(tmp, card):
    """``python -m sphexample_tpu_torch.examples.moving_square_2d --dp 0.02``
    on the full procedural box (129,536 rows) from t = 0 to 2.5 s: the
    moving-square gates, the body on its track (the mean within 1e-3 m, every
    row within 2 steps ulp), 2 block-sweep launches per step."""
    dp = pd.SQUARE_DP["full"]
    case = pd.write_moving_square(str(tmp / "input"), dp)
    n = sum(len(case[k]) for k in ("fixed", "fluid", "square"))
    sim, rec, readings, fails = end_time_case(
        tmp, card, "end_time_square", "moving_square_2d",
        ["--dp", str(dp), "--input", str(tmp / "input"), "--save", str(tmp / "end_time_square")],
        SQUARE_GATE, SQUARE_OUTPUTS, per_row_track=True)
    print("\n".join(case_table(readings, 25)), flush=True)
    if rec["launches"] != deck_launches(rec["steps"], mdbc_on=False):
        fails.append(f"launches {rec['launches']} in {rec['steps']} steps")
    if sim.n_live != n:
        fails.append(f"{sim.n_live} rows, not the case's {n}")
    if not rec["end_digest"].startswith(SQUARE_DIGEST_EAGER):
        fails.append(f"end digest {rec['end_digest'][:8]}, not the eager loop's "
                     f"{SQUARE_DIGEST_EAGER}")
    if fails:
        fail("end_time_square: " + "; ".join(fails))
    return rec


def jax_tolerance(jax_run):
    """Per reading, the tolerance of the card's run against ``jax_run``."""
    d = jax_run["cpu_port_vs_jax"]
    return {k: TOL_FACTOR * d[k] + TOL_FLOOR[k] for k in TOL_FLOOR if k in d}


def against_jax(label, card_rows, jax_rows, tol):
    """Card readings held against the JAX package's at every output: the same
    number of outputs, each reading within ``tol`` (key: absolute tolerance)
    and, where both carry one, the same verdict."""
    n = min(len(card_rows), len(jax_rows))
    diffs = {k: max(abs(a[k] - b[k]) for a, b in zip(card_rows, jax_rows)) for k in tol}
    worst = {k: max(range(n), key=lambda i: abs(card_rows[i][k] - jax_rows[i][k]))
             for k in tol}
    verdicts = sum(a.get("ok") != b.get("ok") for a, b in zip(card_rows, jax_rows))
    rec = {"phase": label, "outputs": [len(card_rows), len(jax_rows)], "max_abs_diff": diffs,
           "tolerance": tol, "at_t": {k: jax_rows[i]["t"] for k, i in worst.items()},
           "verdicts_differ": verdicts,
           "within": len(card_rows) == len(jax_rows) and not verdicts
           and all(diffs[k] <= tol[k] for k in tol)}
    return rec


def coarse_case(tmp, card, case, jax_run):
    """A coarse procedural case (compare_case.py's) through the port's deck
    CLI on the card, its readings at every output held against the JAX
    package's run of the same case on the CPU."""
    from sphexample_tpu_torch.utils.validation import CaseReader

    root = tmp / f"input_{case}"
    if case == "still_tank":
        pd.write_still_tank(str(root), "coarse")
    else:
        pd.write_moving_square(str(root), pd.SQUARE_DP["coarse"])
    reader = CaseReader(**jax_run["gate"])
    argv = [*jax_run["argv"], "--input", str(root), "--save", str(tmp / f"coarse_{case}")]
    if jax_run.get("t_end_arg") is not None:
        argv += ["--t-end", repr(jax_run["t_end_arg"])]
    _, rec, _ = cli(jax_run["deck"], argv, tmp, f"coarse_{case}", card,
                    on_save=lambda counter, state: reader(state))
    cmp = against_jax(f"coarse_{case}", reader.readings, jax_run["readings"],
                      jax_tolerance(jax_run))
    rec.update(cmp, phase=f"coarse_{case}", steps_to_end=rec["iteration"],
               jax_steps=jax_run["steps"], jax_n=jax_run["n"], t_end=reader.readings[-1]["t"],
               bad_snapshots=reader.bad)
    del rec["stderr"]
    emit(rec)
    if not cmp["within"] or rec["n"] != jax_run["n"]:
        fail(f"coarse_{case}: the card's readings off the JAX package's: {cmp}")
    if rec["launches"] != deck_launches(rec["steps"], mdbc_on=case == "still_tank"):
        fail(f"coarse_{case}: launches {rec['launches']} in {rec['steps']} steps")


def c1_dam_break(tmp, card, jax_run):
    """C1: the 3D dam break deck at dx 0.03 to t = 0.7 s (the wall impact)
    through the port's CLI, ``dam_break_readings`` at every output held
    against the JAX package's run of compare_dam_break.py at that dx."""
    readings = []
    _, rec, _ = cli("dam_break_3d", ["--dx", str(C1_DX), "--t-end", str(C1_T_END),
                                     "--save", str(tmp / "c1")], tmp, "c1_dam_break", card,
                    on_save=lambda counter, state: readings.append(dam_break_readings(state)))
    cmp = against_jax("c1_dam_break", readings, jax_run["readings"], jax_tolerance(jax_run))
    impact = max(range(min(len(readings), len(jax_run["readings"]))),
                 key=lambda i: readings[i]["rho_max"] - readings[i]["rho_min"])
    rec.update(cmp, steps_to_end=rec["iteration"], jax_steps=jax_run["steps"],
               fluid_rho_min=min(r["rho_min"] for r in readings),
               fluid_rho_max=max(r["rho_max"] for r in readings),
               jax_rho_min=min(r["rho_min"] for r in jax_run["readings"]),
               jax_rho_max=max(r["rho_max"] for r in jax_run["readings"]),
               widest_t=readings[impact]["t"],
               widest=[readings[impact]["rho_min"], readings[impact]["rho_max"]],
               jax_widest=[jax_run["readings"][impact]["rho_min"],
                           jax_run["readings"][impact]["rho_max"]],
               nan=sum(r["nan"] for r in readings))
    del rec["stderr"]
    emit(rec)
    if rec["nan"] or not cmp["within"]:
        fail(f"c1_dam_break: the card's readings off the JAX package's: {cmp}")
    if rec["launches"] != deck_launches(rec["steps"], mdbc_on=False):
        fail(f"c1_dam_break: launches {rec['launches']} in {rec['steps']} steps")


def case_phases(card):
    """Phase 20, under a temporary directory removed at the end."""
    jax_runs = json.loads(JAX_READINGS.read_text())
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cases_"))
    try:
        end_time_mdbc(tmp, card)
        torch.cuda.empty_cache()
        end_time_square(tmp, card)
        torch.cuda.empty_cache()
        for case in ("still_tank", "moving_square"):
            coarse_case(tmp, card, case, jax_runs[case])
        c1_dam_break(tmp, card, jax_runs[f"dam_break_dx{C1_DX}"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- 21: a chunk of steps as one CUDA graph against the eager loop ------------------

CHUNK_INTERVALS = 3          # chunk_graph: output intervals per deck
CHUNK_INTERVAL_STEPS = 90    # about this many steps each: a chunk of 64, then part of one


def eager_intervals(cfg, state, t_outs, max_steps=None):
    """The eager reference of phase 21, written here and not in the package:
    each interval a plain Python loop of ``sph_step`` calls while
    ``total_time <= t_out`` (read on the host and compared in the state's
    dtype, as the JAX loop compares; at most ``max_steps``), the accumulator
    set to 1 + h at its start.  Returns (end state, steps per interval)."""
    h, steps = cfg.spec.kernel.h, []
    for t_out in t_outs:
        dx = torch.full((), 1.0 + h, dtype=state.total_time.dtype, device="cuda")
        it0 = int(state.iteration)
        t_end = torch.tensor(t_out, dtype=state.total_time.dtype).item()
        while float(state.total_time) <= t_end and (
                max_steps is None or int(state.iteration) - it0 < max_steps):
            state, dx = sph_step(cfg, state, dx)
        steps.append(int(state.iteration) - it0)
    return state, steps


def graph_intervals(interval, state, t_outs):
    """The same intervals through an interval function (``make_interval_fn``'s:
    the chunk graph; sharded, the tuple of slab states).  Returns (end state,
    steps per interval)."""
    steps = []
    lead = (lambda s: s[0]) if isinstance(state, tuple) else (lambda s: s)
    for t_out in t_outs:
        it0 = int(lead(state).iteration)
        state = interval(state, t_out)
        steps.append(int(lead(state).iteration) - it0)
    return state, steps


def walled(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def host_reads_under_sync_debug(interval, state, t_outs):
    """The graph's intervals with ``torch.cuda.set_sync_debug_mode("error")``
    on for all but the chunk loop's read after each chunk
    (``core/step.py:_host_read``), which is counted: any other host read on
    the path raises.  Returns (end state, reads)."""
    from sphexample_tpu_torch.core import step as step_mod

    real, reads = step_mod._host_read, [0]

    def counted(s, prev):
        reads[0] += 1
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(s, prev)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    step_mod._host_read = counted
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t_out in t_outs:
            state = interval(state, t_out)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        step_mod._host_read = real
    return state, reads[0]


def device_share(fn, steps):
    """Device ms per step and busy share of ``fn`` (``steps`` steps) under
    torch.profiler: kernel time (graph kernels included) over the wall."""
    ev, wall = profiled(fn)
    dev_us = sum(e.self_device_time_total for e in ev)
    if dev_us <= 0:
        return {"device_ms_per_step": "not measured", "busy_share": "not measured"}
    return {"device_ms_per_step": dev_us / 1e3 / steps, "busy_share": dev_us / 1e6 / wall,
            "device_launches_per_step": sum(e.count for e in ev) / steps}


def chunk_graph_deck(label, sim, card):
    """Phase 21 on one deck: CHUNK_INTERVALS intervals of about
    CHUNK_INTERVAL_STEPS steps from a state whose fluid falls at 1 m/s (so
    that rebuilds fall inside chunks), through the chunk graph and through
    the eager loop: the same steps and the same end digest, interval by
    interval; then the graph's build, its host reads per chunk under
    sync-debug mode, and both loops' wall and device time in turns."""
    from sphexample_tpu_torch.core.step import make_interval_fn
    from sphexample_tpu_torch.state import clone_state

    cfg = sim.cfg
    p = sim.state.particles
    down = torch.zeros(p.dims, dtype=p.position.dtype, device=p.device)
    down[-1] = -1.0
    fluid = (p.ptype == int(T.ParticleType.FLUID))[:, None]
    start = sim.state.replace(particles=p.replace(velocity=torch.where(fluid, down, p.velocity)))
    probe, _ = sph_step(cfg, start, torch.full((), 1e9, dtype=start.total_time.dtype,
                                               device="cuda"))
    dt = float(probe.current_dt)
    t0 = float(start.total_time)
    t_outs = [t0 + k * CHUNK_INTERVAL_STEPS * dt for k in range(1, CHUNK_INTERVALS + 1)]
    del probe
    interval = make_interval_fn(cfg)
    chunk = interval.chunk
    cap = cfg.meta.max_steps_per_call
    reset_counts()
    (g_end, g_steps), g_first_s = walled(lambda: graph_intervals(interval, start, t_outs))
    launches = {"block": bs.launches, "cell": cw.launches, "mdbc": mm.launches,
                "grouping": mm.group_launches}
    graph = chunk.graph
    (e_end, e_steps), _ = walled(lambda: eager_intervals(cfg, start, t_outs))
    steps = sum(g_steps)
    rebuilds = int(g_end.rebuilds) - int(start.rebuilds)
    chunks = sum(-(-s // cap) for s in g_steps)
    s_end, reads = host_reads_under_sync_debug(interval, start, t_outs)
    # wall per step in turns: eager, graph, graph, eager
    walls = {"eager": [], "graph": []}
    for who in ("eager", "graph", "graph", "eager"):
        run = (lambda: eager_intervals(cfg, start, t_outs)) if who == "eager" else (
            lambda: graph_intervals(interval, start, t_outs))
        walls[who].append(1e3 * walled(run)[1] / steps)
    dev_g = device_share(lambda: graph_intervals(interval, start, t_outs), steps)
    dev_e = device_share(lambda: eager_intervals(cfg, start, t_outs), steps)
    rec = {
        "phase": f"chunk_graph_{label}", "n": sim.n_live, "card": card,
        "sweep_kernel": cfg.sweep_kernel, "intervals": CHUNK_INTERVALS,
        "max_steps_per_call": cap, "t_outs": t_outs,
        "steps_per_interval": g_steps, "eager_steps_per_interval": e_steps,
        "rebuilds": rebuilds, "rebuilds_inside_chunks": rebuilds - CHUNK_INTERVALS,
        "graph_end_digest": end_digest(g_end), "eager_end_digest": end_digest(e_end),
        "sync_debug_end_digest": end_digest(s_end),
        "capture_s": graph.capture_s, "instantiate_s": graph.instantiate_s,
        "first_run_s_with_build": g_first_s, "graph_steps": graph.steps,
        "nodes_per_step": graph.nodes_per_step,
        "launches_per_step": {k: v / steps for k, v in launches.items() if v},
        "launches": launches, "chunks": chunks, "host_reads": reads,
        "host_reads_per_chunk": reads / chunks,
        "graph_memory_mb": graph.memory_bytes / 2**20,
        "state_copy_ms": time_cuda(lambda: clone_state(g_end), 20),
        "wall_ms_per_step_graph": walls["graph"], "wall_ms_per_step_eager": walls["eager"],
        **{f"graph_{k}": v for k, v in dev_g.items()},
        **{f"eager_{k}": v for k, v in dev_e.items()},
    }
    emit(rec)
    mdbc_on = cfg.meta.mdbc is T.MDBCMode.SIMPLE
    want = {"block": 2 * steps if cfg.sweep_kernel == "block" else 0,
            "cell": 2 * steps if cfg.sweep_kernel == "cell" else 0,
            "mdbc": steps if mdbc_on else 0,
            "grouping": len(GROUP_KERNELS) * steps if mdbc_on else 0}
    if g_steps != e_steps or rec["graph_end_digest"] != rec["eager_end_digest"]:
        fail(f"chunk_graph_{label}: the graph's steps {g_steps} / end state differ from "
             f"the eager loop's {e_steps}")
    if rec["sync_debug_end_digest"] != rec["graph_end_digest"]:
        fail(f"chunk_graph_{label}: the run under sync-debug mode ended elsewhere")
    if reads != chunks:
        fail(f"chunk_graph_{label}: {reads} host reads in {chunks} chunks")
    if launches != want:
        fail(f"chunk_graph_{label}: launches {launches} in {steps} steps, not {want}")
    if not any(s % cap for s in g_steps) or rec["rebuilds_inside_chunks"] < 2:
        fail(f"chunk_graph_{label}: no interval ended inside a chunk, or fewer than 2 "
             f"rebuilds inside chunks ({g_steps}, {rebuilds} rebuilds)")
    return rec


def chunk_graph_phases(card):
    """Phase 21: the chunk graph against the eager loop on the main deck
    (cell 1), the mDBC deck (cell 2) and the moving square with the cell
    sweep (cell 4)."""
    recs = [chunk_graph_deck("main", assemble(case_3d()), card)]
    torch.cuda.empty_cache()
    recs.append(chunk_graph_deck("mdbc", assemble_mdbc(case_3d()), card))
    torch.cuda.empty_cache()
    recs.append(chunk_graph_deck(
        "moving_square", assemble_moving_square(moving_square_case(block_sweep=False)), card))
    torch.cuda.empty_cache()
    return recs


# --- 22: the sharded chunk as one CUDA graph against the ranks' eager chunk ----------

class capture_under_sync_debug:
    """While active, every chunk graph's capture (``ChunkGraph._on_ranks``
    without ``sync``: the ranks' threads capturing) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host read in the
    captured step raises.  ``count`` is the captures seen."""

    def __enter__(self):
        from sphexample_tpu_torch.core import step as step_mod

        self.cls, self.real, self.count = step_mod.ChunkGraph, step_mod.ChunkGraph._on_ranks, 0
        real, me = self.real, self

        def on_ranks(graph, fn, sync):
            if sync:
                return real(graph, fn, sync)
            me.count += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return real(graph, fn, sync)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        self.cls._on_ranks = on_ranks
        return self

    def __exit__(self, *exc):
        self.cls._on_ranks = self.real


def launch_device_share(graph, fn, steps):
    """Device ms per step and busy share of ``fn`` (``steps`` steps through
    the chunk graph ``graph``) by CUDA events around every launch of the
    graph (its whole run on the card, the gaps between its nodes included)
    over the host clock's wall: the sharded graph's slabs run on concurrent
    branches, so the profiler's kernel time sums overlapping kernels, and
    the profiler is kept off the sharded graph."""
    real, spans = graph.launch, []

    def timed():
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        real()
        b.record()
        spans.append((a, b))

    graph.launch = timed
    try:
        _, wall = walled(fn)
    finally:
        del graph.launch
    dev_ms = sum(a.elapsed_time(b) for a, b in spans)
    return {"device_ms_per_step": dev_ms / steps, "busy_share": dev_ms / 1e3 / wall,
            "launches_timed": len(spans)}


def chunk_graph_sharded_deck(label, sim, card):
    """Phase 22 on one deck: its fluid falling at 1 m/s, cut into N_SLABS
    slabs of card 0, CHUNK_INTERVALS intervals of about CHUNK_INTERVAL_STEPS
    steps through the sharded interval function (a chunk of every slab's
    steps as one CUDA graph replay, its capture under sync-debug mode) and
    through the ranks' eager chunk (``core/step.py:_eager_chunk``: the
    route of slabs on several cards, a host read a step): the same steps
    and end digest, interval by interval; the graph's build, its launches
    counted at the replays, its host reads per chunk under sync-debug mode,
    and both chunks' wall (in turns: eager, graph, graph, eager; every turn
    held against the graph's first run) and device time (the graph's by
    CUDA events around its launches, the eager chunk's by the profiler over
    the first interval, to keep the phase short)."""
    from sphexample_tpu_torch.state import gather_state as gather

    t_phase = time.perf_counter()
    digest = lambda states: end_digest(gather(states, "cuda:0"))  # noqa: E731

    p = sim.state.particles
    down = torch.zeros(p.dims, dtype=p.position.dtype, device=p.device)
    down[-1] = -1.0
    fluid = (p.ptype == int(T.ParticleType.FLUID))[:, None]
    sim.state = sim.state.replace(particles=p.replace(
        velocity=torch.where(fluid, down, p.velocity)))
    probe, _ = sph_step(sim.cfg, sim.state, torch.full((), 1e9, dtype=sim.state.total_time.dtype,
                                                       device="cuda"))
    dt, t0 = float(probe.current_dt), float(sim.state.total_time)
    t_outs = [t0 + k * CHUNK_INTERVAL_STEPS * dt for k in range(1, CHUNK_INTERVALS + 1)]
    del probe
    sim_sh = shard_simulation(sim, make_mesh(N_SLABS, "cuda:0"))
    cfg, start = sim_sh.cfg, sim_sh.state
    interval = sim_sh.interval_fn
    chunk = interval.chunk
    eager = make_chunk_loop(cfg, _eager_chunk(cfg))
    cap = cfg.meta.max_steps_per_call
    reset_counts()
    with capture_under_sync_debug() as captured:
        (g_end, g_steps), g_first_s = walled(lambda: graph_intervals(interval, start, t_outs))
    launches = {"block": bs.launches, "cell": cw.launches, "block_window": bs.window_launches,
                "cell_window": cw.window_launches, "mdbc": mm.launches,
                "grouping": mm.group_launches}
    graph = chunk.graph
    steps = sum(g_steps)
    rebuilds = [int(s.rebuilds) - int(s0.rebuilds) for s, s0 in zip(g_end, start)]
    chunks = sum(-(-k // cap) for k in g_steps)
    s_end, reads = host_reads_under_sync_debug(interval, start, t_outs)
    walls, ends = {"eager": [], "graph": []}, {"eager": [], "graph": []}
    for who in ("eager", "graph", "graph", "eager"):
        fn = eager if who == "eager" else interval
        (end, k), wall = walled(lambda: graph_intervals(fn, start, t_outs))
        ends[who].append((digest(end), k))
        walls[who].append(1e3 * wall / steps)
    e_digest, e_steps = ends["eager"][0]
    dev_g = launch_device_share(graph, lambda: graph_intervals(interval, start, t_outs),
                                steps)
    dev_e = device_share(lambda: graph_intervals(eager, start, t_outs[:1]), g_steps[0])
    rec = {
        "phase": f"chunk_graph_sharded_{label}", "n": sim_sh.n_live, "card": card,
        "slabs": N_SLABS, "slab_devices": [str(d) for d in sim_sh.mesh.devices],
        "chunk": chunk.route, "sweep_kernel": cfg.sweep_kernel, "halo": cfg.halo,
        "intervals": CHUNK_INTERVALS, "max_steps_per_call": cap, "t_outs": t_outs,
        "steps_per_interval": g_steps, "eager_steps_per_interval": e_steps,
        "rebuilds_per_rank": rebuilds, "rebuilds_inside_chunks": rebuilds[0] - CHUNK_INTERVALS,
        "graph_end_digest": digest(g_end), "eager_end_digest": e_digest,
        "sync_debug_end_digest": digest(s_end),
        "turn_end_digests": {k: [d for d, _ in v] for k, v in ends.items()},
        "captures_under_sync_debug": captured.count,
        "capture_s": graph.capture_s, "instantiate_s": graph.instantiate_s,
        "first_run_s_with_build": g_first_s, "graph_steps": graph.steps,
        "nodes_per_step": graph.nodes_per_step, "graph_memory_mb": graph.memory_bytes / 2**20,
        "launches_per_step_per_slab": {k: v / steps / N_SLABS for k, v in launches.items()
                                       if v},
        "launches": launches, "chunks": chunks, "host_reads": reads,
        "host_reads_per_chunk": reads / chunks,
        "wall_ms_per_step_graph": walls["graph"], "wall_ms_per_step_eager": walls["eager"],
        **{f"graph_{k}": v for k, v in dev_g.items()},
        **{f"eager_{k}": v for k, v in dev_e.items()},
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(rec)
    mdbc_on = cfg.meta.mdbc is T.MDBCMode.SIMPLE
    per = steps * N_SLABS
    want = {"block": 0, "cell": 0,
            "block_window": 2 * per if cfg.sweep_kernel == "block" else 0,
            "cell_window": 2 * per if cfg.sweep_kernel == "cell" else 0,
            "mdbc": per if mdbc_on else 0,
            "grouping": len(GROUP_KERNELS) * per if mdbc_on else 0}
    name = rec["phase"]
    if chunk.route != "graph" or graph is None or captured.count != 1:
        fail(f"{name}: the slabs of one card took the {chunk.route} route "
             f"({captured.count} captures)")
    if g_steps != e_steps or rec["graph_end_digest"] != rec["eager_end_digest"]:
        fail(f"{name}: the graph's steps {g_steps} / end state differ from the eager "
             f"chunk's {e_steps}")
    if rec["sync_debug_end_digest"] != rec["graph_end_digest"] or any(
            (d, k) != (rec["graph_end_digest"], g_steps) for v in ends.values() for d, k in v):
        fail(f"{name}: a run under sync-debug mode or a turn ended elsewhere")
    if reads != chunks:
        fail(f"{name}: {reads} host reads in {chunks} chunks")
    if launches != want:
        fail(f"{name}: launches {launches} in {steps} steps on {N_SLABS} slabs, not {want}")
    if len(set(rebuilds)) != 1 or not any(k % cap for k in g_steps) or (
            rec["rebuilds_inside_chunks"] < 2):
        fail(f"{name}: the ranks' rebuilds {rebuilds} differ, no interval ended inside a "
             f"chunk, or fewer than 2 rebuilds inside chunks ({g_steps})")
    return rec


def chunk_graph_sharded_phases(card):
    """Phase 22: the sharded chunk graph against the ranks' eager chunk on
    4 slabs of one card: the main deck (cell 1, B2), the mDBC deck (cell 2,
    B2 + B4 on the halo) and the moving square with the cell sweep (cell 4,
    B3s)."""
    recs = [chunk_graph_sharded_deck("main", assemble(case_3d()), card)]
    torch.cuda.empty_cache()
    recs.append(chunk_graph_sharded_deck("mdbc", assemble_mdbc(case_3d()), card))
    torch.cuda.empty_cache()
    recs.append(chunk_graph_sharded_deck(
        "moving_square", assemble_moving_square(moving_square_case(block_sweep=False)), card))
    torch.cuda.empty_cache()
    return recs


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device - this script runs on the card only",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    secs = _build.build_all()
    ptx = {k: ptxas_report(v) for k, v in _build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source": secs, "ptxas": ptx})
    t0 = time.perf_counter()
    if native.get_lib() is None:
        fail(f"the native CSV reader did not build: {native.build_error}")
    emit({"phase": "build_native_csv", "seconds": time.perf_counter() - t0,
          "library": native.target().name})
    ptx_all = {k: v for rep in ptx.values() for k, v in rep.items()}

    # 3 - block-sweep parity on the initial lattices; 11 - the cell sweep on
    # the same states, on stirred copies, and both sweeps in every mode
    sim3 = assemble(case_3d())
    p3, cs3 = falling_state(sim3)
    par3, _ = compare(sim3, p3, cs3, "parity_3d")
    parc3, _ = compare(sim3, p3, cs3, "parity_cell_3d", mod=cw)
    p3, cs3 = stirred_state(sim3)
    parc3s, _ = compare(sim3, p3, cs3, "parity_cell_3d_stirred", mod=cw)
    modes3, bmodes3 = compare_modes(sim3, p3, cs3, "parity_cell_modes_3d",
                                    "parity_block_modes_3d")
    del p3, cs3
    sim2 = assemble(case_2d())
    p2, cs2 = falling_state(sim2)
    compare(sim2, p2, cs2, "parity_2d")
    compare(sim2, p2, cs2, "parity_cell_2d", mod=cw)
    p2, cs2 = stirred_state(sim2)
    compare(sim2, p2, cs2, "parity_cell_2d_stirred", mod=cw)
    modes2, bmodes2 = compare_modes(sim2, p2, cs2, "parity_cell_modes_2d",
                                    "parity_block_modes_2d")
    del sim2, p2, cs2
    if not (modes3["ok"] and modes2["ok"]):
        fail("parity_cell_modes: kernel and plain version disagree")
    if not (bmodes3["ok"] and bmodes2["ok"]):
        fail("parity_block_modes: the block kernel disagrees with its plain version "
             "or with the cell kernel")

    # 4-6 - the dam-break path: run, breakdown, parity on the end state
    state, run = run_phase(sim3, "run", mdbc_on=False)
    brk = breakdown_phase(sim3, state, run, "breakdown")
    pf, csf = state.particles, state.cell_start
    par_after, _ = compare(sim3, pf, csf, "parity_after_run")

    # the block sweep's entry of the kernel line (the dam-break end state)
    nums = sweep_numbers(sim3, pf, csf)
    sweep_entry = {
        "name": "block_sweep", "route": "cuda",
        "source": "sphexample_tpu_torch/csrc/block_sweep.cu",
        "replaces": "sphexample_tpu/ops/pallas_block_sweep.py:573 (_make_block_kernel)",
        "launches": run["launches"],
        "max_abs_err": max(par_after["drhodt_max_abs"], par_after["acc_max_abs"]),
        "max_rel_err": max(par3["drhodt_rel"], par3["acc_rel"],
                           par_after["drhodt_rel"], par_after["acc_rel"]),
        "ms": nums["ms"], "ms_per_launch": nums["ms"],
        "kernel_only_ms": brk.get("block_sweep_kernel_only_ms", "not measured"),
        "plain_ms": nums["plain_ms"],
        "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"],
        "library_ms": None,
        **{k: nums[k] for k in ("candidates", "pairs", "approaching_pairs",
                                "bytes", "ops", "schedule")},
        "instances": instances(ptx_all, "block_sweep_kernel"),
    }
    # 16 - the sharded main path: the same deck and steps on 4 slabs
    single_end = end_summary(state)
    del state, pf, csf
    sim_sh, states_sh, state_sh, run_sh = run_sharded_phase(
        sim3, single_end, "run_sharded", mdbc_on=False)
    halo3 = sim_sh.cfg.halo
    simg = unsharded(sim_sh)
    sharded_rebuild_phase(sim_sh, simg)
    pg, csg = stirred_state(simg)
    parw_block = compare_window(sim_sh, simg, pg, csg, "sharded_parity_block", bs,
                                halos=(halo3, 0))
    parw_cell3 = compare_window(sim_sh, simg, pg, csg, "sharded_parity_cell_3d", cw,
                                halos=(halo3, 0))
    del pg, csg
    pe, cse = state_sh.particles, state_sh.cell_start
    parw_block_after = compare_window(sim_sh, simg, pe, cse,
                                      "sharded_parity_block_after_run", bs)
    exch = exchange_phase(sim_sh, states_sh)
    window_entry = {
        "name": "block_sweep_sharded", "route": "cuda",
        "source": "sphexample_tpu_torch/csrc/block_sweep.cu",
        "replaces": "sphexample_tpu/ops/pallas_block_sweep.py:992 "
                    "(pallas_block_sweep_sharded)",
        "launches": run_sh["launches"],
        "launches_per_step_per_slab": run_sh["launches_per_step_per_slab"],
        "slabs": N_SLABS, "halo_rows": halo3,
        "max_abs_err": parw_block_after[f"halo_{halo3}_window_vs_plain_max_abs"],
        "slabs_vs_single_max_abs": parw_block_after[f"halo_{halo3}_slabs_vs_single_max_abs"],
        "max_rel_err": max(parw_block[f"halo_{halo3}_window_vs_plain_max_rel"],
                           parw_block["halo_0_window_vs_plain_max_rel"],
                           parw_block_after[f"halo_{halo3}_window_vs_plain_max_rel"]),
        "slabs_vs_single_bitwise": parw_block_after[f"halo_{halo3}_slabs_vs_single_bitwise"],
        **window_numbers(simg, pe, cse, bs, halo3),
        "bytes_sent_per_slab_per_sweep": exch["bytes_sent_per_slab_per_sweep"],
        "exchange_ms_device": max(exch["exchange_ms_device_per_rank"]),
        "exchange_ms_host": max(exch["exchange_ms_host_per_rank"]),
        "instances": instances(ptx_all, "block_sweep_kernel"),
    }
    del sim3, sim_sh, states_sh, state_sh, simg, pe, cse
    torch.cuda.empty_cache()

    # 7 - moment-kernel parity on the initial mDBC lattices
    simm = assemble_mdbc(case_3d())
    n_ghost = simm.cfg.boundary_capacity
    if (n_ghost, simm.n_live) != (131736, 249036):
        fail(f"the mDBC case has {n_ghost} ghosts / {simm.n_live} particles")
    pm, csm = perturbed_state(simm)
    parm3 = compare_mdbc(simm, pm, csm, "parity_mdbc_3d")
    fused3 = compare_fused(simm, pm, csm, "parity_mdbc_fused_3d")
    par_sweep_m3, _ = compare(simm, first_sweep_state(simm, pm, csm), csm,
                              "parity_sweep_mdbc_3d")
    del pm, csm
    simm2 = assemble_mdbc(case_2d())
    pm2, csm2 = perturbed_state(simm2)
    compare_mdbc(simm2, pm2, csm2, "parity_mdbc_2d")
    del simm2, pm2, csm2

    # 8-10 - the mDBC path: run, breakdown, parity on the end state
    state, runm = run_phase(simm, "run_mdbc", mdbc_on=True)
    brkm = breakdown_phase(simm, state, runm, "breakdown_mdbc")
    pf, csf = state.particles, state.cell_start
    parm_after = compare_mdbc(simm, pf, csf, "parity_mdbc_after_run")
    fused_after = compare_fused(simm, pf, csf, "parity_mdbc_fused_after_run")
    par_sweep_m, _ = compare(simm, pf, csf, "parity_sweep_mdbc_after_run")

    mbidx, margs = moment_args(simm, pf, csf)
    spec_m, grid_m = simm.cfg.spec, simm.cfg.grid

    def fused_m():
        return mm.mdbc_correct(spec_m, grid_m, pf, mbidx, margs[3], pf.position, pf.density,
                               pf.motion_limiter, csf)

    def plain_m():
        bp, Ap = mm.mdbc_moments_plain(*margs)
        return mdbc._mdbc_apply(spec_m, pf, mbidx, margs[3], margs[2], bp, Ap)

    m_groups = mm.ghost_groups(spec_m, grid_m, margs[2], margs[3], cell_start=csf,
                               motion_limiter=pf.motion_limiter)
    f_groups = mm.ghost_groups(spec_m, grid_m, margs[2], margs[3], bidx=mbidx, cell_start=csf,
                               motion_limiter=pf.motion_limiter)
    m_cand, m_pair, m_bytes, m_ops = mdbc_work(simm, margs, m_groups)
    f_bytes, f_ops = mdbc_work(simm, margs, f_groups, own_rows=pf.capacity)[2:]
    del m_groups, f_groups
    m_ms = time_cuda(fused_m, 20)
    t_bytes, t_ops = f_bytes / PEAK_BYTES, f_ops / PEAK_F32
    tm_bytes, tm_ops = m_bytes / PEAK_BYTES, m_ops / PEAK_F32
    grouping = {k: fused_after[k] for k in (
        "ghost_groups", "entries", "ghosts_per_group", "max_ghosts_per_group", "staged_rows",
        "candidate_rows", "staged_rows_per_candidate_row", "candidate_rows_read_unstaged",
        "parked_slots", "dry_slots")}
    mdbc_entry = {
        "name": "mdbc_moments", "route": "cuda",
        "source": "sphexample_tpu_torch/csrc/mdbc_moments.cu",
        "replaces": "sphexample_tpu/ops/pallas_mdbc.py:41 (_make_mdbc_kernel)",
        "launches": runm["mdbc_launches"], "group_launches": runm["mdbc_group_launches"],
        "max_abs_err": parm_after["moment_max_abs"],
        "max_rel_err": max(parm3["moment_max_rel"], parm_after["moment_max_rel"]),
        "fused_vs_unfused_rho_max_abs": max(fused3["rho_max_abs"], fused_after["rho_max_abs"]),
        "fused_vs_unfused_rho_bitwise": fused3["rho_bitwise"] and fused_after["rho_bitwise"],
        "ms": m_ms, "ms_per_launch": m_ms,
        "kernel_only_ms": brkm.get("mdbc_moments_kernel_only_ms", "not measured"),
        "group_kernels_ms": brkm.get("mdbc_group_kernels_ms", "not measured"),
        "plain_ms": time_cuda(plain_m, 2),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None,
        "moments_mode_ms": time_cuda(lambda: mm.mdbc_moments(*margs), 20),
        "moments_mode_plain_ms": time_cuda(lambda: mm.mdbc_moments_plain(*margs), 2),
        "moments_mode_bound_ms": 1e3 * max(tm_bytes, tm_ops),
        "moments_mode_bound_by": "bytes" if tm_bytes > tm_ops else "operations",
        "fused_stage_ms": brkm.get("mdbc_stage_ms"),
        "fused_stage_launches": brkm.get("mdbc_stage_launches"),
        "unfused_stage_ms": brkm.get("mdbc_unfused_stage_ms"),
        "unfused_stage_launches": brkm.get("mdbc_unfused_stage_launches"),
        "ghosts": n_ghost, "candidates": m_cand, "pairs": m_pair,
        "bytes": f_bytes, "ops": f_ops, "moments_mode_bytes": m_bytes,
        "moments_mode_ops": m_ops, **grouping,
        "instances": {k: v for name in ("mdbc_moments",) + GROUP_KERNELS
                      for k, v in instances(ptx_all, f"{name}_kernel").items()},
    }
    # the block sweep on the mDBC path, at that path's own shapes
    nums = sweep_numbers(simm, pf, csf)
    sweep_entry.update(
        launches_mdbc_path=runm["launches"],
        max_abs_err_mdbc_path=max(par_sweep_m["drhodt_max_abs"],
                                  par_sweep_m["acc_max_abs"]),
        max_rel_err_mdbc_path=max(par_sweep_m3["drhodt_rel"], par_sweep_m3["acc_rel"],
                                  par_sweep_m["drhodt_rel"], par_sweep_m["acc_rel"]),
        kernel_only_ms_mdbc_path=brkm.get("block_sweep_kernel_only_ms",
                                          "not measured"),
        **{f"{k}_mdbc_path": v for k, v in nums.items()})
    # 16 - the sharded mDBC path: the block sweep and the moments on the halo
    single_end = end_summary(state)
    ref_dir = argv[argv.index("--reference") + 1] if "--reference" in argv else None
    mdbc_entry.update(reference_turns(
        ref_dir, runm["end_digest"], margs, fused_m,
        lambda: mdbc.mdbc_density_correction(spec_m, grid_m, pf, csf,
                                             simm.cfg.boundary_capacity)))
    del state, pf, csf, margs, fused_m, plain_m
    sim_sh, states_sh, state_sh, run_shm = run_sharded_phase(
        simm, single_end, "run_sharded_mdbc", mdbc_on=True)
    simg = unsharded(sim_sh)
    pg, csg = perturbed_state(simg)
    parw_m = compare_window_mdbc(sim_sh, simg, pg, csg, "sharded_parity_mdbc")
    del pg, csg
    pe, cse = state_sh.particles, state_sh.cell_start
    parw_m_after = compare_window_mdbc(sim_sh, simg, pe, cse,
                                       "sharded_parity_mdbc_after_run")
    # the moment kernel on slab 1's window of the end state
    pl, cs_ext, f, _ = slab_window(pe, cse, 1, sim_sh.cfg.halo)
    bidx, bvalid = mdbc.compact_ghosts(pl, simg.cfg.boundary_capacity)
    wargs = (simg.cfg.spec, simg.cfg.grid, pl.ghost_points[bidx], bvalid,
             f["position"], f["density"], f["motion_limiter"], cs_ext)

    def fused_w():
        return mm.mdbc_correct(simg.cfg.spec, simg.cfg.grid, pl, bidx, bvalid,
                               f["position"], f["density"], f["motion_limiter"], cs_ext)

    def plain_w():
        bp, Ap = mm.mdbc_moments_plain(*wargs)
        return mdbc._mdbc_apply(simg.cfg.spec, pl, bidx, bvalid, wargs[2], bp, Ap)

    w_groups = mm.ghost_groups(simg.cfg.spec, simg.cfg.grid, wargs[2], bvalid, bidx=bidx,
                               cell_start=cs_ext, motion_limiter=f["motion_limiter"])
    w_stats = mm.schedule_stats(w_groups)
    # the slab's own ghost rows, the slots that compute; the B global slots
    # as the first kernel was launched
    w_rows = int((torch.any(pl.ghost_points != 0, dim=-1) & pl.active).sum())
    w_cand, w_pair, w_bytes, w_ops = mdbc_work(simg, wargs, w_groups, own_rows=pl.capacity)
    t_bytes, t_ops = w_bytes / PEAK_BYTES, w_ops / PEAK_F32
    mdbc_entry.update(
        launches_sharded_path=run_shm["mdbc_launches"],
        launches_per_step_per_slab_sharded_path=run_shm["mdbc_launches"] / STEPS / N_SLABS,
        halo_rows_sharded_path=sim_sh.cfg.halo,
        window_rows_sharded_path=int(f["position"].shape[0]),
        ghost_rows_sharded_path=w_rows, ghost_slots_sharded_path=int(wargs[2].shape[0]),
        max_abs_err_sharded_path=parw_m_after["window_vs_plain_moment_max_abs"],
        max_rel_err_sharded_path=max(parw_m["window_vs_plain_moment_max_rel"],
                                     parw_m_after["window_vs_plain_moment_max_rel"]),
        slabs_vs_single_bitwise_sharded_path=parw_m_after["slabs_vs_single_bitwise"],
        ms_sharded_path=time_cuda(fused_w, 20),
        kernel_only_ms_sharded_path=kernel_only_ms(fused_w, "mdbc_moments"),
        group_kernels_ms_sharded_path=kernel_only_ms(fused_w, GROUP_KERNELS, per_call=True),
        plain_ms_sharded_path=time_cuda(plain_w, 2),
        moments_mode_ms_sharded_path=time_cuda(lambda: mm.mdbc_moments(*wargs), 20),
        bound_ms_sharded_path=1e3 * max(t_bytes, t_ops),
        bound_by_sharded_path="bytes" if t_bytes > t_ops else "operations",
        candidates_sharded_path=w_cand, pairs_sharded_path=w_pair,
        bytes_sharded_path=w_bytes, ops_sharded_path=w_ops,
        **{f"{k}_sharded_path": w_stats[k] for k in (
            "parked_slots", "dry_slots", "ghost_groups", "ghosts_per_group",
            "staged_rows_per_candidate_row")})
    window_entry.update(
        launches_mdbc_path=run_shm["launches"], halo_rows_mdbc_path=sim_sh.cfg.halo,
        **{f"{k}_mdbc_path": v for k, v in
           window_numbers(simg, pe, cse, bs, sim_sh.cfg.halo).items()})
    del simm, sim_sh, states_sh, state_sh, simg, pe, cse, pl, f, wargs
    torch.cuda.empty_cache()

    # 12-13 - the large-capacity path: the capacity rule picks the cell sweep
    siml = assemble(case_3d(dx=LARGE_DX))
    if siml.n_live != LARGE_N or siml.state.particles.capacity <= bs.BLOCK_CAP_LIMIT:
        fail(f"the large case has {siml.n_live} particles, capacity "
             f"{siml.state.particles.capacity}")
    pl, csl = falling_state(siml)
    parl, _ = compare(siml, pl, csl, "parity_cell_large", mod=cw)
    del pl, csl
    state, runl = run_phase(siml, "run_large", mdbc_on=False, sweep="cell")
    brkl = breakdown_phase(siml, state, runl, "breakdown_large")
    pf, csf = state.particles, state.cell_start
    parl_after, _ = compare(siml, pf, csf, "parity_cell_large_after_run", mod=cw)
    numl = sweep_numbers(siml, pf, csf, mod=cw, plain_reps=1)
    # for the record only: the block sweep launched directly on the same state
    # (one thread per self against one block per cell, the same work)
    argl = (siml.cfg.spec, siml.cfg.grid, pf, csf, pf.position, pf.density,
            pf.pressure, pf.velocity)
    parl_block, _ = compare(siml, pf, csf, "parity_block_large_after_run")
    block_same = {
        "phase": "block_sweep_on_large_state", "n": siml.n_live,
        "block_sweep_ms": time_cuda(lambda: bs.block_sweep(*argl), 20),
        "block_sweep_kernel_only_ms": kernel_only_ms(lambda: bs.block_sweep(*argl),
                                                     "block_sweep"),
        "block_sweep_schedule": schedule(siml, pf, csf),
        "cell_sweep_schedule": numl["schedule"],
        # the cell sweep's list of occupied groups, built on the device
        "cell_sweep_list_kernel_only_ms": kernel_only_ms(lambda: cw.cell_sweep(*argl),
                                                         "occupied_groups"),
        "cell_sweep_ms": numl["ms"],
        "cell_sweep_kernel_only_ms": brkl.get("cell_sweep_kernel_only_ms",
                                              "not measured"),
        "block_sweep_max_rel_err": parl_block["max_rel"],
        "bound_ms": numl["bound_ms"], "grid_cells": siml.cfg.grid.ncells,
        "occupied_cells": int(state.occupied_cells),
    }
    emit(block_same)
    cell_entry = {
        "name": "cell_sweep", "route": "cuda",
        "source": "sphexample_tpu_torch/csrc/cell_sweep.cu",
        "replaces": "sphexample_tpu/ops/pallas_sweep.py:598 (_make_kernel)",
        "launches": runl["launches"],
        "max_abs_err": parl_after["max_abs"],
        "max_rel_err": max(parc3["max_rel"], parc3s["max_rel"], modes3["max_rel"],
                           modes2["max_rel"], parl["max_rel"], parl_after["max_rel"]),
        "ms": numl["ms"], "ms_per_launch": numl["ms"],
        "kernel_only_ms": block_same["cell_sweep_kernel_only_ms"],
        "plain_ms": numl["plain_ms"],
        "bound_ms": numl["bound_ms"], "bound_by": numl["bound_by"],
        "library_ms": None,
        "block_sweep_ms_same_state": block_same["block_sweep_ms"],
        "block_sweep_kernel_only_ms_same_state": block_same["block_sweep_kernel_only_ms"],
        "block_sweep_schedule_same_state": block_same["block_sweep_schedule"],
        "list_kernel_only_ms": block_same["cell_sweep_list_kernel_only_ms"],
        **{k: numl[k] for k in ("candidates", "pairs", "approaching_pairs",
                                "bytes", "ops", "schedule")},
        "instances": {**instances(ptx_all, "cell_sweep_kernel"),
                      **instances(ptx_all, "occupied_groups_kernel")},
    }
    del siml, state, pf, csf, argl
    torch.cuda.empty_cache()

    # 14 - the moving-square path: motion, shifting, SPS, STORE, the cell sweep
    case_sq = moving_square_case(block_sweep=False)
    simq = assemble_moving_square(case_sq)
    if simq.n_live < 250000:
        fail(f"the moving-square case has only {simq.n_live} particles")
    # an impulsively started body compresses the fluid ahead of it by about
    # v / c0 = 10 % (the acoustic estimate; the deck's own speed and sound
    # speed), with some overshoot at its corners: the band is 1.5 v / c0, not
    # the dam break's 2 %
    state, runq = run_phase(simq, "run_moving_square", mdbc_on=False, sweep="cell",
                            falling=False, rho_band=1.5 * SQUARE_SPEED / case_sq[3].c0)
    brkq = breakdown_phase(simq, state, runq, "breakdown_moving_square")
    pf, csf = state.particles, state.cell_start
    parq, outq = compare(simq, pf, csf, "parity_cell_moving_square_after_run", mod=cw)
    if sum(k.endswith("_rel") for k in parq) != len(SWEEP_FIELDS) + 1:
        fail("run_moving_square: not all six fields compared")
    moving_square_checks(simq, case_sq, state, outq, "run_moving_square",
                         WARM_STEPS + STEPS)
    numq = sweep_numbers(simq, pf, csf, mod=cw, op_costs=OPS_2D_ALL_EXTRAS)
    cell_entry.update(
        launches_moving_square_path=runq["launches"],
        max_abs_err_moving_square_path=parq["max_abs"],
        max_rel_err_moving_square_path=parq["max_rel"],
        kernel_only_ms_moving_square_path=brkq.get("cell_sweep_kernel_only_ms",
                                                   "not measured"),
        **{f"{k}_moving_square_path": v for k, v in numq.items()})

    # 16 - the sharded moving square: the cell sweep on the halo, all extras
    single_end = end_summary(state)
    del state, pf, csf, outq
    sim_sh, states_sh, state_sh, run_shq = run_sharded_phase(
        simq, single_end, "run_sharded_square", mdbc_on=False, sweep="cell",
        falling=False, rho_band=1.5 * SQUARE_SPEED / case_sq[3].c0)
    haloq = sim_sh.cfg.halo
    simg = unsharded(sim_sh)
    pe, cse = state_sh.particles, state_sh.cell_start
    parw_cell2 = compare_window(sim_sh, simg, pe, cse, "sharded_parity_cell_2d", cw)
    if simg.cfg.spec.viscosity is not T.ViscosityModel.LAMINAR_SPS:
        fail("sharded_parity_cell_2d: not the all-extras instance")
    outq = cw.cell_sweep(simg.cfg.spec, simg.cfg.grid, pe, cse, pe.position, pe.density,
                         pe.pressure, pe.velocity)
    moving_square_checks(simq, case_sq, state_sh, outq, "run_sharded_square",
                         WARM_STEPS + STEPS)
    cell_window_entry = {
        "name": "cell_sweep_sharded", "route": "cuda",
        "source": "sphexample_tpu_torch/csrc/cell_sweep.cu",
        "replaces": "sphexample_tpu/ops/pallas_sweep.py:1013 (pallas_pair_sweep_sharded)",
        "launches": run_shq["launches"],
        "launches_per_step_per_slab": run_shq["launches_per_step_per_slab"],
        "slabs": N_SLABS, "halo_rows": haloq,
        "max_abs_err": parw_cell2[f"halo_{haloq}_window_vs_plain_max_abs"],
        "slabs_vs_single_max_abs": parw_cell2[f"halo_{haloq}_slabs_vs_single_max_abs"],
        "max_rel_err": max(parw_cell2[f"halo_{haloq}_window_vs_plain_max_rel"],
                           parw_cell3[f"halo_{halo3}_window_vs_plain_max_rel"],
                           parw_cell3["halo_0_window_vs_plain_max_rel"]),
        "slabs_vs_single_bitwise": parw_cell2[f"halo_{haloq}_slabs_vs_single_bitwise"],
        **window_numbers(simg, pe, cse, cw, haloq, op_costs=OPS_2D_ALL_EXTRAS),
        "grid_cells": simg.cfg.grid.ncells,
        "instances": {**instances(ptx_all, "cell_sweep_kernel"),
                      **instances(ptx_all, "occupied_groups_kernel")},
    }
    del simq, sim_sh, states_sh, state_sh, simg, pe, cse, outq
    torch.cuda.empty_cache()

    # 17 - the moving square as the deck runs it: block_sweep=True, the rule
    # picks the block sweep (its 2D all-extras instance); the end state held
    # against the cell-sweep run of the same steps
    case_b = moving_square_case()
    simb = assemble_moving_square(case_b)
    state, runb = run_phase(simb, "run_moving_square_block", mdbc_on=False,
                            sweep="block", falling=False,
                            rho_band=1.5 * SQUARE_SPEED / case_b[3].c0)
    brkb = breakdown_phase(simb, state, runb, "breakdown_moving_square_block")
    pf, csf = state.particles, state.cell_start
    parb, outb = compare(simb, pf, csf, "parity_block_moving_square_after_run")
    if sum(k.endswith("_rel") for k in parb) != len(SWEEP_FIELDS) + 1:
        fail("run_moving_square_block: not all six fields compared")
    moving_square_checks(simb, case_b, state, outb, "run_moving_square_block",
                         WARM_STEPS + STEPS)
    end_b = end_summary(state)
    in_bands, diffs = in_trajectory_bands(end_b, single_end)
    emit({"phase": "run_moving_square_block_vs_cell_run", "in_bands": in_bands,
          "max_abs": diffs, "bitwise": all(v == 0.0 for v in diffs.values()),
          "rebuilds": [end_b["rebuilds"], single_end["rebuilds"]]})
    if not in_bands:
        fail("run_moving_square_block: the end state left the trajectory bands "
             "of the cell-sweep run")
    numb = sweep_numbers(simb, pf, csf, op_costs=OPS_2D_ALL_EXTRAS)
    sweep_entry.update(
        launches_moving_square_path=runb["launches"],
        max_abs_err_moving_square_path=parb["max_abs"],
        max_rel_err_moving_square_path=parb["max_rel"],
        max_rel_err_modes=max(bmodes3["max_rel"], bmodes2["max_rel"]),
        max_rel_vs_cell_kernel_modes=max(bmodes3["vs_cell_kernel_max_rel"],
                                         bmodes2["vs_cell_kernel_max_rel"]),
        kernel_only_ms_moving_square_path=brkb.get("block_sweep_kernel_only_ms",
                                                   "not measured"),
        **{f"{k}_moving_square_path": v for k, v in numb.items()})
    del state, pf, csf, outb

    # 18 - the same deck on 4 slabs: the block sweep on the halo (B2), its
    # all-extras 2D instance; bitwise the single-device block run
    sim_sh, states_sh, state_sh, run_shb = run_sharded_phase(
        simb, end_b, "run_sharded_square_block", mdbc_on=False, sweep="block",
        falling=False, rho_band=1.5 * SQUARE_SPEED / case_b[3].c0)
    if not run_shb["vs_single_device_bitwise"]:
        fail("run_sharded_square_block: the sharded end state differs from the "
             "single-device block run")
    haloq = sim_sh.cfg.halo
    simg = unsharded(sim_sh)
    pe, cse = state_sh.particles, state_sh.cell_start
    parw_blockq = compare_window(sim_sh, simg, pe, cse, "sharded_parity_block_square", bs)
    outb = bs.block_sweep(simg.cfg.spec, simg.cfg.grid, pe, cse, pe.position, pe.density,
                          pe.pressure, pe.velocity)
    moving_square_checks(simb, case_b, state_sh, outb, "run_sharded_square_block",
                         WARM_STEPS + STEPS)
    window_entry.update(
        launches_moving_square_path=run_shb["launches"],
        launches_per_step_per_slab_moving_square_path=run_shb["launches_per_step_per_slab"],
        halo_rows_moving_square_path=haloq,
        slabs_vs_single_bitwise_moving_square_path=parw_blockq[
            f"halo_{haloq}_slabs_vs_single_bitwise"],
        end_state_vs_single_bitwise_moving_square_path=run_shb["vs_single_device_bitwise"],
        max_rel_err_moving_square_path=parw_blockq[f"halo_{haloq}_window_vs_plain_max_rel"],
        max_abs_err_moving_square_path=parw_blockq[f"halo_{haloq}_window_vs_plain_max_abs"],
        **{f"{k}_moving_square_path": v for k, v in
           window_numbers(simg, pe, cse, bs, haloq, op_costs=OPS_2D_ALL_EXTRAS).items()})

    # 17 - the host loop a user runs: run_simulation with its saver,
    # checkpoints and resume, re-grid and replay, VTKHDF
    main_rec, regrid_end, _ = host_loop_phases(run)
    # 18 - the deck CLIs, the sharded retune, the neighbor list
    cli_phases(main_rec, regrid_end, smi)
    # 19 - the main deck to its end time, the native reader at full size, the
    # 2D physics cases
    end_time_phases(smi, argv[argv.index("--series") + 1] if "--series" in argv else None)
    # 20 - the mDBC and moving-body decks to their end times, the coarse cases
    # and C1 against the JAX package's readings
    case_phases(smi)
    # 21 - a chunk of steps as one CUDA graph, against the eager loop
    chunk_graph_phases(smi)
    # 22 - the sharded chunk as one CUDA graph, against the ranks' eager chunk
    chunk_graph_sharded_phases(smi)

    emit({"phase": "elapsed", "seconds": time.perf_counter() - t_start})
    # 15 - the kernel line
    emit({"kernels": [sweep_entry, window_entry, cell_entry, cell_window_entry,
                      mdbc_entry]})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def profiled(fn):
    """``fn()`` under torch.profiler: (the device-side events, the wall
    seconds).  Device-side events only: an aten op's row repeats the time of
    the kernels it launched, so summing every row would count them twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return ([e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation], wall)


def prof_window(sim, state, steps=20):
    """Device busy share of ``steps`` steps of the chunk graph under
    torch.profiler (kernel time summed over the window's wall time), and,
    from the same steps run eagerly (the profiler does not name a graph's
    kernels reliably), the top device ops and each hand-written kernel's
    time alone, without its wrapper's pack and collect."""
    run = make_fixed_steps_fn(sim.cfg, steps)
    build_graph(run, sim.cfg, state)                   # captured before the window
    ev, wall = profiled(lambda: run(state))
    dev_us = sum(e.self_device_time_total for e in ev)
    if dev_us <= 0:
        return {"profiled_steps": steps, "busy_share": "not measured"}
    out = {
        "profiled_steps": steps, "profiled_wall_ms": 1e3 * wall,
        "device_busy_ms": dev_us / 1e3, "busy_share": dev_us / 1e6 / wall,
        "device_ms_per_step": dev_us / 1e3 / steps,
        "device_launches_per_step": sum(e.count for e in ev) / steps,
    }
    ev, wall = profiled(lambda: eager_intervals(sim.cfg, state, [math.inf], steps))
    dev_us = sum(e.self_device_time_total for e in ev)
    top = sorted(ev, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    out.update(eager_busy_share=dev_us / 1e6 / wall, eager_device_ms_per_step=dev_us / 1e3 / steps,
               top_device_ops_ms={e.key[:60]: e.self_device_time_total / 1e3 for e in top})
    for name in ("block_sweep", "cell_sweep", "mdbc_moments"):
        mine = [e for e in ev if f"{name}_kernel" in e.key]
        count = sum(e.count for e in mine)
        if count:
            out[f"{name}_kernel_only_ms"] = (
                sum(e.self_device_time_total for e in mine) / 1e3 / count)
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
