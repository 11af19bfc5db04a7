"""Shared CLI runner of the deck scripts (port of ``examples/_runner.py``):
the flags, the device, and the run - assembly, resume, sharding, profiler,
logger, VTKHDF output, checkpoints and the ParaView state file.

Differences from the JAX runner: there is no ``--pallas`` (the hand kernels
always run on the card, their plain versions with ``--cpu``); ``--profile``
writes a ``torch.profiler`` Chrome trace; ``--shard N`` runs N thread ranks
on the cards visible (one card included, or the CPU with ``--cpu``); and
where ``h5py`` does not import, the run writes no VTKHDF and says so before
its first step, but still writes its checkpoints and the state file.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys


def standard_argparser(default_save: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--t-end", type=float, default=None)
    ap.add_argument("--save", default=default_save)
    ap.add_argument("--input", default="/root/reference/input")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain PyTorch versions); "
                         "without it the run needs a CUDA card")
    ap.add_argument("--max-intervals", type=int, default=None)
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="write a resume checkpoint every N outputs")
    ap.add_argument("--resume", default=None, metavar="CHECKPOINT.npz",
                    help="resume from a checkpoint written by "
                         "--checkpoint-every; continues the existing "
                         "transient VTKHDF files in place")
    ap.add_argument("--kernel-output", action="store_true",
                    help="store per-particle kernel sums (StoreKernelOutput mode)")
    ap.add_argument("--output-variables", default=None, metavar="A,B,...",
                    help="comma-separated subset of the output variables "
                         "(default: all 13, reference parity; positions are "
                         "always written)")
    ap.add_argument("--watchdog", type=float, default=None, metavar="SECONDS",
                    help="warn when a single device chunk blocks longer than "
                         "this; combine with --watchdog-hard to exit 86 for a "
                         "supervised restart from the last checkpoint")
    ap.add_argument("--watchdog-hard", action="store_true",
                    help="exit with code 86 when the watchdog fires")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace (CPU and CUDA "
                         "activities, Chrome trace format) of the second "
                         "output interval into DIR")
    ap.add_argument("--shard", type=int, default=None, metavar="N",
                    help="cut the particle axis into N slabs, one thread "
                         "rank each, on the cards visible (slab r on card "
                         "r mod count: fewer cards than N share them) or, "
                         "with --cpu, on the CPU; 1-hop halo exchange, "
                         "whole-array fallback for thin slabs")
    return ap


def apply_backend_args(args):
    """The device the run takes, kept as ``args.device``: the CPU with
    ``--cpu``, else the card (no card raises here, before any work).  Sets no
    environment variable and no global backend; ``--dtype`` goes into the
    deck's ``SimulationMetaData``."""
    from ..core.driver import resolve_device

    args.device = resolve_device("cpu" if args.cpu else None)
    return args.device


@contextlib.contextmanager
def _trace(directory: str, device):
    """``torch.profiler`` over the block, written to ``directory/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize()
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))


NO_H5PY = ("[sphexample_tpu_torch] h5py does not import here: this run writes "
           "no VTKHDF output, only its checkpoints and the ParaView state file")


def run_case(args, geoms, meta, const, kern, viscosity, diffusion,
             particle_normals_path=None, arrays=None):
    """``arrays``: optional (position, density, ptype, group_marker, id)
    tuple from a procedural case generator (io/casegen.py), used instead of
    the ``geoms`` CSV list when the reference input CSVs are unavailable."""
    from ..config import LogMode
    from ..core.driver import assemble_simulation, build_simulation, run_simulation
    from ..io.checkpoint import resume_simulation, save_checkpoint
    from ..io.paraview import write_paraview_state
    from ..utils.logger import SimulationLogger

    device = args.device
    if args.output_variables:
        meta = dataclasses.replace(meta, output_variables=tuple(
            v.strip() for v in args.output_variables.split(",")))
    if args.watchdog:
        meta = dataclasses.replace(meta, device_call_timeout=args.watchdog,
                                   watchdog_hard=bool(args.watchdog_hard))

    try:  # the VTKHDF writers need h5py, which the card machine may lack
        from ..io.output import make_save_callback
        from ..io.vtkhdf import clean_simulation_folder
    except ImportError as e:
        if e.name != "h5py":
            raise
        make_save_callback = clean_simulation_folder = None
    resume_path = args.resume
    if not resume_path and clean_simulation_folder is not None:
        clean_simulation_folder(meta.save_location)
    if arrays is not None:
        sim = assemble_simulation(*arrays, meta, const, kern, viscosity, diffusion,
                                  device=device)
    else:
        sim = build_simulation(geoms, meta, const, kern, viscosity, diffusion,
                               particle_normals_path=particle_normals_path,
                               device=device)

    start_counter = 1
    if resume_path:
        sim, start_counter = resume_simulation(sim, resume_path)
        t_start = float(sim.state.total_time)

    if args.shard:
        from ..parallel.mesh import make_mesh, shard_simulation

        sim = shard_simulation(sim, make_mesh(args.shard, device))

    if args.profile:
        # trace the SECOND interval: the first one builds and loads the
        # kernels, which would drown the trace
        inner_fn = sim.interval_fn
        n_calls = [0]

        def traced_interval(state, t_out, progress=None):
            n_calls[0] += 1
            if n_calls[0] == 2:
                with _trace(args.profile, device):
                    return inner_fn(state, t_out, progress)
            return inner_fn(state, t_out, progress)

        sim.interval_fn = traced_interval

    # LogMode axis (reference SimulationMetaDataConfiguration.jl:12-33):
    # NONE disables the log file entirely
    log_on = meta.log is LogMode.STORE
    logger = SimulationLogger(meta.save_location, append=bool(resume_path)) if log_on else None
    if log_on:
        logger.initialize(meta, const, kern, viscosity.value, diffusion.value,
                          geoms, sim.n_live)
        if resume_path:
            logger.logger.info(f"resuming from {resume_path} at output counter "
                               f"{start_counter} (t = {t_start:.5f} s)")
    vtk = None
    if make_save_callback is None:
        print(NO_H5PY, file=sys.stderr, flush=True)
        if log_on:
            logger.logger.info(NO_H5PY)
    else:
        # writes each snapshot with the grid it was stepped on (sim.cfg.grid
        # at the save: run_simulation drains the saver before a re-grid)
        vtk = make_save_callback(sim, resume_counter=start_counter if resume_path else None)

    def save(counter, state):
        if vtk is not None:
            vtk(counter, state)
        if args.checkpoint_every and counter % args.checkpoint_every == 0:
            save_checkpoint(os.path.join(meta.save_location, "checkpoint.npz"), state,
                            counter, grid=sim.cfg.grid)

    timesteps = []

    def log(info):
        timesteps.append(info["dt"])
        if log_on:
            logger.log_step(info, meta.simulation_time)

    sim = run_simulation(sim, save_callback=save, log_callback=log,
                         max_intervals=args.max_intervals, start_counter=start_counter)
    if vtk is not None:
        vtk.close()
    if log_on:
        if sim.hourglass is not None:
            logger.logger.info(sim.hourglass.report())
        logger.log_final(sim.state, timesteps)
    if meta.visualize_in_paraview:
        # state file only; auto-launch deliberately not replicated
        # (reference OpenExternalPrograms.jl:65-186)
        write_paraview_state(meta)
    if log_on:
        logger.close()
        if meta.open_log_file:
            # AutoOpenLogFile analog (reference OpenExternalPrograms.jl:37-52):
            # print the path instead of launching an editor
            print(f"[sphexample_tpu_torch] log file: {logger.path}")
    return sim
