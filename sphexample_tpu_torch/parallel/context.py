"""Communication context: the one abstraction that lets the same ``sph_step``
run on a single device and on P slabs (port of
``sphexample_tpu/parallel/context.py``).

The particle axis is cut in *global cell-sorted order*: rank r owns the
contiguous slab r of the sorted rows.  The JAX package runs one step per
device under ``shard_map`` and talks through XLA collectives; the port keeps
that SPMD shape with **ranks as threads of one process** (a "local group"):
rank r works on the device the mesh gives it (``cuda:(r mod count)``, or the
CPU) under a CUDA stream of its own, and a collective is a rendezvous on a
barrier-guarded board:

  1. every rank posts its tensors, with an event recorded on its stream;
  2. barrier; every rank reads what it needs from the others (its stream
     waits on the owner's event; a tensor on a peer card is copied device to
     device), and records a "done" event;
  3. barrier; every owner's stream waits on the readers' "done" events, so
     that memory it frees afterwards is not handed out again under a copy
     that is still queued.

The ranks take turns on the host: one runs until it waits for the others,
then the next (``LocalGroup.turn``); the cards work through what was queued
meanwhile.

There is no host staging, and the same path serves one card and several.  An
exception in a rank aborts the barrier, so that no other rank waits for it;
every wait has a timeout (:func:`run_ranks` re-raises).  A
``torch.distributed`` backend of the same methods (one process per card) is
not written yet.

The collectives can be captured into one CUDA graph when every slab lies on
one card (:class:`GroupCapture`, used by ``core/step.py:ChunkGraph``): every
``ready`` and ``done`` event is recorded and waited on inside the capture,
so each becomes an edge between the ranks' branches of the graph, and the
barrier only orders the posts and the reads while the step is captured.  A
replay runs the step with no barrier and no host thread per rank.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch

DEFAULT_TIMEOUT = 120.0   # seconds a rank waits for the others


class LocalGroup:
    """What the P thread ranks of one process share: the barrier, the board
    the collectives post on, and each rank's device and stream."""

    def __init__(self, devices: Sequence[torch.device], timeout: float = DEFAULT_TIMEOUT):
        self.devices = tuple(torch.device(d) for d in devices)
        self.size = len(self.devices)
        if self.size < 1:
            raise ValueError("a group needs at least one rank")
        self.timeout = float(timeout)
        self.barrier = threading.Barrier(self.size)
        # One rank at a time runs host code; the turn changes hands only where
        # a rank waits for the others.  Every PyTorch call gives up the
        # interpreter lock while it runs, so ranks left to run freely wake one
        # another at every call - on one interpreter that costs several times
        # what the calls themselves do.
        self.turn = threading.Lock()
        self._has_turn = [False] * self.size
        self.board: List = [None] * self.size
        self.done: List = [None] * self.size
        self._streams: List = [None] * self.size

    def stream(self, rank: int):
        """Rank ``rank``'s own CUDA stream (``None`` on the CPU), made once."""
        dev = self.devices[rank]
        if dev.type != "cuda":
            return None
        if self._streams[rank] is None:
            self._streams[rank] = torch.cuda.Stream(device=dev)
        return self._streams[rank]

    def take_turn(self, rank: int) -> None:
        if not self._has_turn[rank]:
            if not self.turn.acquire(timeout=self.timeout):
                raise threading.BrokenBarrierError("no turn within the group's timeout")
            self._has_turn[rank] = True

    def give_turn(self, rank: int) -> None:
        if self._has_turn[rank]:
            self._has_turn[rank] = False
            self.turn.release()

    def wait(self, rank: int) -> None:
        """Barrier with the group's timeout, the rank's turn given up while it
        waits; ``BrokenBarrierError`` when a rank failed or did not arrive in
        time."""
        self.give_turn(rank)
        self.barrier.wait(self.timeout)
        self.take_turn(rank)


def _tensors(payload):
    return [payload] if isinstance(payload, torch.Tensor) else list(payload)


def _map(payload, fn):
    if isinstance(payload, torch.Tensor):
        return fn(payload)
    return tuple(fn(t) for t in payload)


@dataclass(frozen=True)
class CommContext:
    """``group=None`` means single-device: every method is an identity."""

    group: Optional[LocalGroup] = None
    index: int = 0

    @property
    def is_sharded(self) -> bool:
        return self.group is not None

    @property
    def num_devices(self) -> int:
        return 1 if self.group is None else self.group.size

    def rank(self) -> int:
        return self.index

    def for_rank(self, rank: int) -> "CommContext":
        return CommContext(self.group, rank)

    # -- the rendezvous ------------------------------------------------------

    def _collective(self, payload, read: Callable):
        """Post ``payload`` (a tensor or a tuple of tensors), wait for all,
        return ``read(take)`` where ``take(rank)`` gives rank's payload (or
        ``take(rank, part)`` a slice of its tuple) as tensors usable on this
        rank's stream; what ``read`` returns must not alias them."""
        g = self.group
        cuda = [t for t in _tensors(payload) if t.is_cuda]
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(cuda[0].device))
        g.board[self.index] = (payload, ready)
        g.wait(self.index)

        mine = g.devices[self.index]

        def take(rank: int, part: slice = None, own: bool = False):
            theirs, ev = g.board[rank]
            if ev is not None and rank != self.index:
                torch.cuda.current_stream(mine).wait_event(ev)
            if part is not None:
                theirs = theirs[part]
            # ``own``: a copy this rank keeps (a peer card's tensor is
            # copied by the move itself)
            return _map(theirs, lambda t: t.to(mine) if t.device != mine
                        else (t.clone() if own else t))

        result = read(take)
        done = None
        if mine.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(mine))
        g.done[self.index] = done
        g.wait(self.index)
        if ready is not None:
            stream = torch.cuda.current_stream(cuda[0].device)
            for rank, ev in enumerate(g.done):
                if ev is not None and rank != self.index:
                    stream.wait_event(ev)
        return result

    # -- the collectives -----------------------------------------------------

    def gather(self, x):
        """Concatenate the ranks' slabs along axis 0 (tiled all-gather)."""
        if self.group is None:
            return x
        n = self.group.size
        return self._collective(x, lambda take: torch.cat([take(r) for r in range(n)], 0))

    def _stack(self, x):
        n = self.group.size
        return self._collective(x, lambda take: torch.stack([take(r) for r in range(n)], 0))

    def pmax(self, x):
        return x if self.group is None else torch.amax(self._stack(x), dim=0)

    def pmin(self, x):
        return x if self.group is None else torch.amin(self._stack(x), dim=0)

    def psum(self, x):
        if self.group is None:
            return x
        return torch.sum(self._stack(x), dim=0).to(x.dtype)

    def exchange(self, to_left, to_right):
        """The 1-hop exchange in one rendezvous: send ``to_left`` to rank - 1
        and ``to_right`` to rank + 1 (each a tensor or a tuple of tensors);
        returns ``(from_left, from_right)``, copies owned by this rank.  The
        end ranks receive zeros of the shape they sent, like ``ppermute``."""
        single = isinstance(to_left, torch.Tensor)
        tl, tr = tuple(_tensors(to_left)), tuple(_tensors(to_right))
        zeros = lambda ts: tuple(torch.zeros_like(t) for t in ts)  # noqa: E731
        if self.group is None:
            out = zeros(tr), zeros(tl)
        else:
            r, n, k = self.index, self.group.size, len(tl)

            def read(take):
                # rank r-1's ``to_right`` is my left halo, rank r+1's
                # ``to_left`` my right halo
                left = (take(r - 1, slice(k, None), own=True)
                        if r > 0 else zeros(tr))
                right = (take(r + 1, slice(0, k), own=True)
                         if r < n - 1 else zeros(tl))
                return left, right

            out = self._collective(tl + tr, read)
        return (out[0][0], out[1][0]) if single else out


SINGLE = CommContext()


def run_ranks(group: LocalGroup, fn: Callable[[int], object], sync: bool = True) -> list:
    """Run ``fn(rank)`` on one thread per rank, each under its device and its
    own stream, and return the results in rank order.  Every rank's stream
    first waits on the caller's current stream of its device (where its
    inputs were made).  The first exception of any rank breaks the barrier
    (no rank is left waiting), and is re-raised here; a rank that does not
    finish within the group's timeout after the others raises
    ``TimeoutError``.  ``sync``: every rank's stream is synchronised before
    the results are handed back; else (a capture, which must not block the
    host) the caller's streams wait on the ranks' streams."""
    n = group.size
    results: List = [None] * n
    errors: List = [None] * n
    group.barrier.reset()
    callers = {d: torch.cuda.current_stream(d) for d in set(group.devices)
               if d.type == "cuda"}

    def work(rank: int):
        dev = group.devices[rank]
        try:
            group.take_turn(rank)
            if dev.type == "cuda":
                stream = group.stream(rank)
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    stream.wait_stream(callers[dev])
                    results[rank] = fn(rank)
                    if sync:
                        stream.synchronize()
            else:
                results[rank] = fn(rank)
        except BaseException as exc:  # noqa: BLE001 - re-raised by the caller
            errors[rank] = exc
            group.barrier.abort()
        finally:
            group.give_turn(rank)

    threads = [threading.Thread(target=work, args=(r,), name=f"sph-rank-{r}", daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    # a rank only runs long while all of them do: once one has ended, the
    # others end within the barrier timeout or something hangs
    threads[0].join()
    for t in threads[1:]:
        t.join(group.timeout * 2)
    hung = [t.name for t in threads if t.is_alive()]
    primary = [e for e in errors
               if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    if primary:
        raise primary[0]
    broken = [e for e in errors if e is not None]
    if broken:
        raise TimeoutError(
            "a rank waited longer than the group's timeout for the others "
            f"({group.timeout:g} s)") from broken[0]
    if hung:
        group.barrier.abort()
        raise TimeoutError(f"ranks did not finish: {hung}")
    if not sync:
        for rank, dev in enumerate(group.devices):
            if dev.type == "cuda":
                callers[dev].wait_stream(group.stream(rank))
    return results


class GroupCapture:
    """CUDA graphs captured across the streams of ``streams`` - one per rank,
    every rank on one card - in one memory pool, one piece after another,
    each a ``torch.cuda.CUDAGraph`` kept as its ``cudaGraph_t``
    (``keep_graph``).  Rank 0's stream is the origin: :meth:`begin` starts a
    piece there, and every other rank's stream waits on an event recorded on
    it after the capture began (the fork), so that its work, and what its
    allocator hands out, belongs to the same capture; :meth:`end` has the
    origin wait on an event recorded last on every other rank's stream (the
    join) and ends the piece.  Every rank calls both at the same point of its
    program, on its own thread and stream; the ranks meet at the group's
    barrier to order them.  ``group=None``: one rank, on the calling thread.

    ``mode`` is the capture's ``cudaStreamCaptureMode``.  A group captures
    in ``"relaxed"`` mode: its ranks are threads of one capture, and in
    ``"global"`` mode a call that CUDA counts as unsafe in any other thread
    while it is open (a synchronisation, a copy to the host by the
    asynchronous saver) would fail; and a capture that a rank's failure left
    open is ended by the thread that called :func:`run_ranks`
    (:meth:`abort`), which CUDA allows only in relaxed mode."""

    def __init__(self, group: Optional[LocalGroup], streams: Sequence, mode: str):
        self.group, self.streams, self.mode = group, list(streams), mode
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: List = []          # their pool backs the pieces' memory
        self.open = None
        self._fork = None
        self._joins: List = [None] * len(self.streams)

    def _meet(self, rank: int) -> None:
        if self.group is not None:
            self.group.wait(rank)

    def begin(self, rank: int) -> None:
        """Start a piece (rank 0) and join it (the other ranks)."""
        if rank == 0:
            g = torch.cuda.CUDAGraph(keep_graph=True)
            g.capture_begin(pool=self.pool, capture_error_mode=self.mode)
            self.open = g
            if len(self.streams) > 1:
                self._fork = torch.cuda.Event()
                self._fork.record()
        self._meet(rank)
        if rank:
            torch.cuda.current_stream().wait_event(self._fork)

    def end(self, rank: int):
        """End the piece; returns its ``cudaGraph_t`` at rank 0, else None.
        No rank goes on before it has ended."""
        if rank:
            ev = torch.cuda.Event()
            ev.record()
            self._joins[rank] = ev
        self._meet(rank)
        raw = None
        if rank == 0:
            origin = torch.cuda.current_stream()
            for ev in self._joins[1:]:
                origin.wait_event(ev)
            g, self.open = self.open, None
            g.capture_end()
            self.graphs.append(g)
            raw = g.raw_cuda_graph()
        self._meet(rank)
        return raw

    def abort(self) -> None:
        """End a piece left open by a failure, after every rank has stopped:
        join every stream still capturing, end on the origin, discard."""
        if self.open is None:
            return
        g, self.open = self.open, None
        origin = self.streams[0]
        with torch.cuda.stream(origin):
            for s in self.streams[1:]:
                with torch.cuda.stream(s):
                    joined = torch.cuda.is_current_stream_capturing()
                if joined:
                    origin.wait_stream(s)
            try:
                g.capture_end()
            except RuntimeError:
                pass
