"""Several processes joined into one mesh (counterpart of
``ceres_tpu/parallel/distributed.py``: ``initialize``, ``global_mesh``,
``process_info``).

The JAX package drives every device of a host from one process and joins
hosts with ``jax.distributed``. The port runs one process, a **rank**,
per device, joined by ``torch.distributed``: a mesh is a ("frames",
"rays") grid of ranks (``parallel.sharded.Mesh``), each rank holds one
device, and the collectives run over the default process group. Only
``all_reduce`` (SUM, MIN) and ``broadcast`` are used: the gloo backend
takes CUDA tensors for exactly those.

The backend rule of ``initialize``:

  * ``cpu=True``: gloo on CPU tensors;
  * on the card, NCCL when every rank on the host has a card of its own
    (``LOCAL_WORLD_SIZE``, else ``num_processes``, at most
    ``torch.cuda.device_count()``);
  * gloo on CUDA tensors when ranks share a card: NCCL refuses two ranks
    on one GPU;
  * ``backend=`` overrides the rule.

Nothing switches to another backend after a failure: the caller prints
the backend ``initialize`` returns.

``run_ranks`` starts ranks on this host for the tests, ``chip_smoke.py``
and ``parallel.dryrun``: spawned processes that rendezvous through a file
in a fresh temporary directory. Launch the CLIs on several ranks with
``torchrun --nproc-per-node N``.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import queue
import tempfile
import threading
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

# Seconds a collective waits for its peers before it raises, so that a
# rank that died cannot hang the others forever.
TIMEOUT = 600.0

# This rank's device, as ``initialize`` chose it.
_device: Optional[torch.device] = None


def _init_method(address: str) -> str:
    """``tcp://`` or ``file://`` as given; a bare "host:port" (the JAX
    package's coordinator address) becomes ``tcp://host:port``."""
    return address if "://" in address else f"tcp://{address}"


def choose_backend(cpu: bool, num_processes: int, process_id: int,
           backend: Optional[str] = None,
           device=None) -> tuple[str, torch.device]:
    """(backend, device) of one rank by the module's rule."""
    if cpu:
        return backend or "gloo", torch.device(device or "cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("initialize: no CUDA card; pass cpu=True to join "
                           "CPU ranks")
    cards = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    local_rank = int(os.environ.get("LOCAL_RANK", process_id % local))
    if device is None:
        device = torch.device("cuda", local_rank % cards)
    return backend or ("nccl" if local <= cards else "gloo"), \
        torch.device(device)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device=None, backend: Optional[str] = None,
               cpu: bool = False, timeout: float = TIMEOUT) -> str:
    """Join this process to a group of ``num_processes`` ranks as rank
    ``process_id`` and return the backend chosen by the module's rule.

    ``coordinator_address`` is a ``tcp://host:port`` or ``file://path``
    rendezvous (a bare "host:port" means tcp). ``device`` overrides this
    rank's device (default: the CPU with ``cpu=True``, else card
    ``LOCAL_RANK`` modulo the cards); a collective that waits longer than
    ``timeout`` seconds raises.
    """
    global _device
    backend, dev = choose_backend(cpu, num_processes, process_id, backend,
                                  device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=_init_method(coordinator_address),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))
    _device = dev
    return backend


def initialize_from_env(device=None) -> Optional[str]:
    """Join the group a launcher describes in the environment
    (``torchrun``: ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return the backend; None, and nothing joined,
    without ``WORLD_SIZE`` or where a group is already joined. A CPU
    ``device`` joins gloo CPU ranks."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return None
    address = (f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
               f"{os.environ['MASTER_PORT']}")
    return initialize(address, int(os.environ["WORLD_SIZE"]),
                      int(os.environ["RANK"]), device=device,
                      cpu=device is not None
                      and torch.device(device).type == "cpu")


@contextlib.contextmanager
def joined_from_env(device=None):
    """``initialize_from_env`` for the span of a ``with``: yields the
    backend it chose (None where it joined nothing) and leaves the group
    it joined at the end."""
    backend = initialize_from_env(device)
    try:
        yield backend
    finally:
        if backend is not None:
            shutdown()


def rank_device() -> torch.device:
    """This rank's device: the one ``initialize`` chose, else (a group
    joined by other means) card ``LOCAL_RANK`` of this host."""
    if _device is not None:
        return _device
    if not torch.cuda.is_available():
        raise RuntimeError("rank_device: the group was not joined through "
                           "initialize and there is no card")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                        % torch.cuda.device_count())


def cli_device(device, caller: str) -> torch.device:
    """The device a command-line app renders on: ``device`` if given,
    else this rank's in a group, else the card (it raises without one)."""
    if device is not None:
        return torch.device(device)
    if dist.is_initialized():
        return rank_device()
    from ceres_tpu_torch.render.renderer import resolve_device

    return resolve_device(None, None, caller)


def is_leader() -> bool:
    """True on rank 0, and without a group: the rank that prints and
    writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def leader_print():
    """``print`` on the leading rank, a no-op on the others."""
    return print if is_leader() else (lambda *args, **kwargs: None)


def global_mesh(num_frames_axis: int = 1):
    """The ("frames", "rays") mesh over every rank of the group."""
    from ceres_tpu_torch.parallel.sharded import device_mesh

    return device_mesh(num_frames_axis, devices=[rank_device()])


def process_info() -> tuple[int, int, int, int]:
    """(rank, ranks, devices of this rank, devices of the group): one
    device a rank. Without a group, (0, 1, 1, 1)."""
    if not dist.is_initialized():
        return 0, 1, 1, 1
    n = dist.get_world_size()
    return dist.get_rank(), n, 1, n


def shutdown() -> None:
    """Leave the group (no-op without one)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world_size, init_method, device, backend, timeout,
               inbox, results):
    """One spawned rank: take ``fn``'s arguments from ``inbox``, join,
    run ``fn(*args)``, report its pickled result or its traceback."""
    try:
        args = inbox.get(timeout=timeout)
        cpu = torch.device(device).type == "cpu"
        if cpu:
            # Ranks share the host's cores with each other and with
            # parallel test workers.
            torch.set_num_threads(1)
        dev = device if cpu else torch.device(
            "cuda", rank % torch.cuda.device_count())
        chosen = initialize(init_method, world_size, rank, device=dev,
                            backend=backend, cpu=cpu, timeout=timeout)
        if rank == 0:
            print(f"run_ranks: {world_size} ranks on {device}, backend "
                  f"{chosen}", flush=True)
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


# run_ranks calls under way, and whether the first of them found no
# resource tracker running.
_calls = 0
_calls_lock = threading.Lock()
_tracker_ours = False


def run_ranks(fn, world_size: int, *args, device=None,
              backend: Optional[str] = None, timeout: float = 600.0):
    """Run ``fn(*args)`` on ``world_size`` ranks of one group on this host
    and return their results, by rank.

    The ranks are spawned processes (CUDA cannot be used in forked
    children), so ``fn`` and ``args`` must pickle: ``fn`` a function of an
    importable module, its result too (CPU tensors, numpy arrays). They
    rendezvous through a file in a fresh temporary directory, not a port.
    ``device`` "cuda" (the default, which raises without a card) gives
    rank k card k modulo the cards, with ``initialize``'s backend rule;
    ``device="cpu"`` runs gloo on the CPU with one thread a rank. As soon as one rank fails the others are killed and this raises
    with that rank's traceback; so it does after ``timeout`` seconds, and
    a collective waits at most as long.

    It returns with no process of its own left: the ranks are joined, and
    so is multiprocessing's resource tracker when the calls under way
    started it (the spawn start method starts one; left alone, it would
    outlive this process by the moment it takes to see its pipe close).
    """
    from multiprocessing import resource_tracker

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("run_ranks: no CUDA card; pass device='cpu' "
                               "to run CPU ranks")
        device = "cuda"
    global _calls, _tracker_ours
    tracker = resource_tracker._resource_tracker
    with _calls_lock:
        if _calls == 0:
            _tracker_ours = tracker._fd is None
        _calls += 1
    try:
        return _spawn_ranks(fn, world_size, args, device, backend, timeout)
    finally:
        # The last of the calls that run at once (threads) stops it.
        with _calls_lock:
            _calls -= 1
            if _calls == 0 and _tracker_ours:
                _stop_tracker(tracker)


def _stop_tracker(tracker) -> None:
    """Close the resource tracker's pipe and reap it. Every semaphore it
    tracked is released by then, so it exits with nothing to clean up."""
    stop = getattr(tracker, "_stop", None)
    if stop is not None:
        stop()
        return
    with tracker._lock:
        if tracker._fd is None:
            return
        os.close(tracker._fd)
        tracker._fd = None
        os.waitpid(tracker._pid, 0)
        tracker._pid = None


def _spawn_ranks(fn, world_size, args, device, backend, timeout):
    """``run_ranks`` itself: spawn, gather, join, and release the queues'
    semaphores before it returns or raises."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    # The arguments go through a queue, not the process objects: a start
    # then writes little to its child and cannot block on a child that
    # fails while it starts.
    inbox, results = ctx.Queue(), ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ceres_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, rank, world_size, init_method,
                                   str(device), backend, timeout, inbox,
                                   results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
            inbox.put(args)
        out = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world_size:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    # Handled below, outside this block: an error raised
                    # here would carry the Empty's traceback, whose frame
                    # keeps the queue and its semaphores alive.
                    rank = None
                if rank is None:
                    gone = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if gone:
                        raise RuntimeError(
                            f"rank {gone[0]} exited with code "
                            f"{procs[gone[0]].exitcode} before it reported")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world_size} ranks did not finish within "
                            f"{timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{payload}")
                out[rank] = pickle.loads(payload)
        finally:
            for p in procs:
                if p.is_alive() and len(out) < world_size:
                    p.kill()
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
                p.close()
            if len(out) < world_size:
                # A rank that died before it took its arguments left them
                # in the pipe, where the feeder thread waits to write the
                # rest: take them back.
                with contextlib.suppress(queue.Empty, OSError, EOFError):
                    while True:
                        inbox.get(timeout=1.0)
            for q in (inbox, results):
                q.close()
            # The feeder thread ends once it has written what it holds;
            # one still blocked is left behind rather than waited on.
            feeder = inbox._thread
            if feeder is not None:
                feeder.join(timeout=30)
                if feeder.is_alive():
                    inbox.cancel_join_thread()
            # A traceback keeps this frame: drop the queues and processes
            # from it, so that the queues' semaphores are unlinked now.
            del inbox, results, q, procs, feeder
    return [out[r] for r in range(world_size)]
