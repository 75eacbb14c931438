"""The other ranks of a cell that runs over several cards.

A cell whose ``chips`` N is over 1 runs as one ``run.py`` process, rank 0,
which leads, and N - 1 rank processes that its loop starts in set-up
(``Group``), one card a rank (card r of the host for rank r; ranks that
outnumber the cards share them). Every rank joins one group through the
port's public ``parallel.distributed.initialize`` (``join``), which picks
NCCL where the ranks do not outnumber the cards, with a collective
timeout of TIMEOUT seconds.

The channel is the harness's own: pipes on the host. Rank 0 writes each
other rank its set-up as one JSON line on the rank's standard input (the
kind, the configuration, the traffic mix, the seed, the checkout, the
rank, the group's address), then one line before each call it makes: the
name of the loop's method, its arguments, and whether rank 0 is tracing
(``trace.record`` runs). A rank makes that call of its own loop, and
synchronises; a line that asks for an answer gets one JSON line on the
rank's standard output. So every rank makes the same calls in the same
order, and the collectives inside them pair up. The lines use no card
time, and the harness writes the window's before its clock starts.

Start: ``run.py`` starts the other ranks (``prestart``) before it
imports torch itself, so that their imports and card contexts overlap
its own; each waits, with torch and the port's group module loaded and
its card's context made, for its set-up line, and ``Group`` takes them
over. A ``Group`` that finds none started (the CPU tests) starts them.

Tracing: a rank makes the calls that rank 0 traces inside its own
``torch.profiler`` session (``trace.spanned``, as ``trace.record`` makes
them), which it closes at the next untraced line; ``report`` answers
with the rank's peak memory, its trace's busy and window seconds, and
the forbidden modules it holds (``run.forbidden_modules``: JAX or the
JAX package), which ``Group.report`` keeps in FOUND by rank, for
``run.py`` to refuse the run on (exit 3, no result). A rank's last call
is over by then: the harness asks for the report after the window and
the trace.

Failures: a rank that raises prints its traceback to standard error,
which it shares with rank 0, and exits 1. Rank 0 watches every rank: as
soon as one has exited before ``Group.stop`` (or its channel broke), it
names the rank on standard error, kills the others, waits for each, and
ends its own process with exit code 1 and no result, whatever it was
doing (a call blocked in a collective whose peer died would otherwise
wait for the timeout). A rank whose standard input closes before it was
told to stop (rank 0 gone) ends itself. ``Group.stop`` tells every rank
to leave the group and exit, and waits for each; ``Group.abandon``, which
the harness calls where a run raises and which also runs at exit, kills
them and waits for each.

    python3 raybench/ranks.py [--rank R --device cuda|cpu]
                                 # a rank; prestart or Group starts it,
                                 # its set-up comes on standard input
"""

from __future__ import annotations

import atexit
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time

HOME = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HOME)
# Seconds a collective waits for its peers before it raises.
TIMEOUT = 120.0
# Seconds a stopped rank has to exit before it is killed.
STOP_WAIT = 60.0
WATCH_EVERY = 0.1
# The other ranks that answered ``Group.report``, and the forbidden
# modules each named, by rank, where it held any.
REPORTED = []
FOUND = {}
# Rank processes started by ``prestart`` and not yet taken by a Group.
_PRESTARTED = []


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def device_of(kind: str, rank: int):
    """Rank ``rank``'s device: card ``rank`` modulo the cards, or the
    CPU."""
    import torch

    if kind == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def join(address: str, world: int, rank: int, dev) -> str:
    """Join the group of ``world`` ranks at ``address`` as ``rank`` on
    ``dev``; returns the backend the port chose."""
    import torch

    from ceres_tpu_torch.parallel import distributed

    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return distributed.initialize(address, world, rank, device=dev,
                                  cpu=dev.type == "cpu", timeout=TIMEOUT)


def leave():
    from ceres_tpu_torch.parallel import distributed

    distributed.shutdown()


def _forbidden() -> list:
    from raybench.run import forbidden_modules

    return forbidden_modules()


def _start(rank: int, device: str = None):
    args = [sys.executable, os.path.join(HOME, "ranks.py")]
    if device is not None:
        args += ["--rank", str(rank), "--device", device]
    return subprocess.Popen(args, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True, bufsize=1)


def prestart(world: int, device: str = "cuda"):
    """Start ranks 1 to ``world`` - 1 on ``device`` now, for the Group
    that the cell's loop makes later to take over."""
    _PRESTARTED[:] = [_start(rank, device) for rank in range(1, world)]
    atexit.register(unstart)


def unstart():
    """Kill the ranks that ``prestart`` started and no Group took, and
    wait for each."""
    for proc in _PRESTARTED:
        proc.kill()
        proc.wait()
        for pipe in (proc.stdin, proc.stdout):
            pipe.close()
    _PRESTARTED.clear()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Group:
    """Rank 0's side: the other ranks' processes and their channels.
    ``setup`` is what every rank's loop is built from; each rank also gets
    its ``rank`` and the group's ``address``."""

    def __init__(self, world: int, setup: dict):
        self.world = world
        self.address = f"tcp://127.0.0.1:{_free_port()}"
        self._lock = threading.Lock()
        self._stopping = False
        self._ended = threading.Event()
        atexit.register(self.abandon)
        if len(_PRESTARTED) == world - 1:
            self.procs = list(_PRESTARTED)
            _PRESTARTED.clear()
        else:
            unstart()
            self.procs = [_start(rank) for rank in range(1, world)]
        for rank in range(1, world):
            self._write(rank, dict(setup, rank=rank, address=self.address))
        threading.Thread(target=self._watch, daemon=True).start()

    def _write(self, rank: int, message: dict):
        try:
            self.procs[rank - 1].stdin.write(json.dumps(message) + "\n")
            self.procs[rank - 1].stdin.flush()
        except (BrokenPipeError, OSError, ValueError):
            self._fail(rank, "its channel broke")

    def tell(self, name: str, *args, answer: bool = False):
        """Every other rank makes its loop's call ``name(*args)``."""
        import torch

        message = {"op": name, "args": list(args), "answer": answer,
                   "traced": torch.autograd._profiler_enabled()}
        for rank in range(1, self.world):
            self._write(rank, message)

    def ask(self, name: str, *args) -> list:
        """``tell``, then each other rank's answer, by rank."""
        self.tell(name, *args, answer=True)
        out = []
        for rank, proc in enumerate(self.procs, 1):
            line = proc.stdout.readline()
            if not line:
                self._fail(rank, "it closed its channel")
            out.append(json.loads(line))
        return out

    def report(self) -> list:
        """Each other rank's ``report`` answer, by rank; the forbidden
        modules any holds go into FOUND."""
        out = self.ask("report")
        for rank, answer in enumerate(out, 1):
            REPORTED.append(rank)
            if answer["forbidden"]:
                FOUND[rank] = answer["forbidden"]
        return out

    def _watch(self):
        while True:
            with self._lock:
                if self._stopping:
                    return
            for rank, proc in enumerate(self.procs, 1):
                if proc.poll() is not None:
                    self._fail(rank, f"it exited with code {proc.returncode}")
            time.sleep(WATCH_EVERY)

    def _claim(self) -> bool:
        """Whether this caller ends the ranks (the first to ask); a later
        caller waits until they have ended."""
        with self._lock:
            first, self._stopping = not self._stopping, True
        if not first:
            self._ended.wait(STOP_WAIT + 10.0)
        return first

    def _fail(self, rank: int, why: str):
        """Rank ``rank`` failed: end every rank and this process."""
        if not self._claim():
            return
        log(f"raybench: rank {rank} of {self.world} failed before the run "
            f"stopped it ({why}); ending every rank and the run")
        self._end(kill=True)
        os._exit(1)

    def _end(self, kill: bool, then=None) -> list:
        for proc in self.procs:
            if kill:
                proc.kill()
            else:
                try:
                    proc.stdin.write(json.dumps({"op": "stop"}) + "\n")
                    proc.stdin.close()
                except (BrokenPipeError, OSError, ValueError):
                    pass
        if then is not None:
            then()
        codes = []
        deadline = time.monotonic() + STOP_WAIT
        for proc in self.procs:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            codes.append(proc.returncode)
            for pipe in (proc.stdin, proc.stdout):
                try:
                    pipe.close()
                except (BrokenPipeError, OSError):
                    pass
        self._ended.set()
        return codes

    def abandon(self):
        """Kill every rank and wait for each (a run that ends before it
        stopped them: a rank may be blocked in a collective)."""
        if self._claim():
            self._end(kill=True)

    def stop(self, then=None) -> list:
        """Tell every rank to leave the group and exit, call ``then()``
        (rank 0's own leave: NCCL's communicators are torn down by every
        rank at once), and wait for each rank (one still there after
        STOP_WAIT seconds is killed). Returns their exit codes, by rank;
        [] where the group had already stopped."""
        if not self._claim():
            return []
        return self._end(kill=False, then=then)


class _Session:
    """A rank's profiler session over the calls that rank 0 traces."""

    def __init__(self, cuda: bool):
        import torch

        from raybench import trace

        self.calls = 0
        if cuda:
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=trace.activities(cuda))
        self.prof.__enter__()

    def close(self):
        from raybench import trace

        self.prof.__exit__(None, None, None)
        return trace.reduce(self.prof, self.calls - 1)


def serve(loop, inbox, answer, dev):
    """Make the calls that rank 0 names, in order, until it says stop."""
    import torch

    from raybench import trace

    cuda = dev.type == "cuda"
    session, traced = None, None
    while True:
        message = inbox.get()
        if message["op"] == "stop":
            break
        if session is not None and not message["traced"]:
            traced, session = session.close(), None
        if message["op"] == "report":
            out = {"memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if cuda else 0),
                   "busy_s": None if traced is None else traced.busy_s,
                   "window_s": None if traced is None else traced.window_s,
                   "forbidden": _forbidden()}
        else:
            def call():
                got = getattr(loop, message["op"])(*message["args"])
                if cuda:
                    torch.cuda.synchronize()
                return got

            if message["traced"]:
                if session is None:
                    session = _Session(cuda)
                session.calls += 1
                out = trace.spanned(call, cuda)
            else:
                out = call()
        if message["answer"]:
            answer.write(json.dumps(out) + "\n")
            answer.flush()
        del out


def main() -> int:
    sys.path.insert(0, ROOT)
    # Standard output is the channel's answers alone: what else the rank
    # prints goes to standard error.
    answer = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    inbox, stopped = queue.Queue(), threading.Event()

    def read():
        for line in sys.stdin:
            message = json.loads(line)
            if message.get("op") == "stop":
                stopped.set()
            inbox.put(message)
        if not stopped.is_set():
            log("raybench rank: rank 0 closed the channel; ending")
            os._exit(1)

    threading.Thread(target=read, daemon=True).start()
    t0 = time.perf_counter()
    early = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    # Started before the set-up exists (``prestart``): load and make
    # now what every rank needs, while rank 0 loads its own.
    import torch

    from ceres_tpu_torch.parallel import distributed  # noqa: F401
    from raybench import loops

    if "--rank" in early:
        dev = device_of(early["--device"], int(early["--rank"]))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.cuda.init()
    setup = inbox.get()
    rank = setup["rank"]
    dev = device_of(setup["device"], rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    def mark(label):
        log(f"rank {rank} set-up: {label} at "
            f"{time.perf_counter() - t0:.6f} s")

    loop = loops.kind(setup["root"], setup["kind"]).Loop(
        setup["cfg"], setup["traffic"], setup["seed"], setup["root"], dev,
        mark, chips=setup["chips"], rank=rank, address=setup["address"])
    serve(loop, inbox, answer, dev)
    loop.free()
    t0 = time.perf_counter()
    leave()
    log(f"rank {rank} left the group in {time.perf_counter() - t0:.6f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
