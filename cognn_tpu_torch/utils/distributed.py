"""One process a party over ``torch.distributed`` (the port's counterpart of
``jax.distributed.initialize`` and the ``"party"`` mesh of
``cognn_tpu/harness/run_party.py:99-122``): the reference's process model,
one OS process per graph owner.

:func:`init_party_group` joins the process group of ``world`` parties at a
``host:port`` coordinator and returns a :class:`PartyGroup`, which holds the
rank, its device and the collectives the sharded engines call. The
collective backend is chosen from how many ranks share a card, never after
a failure:

  * ``"nccl"`` where every rank has a card of its own (NCCL refuses two
    ranks on one GPU);
  * ``"gloo"`` otherwise (a card shared by several ranks, or the CPU). On a
    card each collective's tensors are copied to the host and back
    explicitly around the gloo call, so nothing depends on gloo's CUDA
    support.

The compute stays on the rank's device either way: rank r of a CUDA run
takes ``cuda:{r % torch.cuda.device_count()}``, and with no card a CUDA run
raises as :func:`cognn_tpu_torch.utils.device.resolve_device` does.

:func:`run_parties` starts one process per party on this host and waits
for all of them, killing the rest as soon as one fails or the time runs
out.

:func:`wrap_check_operand` and :func:`wrap_expected` hold the collectives
to their contract on int64 and int32 shares: sums and exchanges wrap mod
2^64 and 2^32, as numpy's uint64 does (masked).
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cognn_tpu_torch.utils.device import resolve_device

DEFAULT_TIMEOUT_S = 300.0  # rendezvous and each collective


def wire_bytes(name: str, buffer_bytes: int, world: int) -> float:
    """The bytes one rank sends in the collective ``name`` over a group of
    ``world``, the factors of ``cognn_tpu/engine/comm_model.py:33-41``:
    ``all_to_all`` (P-1)/P of its input, ``all_reduce`` (a ring all-reduce)
    2(P-1)/P of it, ``all_gather`` (P-1)/P of its output (``world`` times
    ``buffer_bytes``, the input). Multiplied before it is divided, so the
    value is exact whenever it is an integer or P a power of two."""
    if name == "all_to_all":
        return buffer_bytes * (world - 1) / world
    if name == "all_reduce":
        return 2 * buffer_bytes * (world - 1) / world
    if name == "all_gather":
        return float(buffer_bytes * (world - 1))
    raise ValueError(f"no wire factor for collective {name!r}")


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now, for a local coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def party_device(rank: int, device="cuda") -> torch.device:
    """Rank ``rank``'s device: ``cuda:{rank % cards}`` for a CUDA run (raises
    without a card), the CPU for a CPU run."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def choose_backend(world: int, device) -> str:
    """``"nccl"`` when ``world`` CUDA ranks each have a card of their own,
    else ``"gloo"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


@dataclasses.dataclass
class PartyGroup:
    """This process's place in the party group, and the collectives over
    it. ``calls`` counts the collectives by name and ``bytes`` adds up the
    bytes this rank sends in them (:func:`wire_bytes` of each buffer); with
    ``timed`` set, each one is bracketed by device synchronizations and its
    host wall time added to ``seconds``."""

    rank: int
    world: int
    device: torch.device
    backend: str
    timed: bool = False
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    @property
    def staged(self) -> bool:
        """True when the collectives go through host copies (gloo and a
        card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def __str__(self) -> str:
        how = " through host copies" if self.staged else ""
        return (f"party {self.rank} of {self.world} on {self.device}, "
                f"collectives over {self.backend}{how}")

    def reset_counts(self) -> None:
        self.calls = {}
        self.bytes = {}
        self.seconds = 0.0

    def _sync(self) -> None:
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, name: str, x: torch.Tensor, op,
             out: Optional[torch.Tensor] = None,
             rows: int = 1) -> torch.Tensor:
        """The collective ``op(send, recv)`` of ``x`` into ``out`` (or a new
        tensor), ``rows`` times ``x``'s leading axis: counted, timed, and
        staged through host copies where :attr:`staged`."""
        self._sync()
        t0 = time.perf_counter()
        x = x.contiguous()
        send = x.cpu() if self.staged else x
        shape = (rows * send.shape[0], *send.shape[1:])
        if out is not None and tuple(out.shape) != shape:
            raise ValueError(f"{name}: out {tuple(out.shape)}, want {shape}")
        recv = (out if out is not None and not self.staged
                else send.new_empty(shape))
        op(send, recv)
        if self.staged:
            recv = (recv.to(self.device) if out is None
                    else out.copy_(recv))
        self._sync()
        if self.timed:
            self.seconds += time.perf_counter() - t0
        self.calls[name] = self.calls.get(name, 0) + 1
        self.bytes[name] = self.bytes.get(name, 0.0) + wire_bytes(
            name, x.numel() * x.element_size(), self.world)
        return recv

    def all_to_all(self, x: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x [world, ...]``: row j goes to rank j; returns ``[world, ...]``
        (``out`` if given) whose row i came from rank i."""
        if x.shape[0] != self.world:
            raise ValueError(f"all_to_all takes [{self.world}, ...], got "
                             f"{tuple(x.shape)}")

        def op(send, recv):
            dist.all_to_all_single(recv, send)
        return self._run("all_to_all", x, op, out)

    def all_reduce_sum(self, x: torch.Tensor,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The sum of ``x`` over the ranks (int64 and int32 wrap mod 2^64 and
        2^32), on every rank, in ``out`` if given; ``x`` is left as it
        was."""
        def op(send, recv):
            recv.copy_(send)
            dist.all_reduce(recv, op=dist.ReduceOp.SUM)
        return self._run("all_reduce", x, op, out)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along axis 0 in rank order."""
        def op(send, recv):
            dist.all_gather(list(recv.chunk(self.world)), send)
        return self._run("all_gather", x, op, rows=self.world)

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def init_party_group(rank: int, world: int, coordinator: str,
                     backend: Optional[str] = None,
                     timeout: float = DEFAULT_TIMEOUT_S,
                     device="cuda") -> PartyGroup:
    """Join the group of ``world`` party processes as ``rank`` at
    ``coordinator`` (``host:port``, the address rank 0 listens on).
    ``backend`` None chooses by :func:`choose_backend`; ``timeout`` (s)
    bounds the rendezvous and every collective. Tear down with
    :func:`destroy_party_group`."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a group of {world}")
    dev = party_device(rank, device)
    backend = backend or choose_backend(world, dev)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("nccl needs a CUDA device")
    if dev.type == "cuda":
        # the party's card is the current one: a bare synchronize, a new
        # stream or tensor of this process land on it
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    return PartyGroup(rank, world, dev, backend)


def wrap_check_operand(rank: int, world: int,
                       dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Rank ``rank``'s operand of the wrap check, ``[world, 4]`` of
    ``dtype`` (int64, or int32 for the 32-bit ring): values near the
    dtype's +-2^(n-1) and at multiples of 2^(n-4), whose sums over the
    ranks leave the dtype's range; row j is what it sends to rank j in an
    ``all_to_all``."""
    n = 32 if dtype == torch.int32 else 64
    rows = [[(1 << n - 1) - 1 - rank - j, (1 << n - 1) + rank + j,
             ((rank + 1) * (j + 1) << n - 4) % (1 << n),
             (-((rank + 1) << n - 3)) % (1 << n)] for j in range(world)]
    u = np.array(rows, np.uint64)
    return torch.from_numpy(u.astype(np.uint32).view(np.int32) if n == 32
                            else u.view(np.int64))


def wrap_expected(world: int, dtype: torch.dtype = torch.int64
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the ``world`` ranks' :func:`wrap_check_operand` give, computed
    with numpy uint64 (which wraps mod 2^64; masked to 32 bits for int32)
    and read back as ``dtype``: the ``[world, 4]`` sum every rank gets from
    ``all_reduce_sum``, and the ``[world, world, 4]`` exchanges, ``[r]``
    being what rank r gets from ``all_to_all``."""
    def u64(t):
        x = t.numpy()
        return (x.view(np.uint32).astype(np.uint64) if x.dtype == np.int32
                else x.view(np.uint64))

    def back(x):
        return torch.from_numpy(x.astype(np.uint32).view(np.int32)
                                if dtype == torch.int32 else x.view(np.int64))

    ops = [u64(wrap_check_operand(r, world, dtype)) for r in range(world)]
    total = ops[0].copy()
    for x in ops[1:]:
        total += x  # wraps mod 2^64
    recv = np.stack([np.stack([ops[i][r] for i in range(world)])
                     for r in range(world)])
    return back(total), back(recv)


def destroy_party_group() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def multiprocess_rank() -> Optional[int]:
    """This process's rank when it is one of several party processes, else
    None."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.get_rank()
    return None


def run_parties(commands: Sequence[List[str]], timeout: Optional[float] = None,
                stdouts=None, stderrs=None, **popen) -> None:
    """Run one process per party, ``commands[r]`` for rank r, all at once,
    and wait for all of them. Raises ``RuntimeError`` naming the ranks that
    failed as soon as one exits with another code than 0, and
    ``TimeoutError`` once ``timeout`` seconds have passed; either way every
    process still running is killed, and none outlives the call.
    ``stdouts``/``stderrs``: one target per rank (a file, ``DEVNULL``, or
    None to inherit); ``popen``: passed on to :class:`subprocess.Popen`."""
    n = len(commands)
    stdouts = stdouts or [None] * n
    stderrs = stderrs or [None] * n
    procs: List[subprocess.Popen] = []
    try:
        for cmd, out, err in zip(commands, stdouts, stderrs):
            procs.append(subprocess.Popen(cmd, stdout=out, stderr=err,
                                          **popen))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rcs = [p.poll() for p in procs]
            failed = {r: rc for r, rc in enumerate(rcs) if rc not in (None, 0)}
            if failed:
                raise RuntimeError(f"party processes failed (rank: exit "
                                   f"code): {failed}")
            if all(rc == 0 for rc in rcs):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"party processes still running after "
                                   f"{timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
