"""The process group: multi-process initialization and the bounded
host collectives — twin of ``smk_tpu/parallel/distributed.py`` over
``torch.distributed``.

Subset fits exchange nothing during the MCMC (the share-nothing SMK
property), so scaling over processes is data layout: after
:func:`init_distributed` every process sees the job's mesh entries
(``executor.make_mesh`` spans the ranks), each process fits the subset
rows it owns (``executor.process_row_range``), and the one collective of
a fit is the all-gather of the quantile grids before the combine
(``combine.gather_grids``: NCCL between cards, gloo on the CPU).

Hardening, as the twin's:

- the rendezvous (``tcp://host:port``) runs under ``timeout_s`` with
  deterministic exponential-backoff retries on transient failures
  (:func:`backoff_schedule`);
- a typed error taxonomy: :class:`CoordinatorUnavailableError` when the
  retries run out on transient failures, :class:`DistributedConfigError`
  for non-transient ones and for a second initialization with another
  topology;
- an idempotence guard: a second call with the identical topology is a
  warned no-op returning the established :class:`ProcessTopology`.

:func:`barrier_sync` and :func:`allgather_bytes` run on the process
group's key-value store, not on a collective of the backend: an NCCL
``barrier`` has no per-call deadline and waits forever on a dead peer,
while a store wait gives up after ``timeout_s`` with a typed
:class:`CollectiveTimeoutError`. Keys carry per-tag sequence numbers, so
a tag reused across calls never collides in the write-once store.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import time
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from smk_torch.utils.tracing import monotonic


class DistributedInitError(RuntimeError):
    """Base of the ``init_distributed`` error taxonomy."""


class CoordinatorUnavailableError(DistributedInitError):
    """Every rendezvous attempt failed with a TRANSIENT error (timeout,
    refused or reset connection) and the retry budget is spent. Carries
    the attempt count and the last underlying error."""

    def __init__(self, attempts: int, timeout_s: float, last: BaseException):
        self.attempts = int(attempts)
        self.timeout_s = float(timeout_s)
        self.last_error = last
        super().__init__(
            f"torch.distributed.init_process_group failed {self.attempts} time(s) with "
            f"transient coordinator errors (timeout {self.timeout_s:.0f}s per attempt; "
            f"last: {last!r}) — the coordinator is unreachable or still starting. Check "
            "the coordinator address/port and that process 0 is up, or raise "
            "SMKConfig.dist_init_retries / dist_init_timeout_s for slow cluster bring-up"
        )


class DistributedConfigError(DistributedInitError):
    """Non-transient initialization failure: bad topology arguments, or a
    second ``init_distributed`` call with a DIFFERENT topology in a
    process that already initialized one."""


class CollectiveTimeoutError(RuntimeError):
    """A barrier or key-value agreement did not complete within its
    deadline: a peer is dead, hung, or off the collective schedule.
    Carries the operation name and the deadline. The distributed
    checkpoint (parallel/checkpoint.py) turns it into a commit abort,
    whose effect on disk is that the previous generation stays
    published."""

    def __init__(self, op: str, timeout_s: float, cause=None):
        self.op = str(op)
        self.timeout_s = float(timeout_s)
        self.cause = cause
        super().__init__(
            f"cross-process collective {self.op!r} did not complete within "
            f"{self.timeout_s:.0f}s" + (f" ({cause!r})" if cause is not None else "")
            + " — a peer process is dead or hung; the last PUBLISHED checkpoint "
            "generation is unaffected (two-phase commit), so abort and resume from it, on a "
            "reduced topology if a host is gone"
        )


# Substrings of the transient (retryable) rendezvous failures
_TRANSIENT_MARKERS = (
    "deadline",
    "timed out",
    "timeout",
    "unavailable",
    "connection refused",
    "failed to connect",
    "connection reset",
    "barrier",
    "temporarily",
)


def _is_transient(exc: BaseException) -> bool:
    """Retryable? Connection/timeout exception types, or a message
    carrying one of the known transient markers."""
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _TRANSIENT_MARKERS)


def backoff_schedule(retries: int, base_s: float = 1.0, cap_s: float = 30.0) -> tuple:
    """The sleep before each of the ``retries`` re-attempts:
    ``min(cap_s, base_s * 2**i)``, no jitter (the twin's)."""
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    if base_s <= 0 or cap_s <= 0:
        raise ValueError("base_s and cap_s must be > 0")
    return tuple(min(float(cap_s), float(base_s) * (2.0 ** i)) for i in range(int(retries)))


@dataclasses.dataclass(frozen=True)
class ProcessTopology:
    """What ``init_distributed`` established."""

    process_id: int
    num_processes: int
    local_device_count: int
    global_device_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


# The one-per-process initialization state: (topology, argument key, each
# rank's mesh entry).
_ACTIVE: Optional[tuple] = None


def _reset_state_for_testing() -> None:
    """Forget the idempotence-guard state (a process group, if any, is
    NOT destroyed)."""
    global _ACTIVE
    _ACTIVE = None


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The job's process count, 1 without a process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def backend_name() -> Optional[str]:
    """The process group's backend ("nccl", "gloo"), None without one."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return str(dist.get_backend())


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[list] = None,
    *,
    timeout_s: Optional[float] = None,
    retries: Optional[int] = None,
    backoff_s: float = 1.0,
    backoff_cap_s: float = 30.0,
    config=None,
    device=None,
) -> ProcessTopology:
    """Join a multi-process job: ``torch.distributed.init_process_group``
    with NCCL when ``device`` is a card (the default when one is
    present) and gloo when ``device="cpu"``.

    ``coordinator_address`` is ``host:port`` (or ``tcp://host:port``) of
    process 0, which hosts the rendezvous store; without it the
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``
    environment is read (``env://``). ``local_device_ids[0]`` is the card
    this process drives (default: its rank modulo the visible cards),
    made the current device before the group starts. ``timeout_s``
    bounds each rendezvous attempt and is the group's collective
    timeout; ``retries`` transient failures are retried after
    :func:`backoff_schedule`. Defaults come from ``config``
    (``dist_init_timeout_s`` / ``dist_init_retries``) or 120 s / 3.

    Call once per process. A second call with the identical topology is a
    warned no-op returning the established :class:`ProcessTopology`; one
    with another topology raises :class:`DistributedConfigError`."""
    global _ACTIVE
    if timeout_s is None:
        timeout_s = float(config.dist_init_timeout_s) if config is not None else 120.0
    if retries is None:
        retries = int(config.dist_init_retries) if config is not None else 3
    if timeout_s <= 0:
        raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
    arg_key = (coordinator_address, num_processes, process_id,
               tuple(local_device_ids) if local_device_ids is not None else None)
    if _ACTIVE is not None:
        topo, prev_key = _ACTIVE[:2]
        if arg_key == prev_key:
            warnings.warn(
                "init_distributed called again with the identical topology; returning "
                "the established ProcessTopology (one process group per process)",
                RuntimeWarning, stacklevel=2,
            )
            return topo
        raise DistributedConfigError(
            f"init_distributed was already called in this process with topology "
            f"{prev_key} (established: {topo}); the new call requests {arg_key}. A "
            "process joins exactly one job — to change the topology, restart the process"
        )
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    if cuda and not torch.cuda.is_available():
        raise DistributedConfigError(
            "init_distributed(device=cuda) but no CUDA device is visible; pass "
            "device='cpu' for a gloo job on the CPU")
    kwargs = dict(backend="nccl" if cuda else "gloo",
                  timeout=datetime.timedelta(seconds=float(timeout_s)))
    if coordinator_address is not None:
        kwargs["init_method"] = _init_method(coordinator_address)
    else:
        kwargs["init_method"] = "env://"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if cuda:
        n_vis = torch.cuda.device_count()
        local = (int(local_device_ids[0]) if local_device_ids
                 else int(process_id or 0) % max(1, n_vis))
        torch.cuda.set_device(local)
    schedule = backoff_schedule(retries, backoff_s, backoff_cap_s)
    attempt = 0
    while True:
        try:
            dist.init_process_group(**kwargs)
            break
        except DistributedInitError:
            raise
        except Exception as e:
            if not _is_transient(e):
                raise DistributedConfigError(
                    f"torch.distributed.init_process_group failed with a non-transient "
                    f"error: {e!r} — check the topology arguments (coordinator_address/"
                    "num_processes/process_id) and the environment; transient "
                    "coordinator failures would have been retried"
                ) from e
            if attempt >= retries:
                raise CoordinatorUnavailableError(attempt + 1, timeout_s, e) from e
            delay = schedule[attempt]
            warnings.warn(
                f"torch.distributed.init_process_group attempt {attempt + 1}/{retries + 1} "
                f"failed transiently ({e!r}); retrying in {delay:.1f}s",
                RuntimeWarning, stacklevel=2,
            )
            time.sleep(delay)
            attempt += 1
    if dist.is_initialized():
        pid, nproc = dist.get_rank(), dist.get_world_size()
    else:  # a stubbed init_process_group (testing/faults.flaky_coordinator)
        pid, nproc = int(process_id or 0), int(num_processes or 1)
    # each rank's mesh entry, gathered once here so that building a mesh
    # later needs no collective: [device kind, device type, [index]]
    if cuda:
        cur = torch.cuda.current_device()
        info = [torch.cuda.get_device_name(cur), "cuda", [cur]]
    else:
        info = ["cpu", "cpu", [None]]
    infos = [json.loads(b) for b in allgather_bytes("init_distributed", json.dumps(info).encode(),
                                                     timeout_s=timeout_s)]
    if len(infos) != nproc:  # a stubbed init: every rank like this one
        infos = [info] * nproc
    n_local = torch.cuda.device_count() if cuda else 1
    topo = ProcessTopology(process_id=pid, num_processes=nproc, local_device_count=n_local,
                           global_device_count=sum(len(i[2]) for i in infos))
    _ACTIVE = (topo, arg_key, infos)
    return topo


def rank_entries() -> Optional[list]:
    """Each rank's mesh entry as gathered by :func:`init_distributed`:
    ``[device kind, device type, [index]]`` per rank, None before it."""
    return None if _ACTIVE is None else [list(i) for i in _ACTIVE[2]]


def destroy_distributed(timeout_s: float = 60.0) -> None:
    """Destroy the process group (if any) and forget the topology, so
    this process may join another job. Every process calls it; process
    0, which hosts the store, goes last: it waits (up to ``timeout_s``)
    until every other process has made its last store call."""
    global _ACTIVE
    store = _store()
    if store is not None:
        key = _next_base("destroy", "bye") + "/n"
        if process_index() != 0:
            store.add(key, 1)
        else:
            deadline = monotonic() + float(timeout_s)
            while store.add(key, 0) < process_count() - 1 and monotonic() < deadline:
                time.sleep(0.01)
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _ACTIVE = None
    _KV_SEQ.clear()


def _store():
    """The process group's key-value store (a world of one included, so
    its barriers and agreements run on the store too), or None without a
    process group (the degenerate case every collective below treats as
    'I am the whole job')."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed import distributed_c10d

    return distributed_c10d._get_default_store()


# per-tag sequence numbers so a tag reused across calls never collides in
# the store; identical on every process because collectives are called in
# SPMD order
_KV_SEQ: dict = {}


def _next_base(kind: str, tag: str) -> str:
    seq = _KV_SEQ.get((kind, tag), 0)
    _KV_SEQ[(kind, tag)] = seq + 1
    return f"smk/{kind}/{tag}/{seq}"


def barrier_sync(name: str, *, timeout_s: float) -> None:
    """Block until every process reaches the barrier ``name``, or raise
    :class:`CollectiveTimeoutError` after ``timeout_s``. A no-op in a
    single-process job. Every process calls with the same name in the
    same order."""
    if timeout_s <= 0:
        raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
    store = _store()
    if store is None:
        return
    base = _next_base("barrier", str(name))
    try:
        if store.add(f"{base}/n", 1) == process_count():
            store.set(f"{base}/done", b"1")
        store.wait([f"{base}/done"], datetime.timedelta(seconds=float(timeout_s)))
    except Exception as e:
        raise CollectiveTimeoutError(f"barrier:{name}", timeout_s, cause=e) from e


def allgather_bytes(tag: str, payload: bytes, *, timeout_s: float) -> list:
    """All-gather one small byte string per process: the payloads ordered
    by process index, the same list on every process. A single-process
    job returns ``[payload]``. Each peer's wait gives up after
    ``timeout_s`` with a :class:`CollectiveTimeoutError` naming the
    missing process."""
    if timeout_s <= 0:
        raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
    store = _store()
    if store is None:
        return [bytes(payload)]
    base = _next_base("allgather", str(tag))
    try:
        store.set(f"{base}/{process_index()}", bytes(payload))
    except Exception as e:
        raise CollectiveTimeoutError(f"allgather-set:{tag}", timeout_s, cause=e) from e
    out = []
    for p in range(process_count()):
        try:
            store.wait([f"{base}/{p}"], datetime.timedelta(seconds=float(timeout_s)))
            out.append(bytes(store.get(f"{base}/{p}")))
        except Exception as e:
            raise CollectiveTimeoutError(f"allgather-get:{tag}[process {p}]", timeout_s,
                                         cause=e) from e
    return out
