"""Operator framework.

The port of ``auron_tpu.ops.base``: operators are a tree of
``PhysicalOp``s; ``execute(partition, ctx)`` returns a pull-based
iterator of ``DeviceBatch``es. The host loop stays in Python and each
per-batch step is a handful of eager PyTorch ops on the batch's device;
nothing is compiled and nothing is donated.

Host syncs. A step reads a device value on the host only through
``host_readback``, which fetches every control value it is given in one
``torch.cat([...]).tolist()`` and counts the round trip in
``host_readback.syncs``. Metrics take device scalars without reading
them (``Metric.add``), and a timer waits for the device only when
``ExecContext.device_sync`` asks it to, so the syncs of a run are the
readbacks the operators need for their shapes and nothing else.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

import torch

from auron_tpu_torch.columnar.batch import DeviceBatch
from auron_tpu_torch.columnar.schema import Schema


def host_readback(values) -> list:
    """Every tensor of ``values`` on the host, in one round trip: a 0-d
    tensor as a python int, any other as a list of ints; python values
    pass through. Integer and bool tensors only. Counted in
    ``host_readback.syncs``."""
    values = list(values)
    dev = [v for v in values if isinstance(v, torch.Tensor)]
    if not dev:
        return values
    host_readback.syncs += 1
    flat = torch.cat([v.reshape(-1).to(torch.int64) for v in dev]).tolist()
    out, off = [], 0
    for v in values:
        if not isinstance(v, torch.Tensor):
            out.append(v)
            continue
        n = v.numel()
        out.append(flat[off] if v.dim() == 0 else flat[off:off + n])
        off += n
    return out


host_readback.syncs = 0


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: a device → host copy, which waits for the
    device, counted in ``host_readback.syncs`` like a readback."""
    if t.device.type != "cpu":
        host_readback.syncs += 1
    return t.cpu()


class Metric:
    """A counter. ``add`` takes a python number or a device scalar; device
    scalars are kept as they are and summed when ``value`` is read, so
    counting rows costs no host sync on the hot path."""

    __slots__ = ("_value", "_pending", "_mirror")

    def __init__(self, mirror: "Optional[Metric]" = None):
        self._value = 0
        self._pending: list = []
        self._mirror = mirror

    def add(self, v) -> None:
        if isinstance(v, torch.Tensor):
            self._pending.append(v)
        else:
            self._value += v
        if self._mirror is not None:
            self._mirror.add(v)

    @property
    def value(self):
        if self._pending:
            pending, self._pending = self._pending, []
            self._value += sum(int(x) for x in host_readback(pending))
        return self._value


class MetricsSet:
    """Per-operator metrics under the reference's canonical names
    (output_rows, output_batches, elapsed_compute, ...). A set with a
    ``mirror`` chains every counter's adds into the same-named counter of
    the mirror: the per-instance sets of ``ExecContext.metrics_for(op)``
    stay consistent with the name-keyed aggregate ``ctx.metrics[name]``."""

    def __init__(self, mirror: "Optional[MetricsSet]" = None):
        self._metrics: dict[str, Metric] = {}
        self._mirror = mirror

    def counter(self, name: str) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            chained = (self._mirror.counter(name)
                       if self._mirror is not None else None)
            m = self._metrics[name] = Metric(chained)
        return m

    def snapshot(self) -> dict[str, int]:
        return {k: m.value for k, m in self._metrics.items()}


def _device_sync(value) -> None:
    """Wait until the device work behind ``value`` (a tensor, a batch or
    a nest of them) is done: ``torch.cuda.synchronize`` on a CUDA device,
    where the reference blocks on one result. CPU tensors are ready."""
    dev = _device_of(value)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_of(value) -> Optional[torch.device]:
    if isinstance(value, torch.Tensor):
        return value.device
    if isinstance(value, DeviceBatch):
        return value.device
    if isinstance(value, (tuple, list)):
        for v in value:
            d = _device_of(v)
            if d is not None:
                return d
    return None


class timer:
    """Context manager adding wall nanoseconds to a metric. ``track(x)``
    registers a result to wait for before the clock stops, so that
    ``elapsed_compute`` is device compute rather than dispatch; the wait
    happens only when ``sync`` is true (``ExecContext.device_sync``)."""

    __slots__ = ("metric", "t0", "_tracked", "sync")

    def __init__(self, metric: Metric, sync: bool = True):
        self.metric = metric
        self.sync = sync
        self._tracked = None

    def track(self, value):
        """Register a result to sync on at exit; returns it."""
        self._tracked = value
        return value

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._tracked is not None and exc[0] is None and self.sync:
            _device_sync(self._tracked)
        self._tracked = None
        self.metric.add(time.perf_counter_ns() - self.t0)
        return False


@dataclass
class ExecContext:
    """Per-task execution context: identity, metrics registry, config and
    the cancellation flag. The reference's heartbeat, watchdog, mesh
    plane and pipelining wait for the slices that port them."""

    stage_id: int = 0
    partition_id: int = 0
    task_id: int = 0
    num_partitions: int = 1
    metrics: dict[str, MetricsSet] = field(default_factory=dict)
    #: the spill tier is not ported: an operator that finds a memory
    #: manager here raises NotImplementedError instead of running
    #: without it
    mem_manager: Optional[object] = None
    #: shared cancellation flag, created eagerly so derived contexts
    #: (``child``) share the same event
    cancel_event: object = field(default_factory=threading.Event)
    config: Optional[object] = None
    #: per-op-INSTANCE metric sets keyed (id(op), suffix)
    op_metrics: dict = field(default_factory=dict)
    #: should operator timers wait for the device? The reference's
    #: ``auron.metrics.device_sync`` is on, but its pipelined mode (on by
    #: default) turns the wait off; the port has no pipelined mode and
    #: keeps that effective default, off, so the only per-batch syncs are
    #: the operators' readbacks
    device_sync: bool = False

    def child(self, **overrides) -> "ExecContext":
        """Derived context for a sub-execution (the map side of an
        exchange): inherits config, metrics and the cancellation flag;
        identity fields may be overridden."""
        base = dict(
            stage_id=self.stage_id, partition_id=self.partition_id,
            task_id=self.task_id, num_partitions=self.num_partitions,
            metrics=self.metrics, mem_manager=self.mem_manager,
            cancel_event=self.cancel_event, config=self.config,
            op_metrics=self.op_metrics, device_sync=self.device_sync)
        base.update(overrides)
        return ExecContext(**base)

    def check_cancelled(self) -> None:
        """Raise TaskCancelled if the host cancelled this task: operators
        call it between child batches."""
        if self.cancel_event.is_set():
            raise TaskCancelled(
                f"task {self.task_id} (stage {self.stage_id}, partition "
                f"{self.partition_id}) was cancelled")

    @property
    def conf(self):
        if self.config is None:
            from auron_tpu_torch.config import get_config
            self.config = get_config()
        return self.config

    def metrics_for(self, op, suffix: str = "") -> MetricsSet:
        """A string gives the name-keyed set; an operator instance gives
        its own set, whose counters chain into the name-keyed one."""
        if isinstance(op, str):
            name = op + suffix
            if name not in self.metrics:
                self.metrics[name] = MetricsSet()
            return self.metrics[name]
        key = (id(op), suffix)
        entry = self.op_metrics.get(key)
        if entry is None:
            # the entry pins the op: id() keys are unique only while the
            # object lives
            entry = (op, MetricsSet(
                mirror=self.metrics_for(op.name + suffix)))
            self.op_metrics[key] = entry
        return entry[1]


class TaskCancelled(Exception):
    """The host cancelled this task mid-stream; operators unwind."""


class PhysicalOp:
    """Base physical operator."""

    #: operator display name (metric key prefix)
    name: str = "op"

    #: may a consumer destroy the batches execute() yields? True for ops
    #: that build fresh tensors per output batch, "inherit" for
    #: pass-through ops, False for sources that replay shared batches.
    #: Read through ``yields_owned_batches``.
    owns_output = True

    #: does this op implement the fragment protocol (ops/fused.py)? The
    #: planner's fusion pass chains only fusable ops into a stage.
    fusable: bool = False

    #: batches this op's fragment emits per input batch (ExpandOp emits
    #: one per projection); the fusion pass bounds the product along a
    #: chain.
    fusion_fanout: int = 1

    #: does this op's fragment do real device work? Pass-through
    #: fragments (limit's row-count rewrite, rename's identity) are
    #: False: the fusion pass only makes stages holding at least one
    #: computing member.
    fragment_computes: bool = False

    def build_kernel_fragment(self) -> Optional["object"]:
        """This op's ``KernelFragment`` (ops/fused.py), or None when the
        op cannot fuse. Implemented iff ``fusable`` is True."""
        return None

    @property
    def children(self) -> list["PhysicalOp"]:
        return []

    def schema(self) -> Schema:
        raise NotImplementedError

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        raise NotImplementedError

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + repr(self) + "\n"
        for c in self.children:
            s += c.tree_string(indent + 1)
        return s

    def __repr__(self):
        return type(self).__name__


def yields_owned_batches(op: PhysicalOp) -> bool:
    """True when every batch ``op.execute`` yields is freshly built and
    dead to the producer once consumed."""
    owned = getattr(op, "owns_output", True)
    if owned == "inherit":
        return all(yields_owned_batches(c) for c in op.children)
    return bool(owned)


def count_output(stream, metrics: MetricsSet, timed: bool = False):
    """Wrap a batch stream with output_rows/output_batches counting (the
    row count is added as the device scalar it is). ``timed=True`` also
    adds the time spent inside the producer's ``next()`` to
    ``elapsed_compute``, for operators that run no device step of their
    own."""
    rows = metrics.counter("output_rows")
    batches = metrics.counter("output_batches")
    if not timed:
        for b in stream:
            rows.add(b.num_rows)
            batches.add(1)
            yield b
        return
    elapsed = metrics.counter("elapsed_compute")
    it = iter(stream)
    while True:
        t0 = time.perf_counter_ns()
        try:
            b = next(it)
        except StopIteration:
            elapsed.add(time.perf_counter_ns() - t0)
            return
        elapsed.add(time.perf_counter_ns() - t0)
        rows.add(b.num_rows)
        batches.add(1)
        yield b
