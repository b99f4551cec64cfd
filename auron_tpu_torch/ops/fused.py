"""Whole-stage fusion: one operator per chain of row-local operators.

The port of ``auron_tpu.ops.fused``. The planner's fusion pass
(``ir/planner.fuse_stages``) turns a maximal chain of fusable operators
(filter, project, limit-within-batch, rename) into one
``FusedStageOp``. In the reference the stage is one jit-compiled XLA
program; here it runs its members' per-batch functions in order,
eagerly, on each input batch, so a stage saves the per-operator
generator hops but launches the same device work as its members.

Fragment contract (``PhysicalOp.build_kernel_fragment``):

    apply(batch, partition_id, carry) -> (out_batches, carry')

``carry`` is one python int of per-member streaming state: the
remaining row budget of a limit, or the row offset a filter or
projection hands to row-numbering expressions. The port's evaluator has
no such expression yet, so those members keep their carry at 0. A
limit's budget is read once per batch on the host, the same sync the
unfused ``LimitOp`` makes, and the stage stops pulling its input once a
budget is spent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

from auron_tpu_torch.columnar.batch import DeviceBatch
from auron_tpu_torch.columnar.schema import Schema
from auron_tpu_torch.ops.base import (ExecContext, PhysicalOp, count_output,
                                      timer)


@dataclass(frozen=True)
class KernelFragment:
    """One operator's per-batch function in a fused stage. ``init_carry``
    seeds the member's carry at stream start; ``is_limit`` marks a carry
    that counts a remaining row budget."""

    apply: Callable
    init_carry: int = 0
    is_limit: bool = False


def thread_fragments(fragments, batch: DeviceBatch, partition_id,
                     carries: list) -> tuple[tuple, list]:
    """Run every intermediate batch through the member chain in order,
    each member's carry advancing across them as the unfused operators'
    streams would. Returns (out_batches, carries')."""
    outs = (batch,)
    new_carries = []
    for frag, carry in zip(fragments, carries):
        nxt = []
        for b in outs:
            res, carry = frag.apply(b, partition_id, carry)
            nxt.extend(res)
        outs = tuple(nxt)
        new_carries.append(carry)
    return outs, new_carries


class FusedStageOp(PhysicalOp):
    """A maximal chain of fusable operators run as one operator.

    ``members`` are ordered upstream → downstream; the stage's input is
    the first member's child. Schema and output batches are those of the
    members run one by one."""

    name = "fused_stage"

    def __init__(self, members: list[PhysicalOp]):
        assert members, "fused stage needs at least one member"
        for m in members:
            assert m.fusable, f"{m!r} is not fusable"
        self.members = list(members)
        self.input = members[0].children[0]
        self._schema = members[-1].schema()

    @property
    def children(self):
        return [self.input]

    @property
    def owns_output(self):
        # a chain with a computing member gathers or projects into fresh
        # tensors; a pure pass-through chain (rename/limit) aliases its
        # input's columns
        if any(m.fragment_computes for m in self.members):
            return True
        return "inherit"

    def schema(self) -> Schema:
        return self._schema

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        metrics = ctx.metrics_for(self)
        elapsed = metrics.counter("elapsed_compute")
        fragments = [m.build_kernel_fragment() for m in self.members]
        limit_slots = [i for i, f in enumerate(fragments) if f.is_limit]
        sync = ctx.device_sync

        def stream():
            carries = [f.init_carry for f in fragments]
            for batch in self.input.execute(partition, ctx):
                ctx.check_cancelled()
                with timer(elapsed, sync=sync) as t:
                    outs, carries = t.track(thread_fragments(
                        fragments, batch, partition, carries))
                yield from outs
                if any(carries[i] <= 0 for i in limit_slots):
                    break

        return count_output(stream(), metrics)

    def __repr__(self):
        inner = " -> ".join(repr(m) for m in self.members)
        return f"FusedStageOp[{inner}]"
