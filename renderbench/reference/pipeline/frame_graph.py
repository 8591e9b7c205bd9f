"""Frame graph: dependency edges from declared IO + stable topological order
(port of lsr_tpu/pipeline/frame_graph.py, carried over as it is).

Semantics match FrameGraph (pipeline/frame_graph.hpp:40-180):
- RAW edge producer -> consumer for every resource a later pass reads that an
  earlier pass writes,
- WAW edge between successive writers of the same resource (order preserved),
- Kahn toposort, stable by insertion order (ties broken by original index),
- a cycle produces an error report and falls back to insertion order instead
  of aborting.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class GraphReport:
    order: List[int] = dataclasses.field(default_factory=list)
    edges: List[tuple] = dataclasses.field(default_factory=list)
    errors: List[str] = dataclasses.field(default_factory=list)
    warnings: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors


def compile_frame_graph(passes) -> GraphReport:
    """passes: sequence of RenderPass (enabled ones are ordered; disabled
    passes are skipped entirely).

    Edge rule, matching frame_graph.hpp:99-116 for every pair i < j sharing
    a resource:
      - i writes and j reads-or-writes  => edge i -> j,
      - else j writes and i reads       => edge j -> i  (a reader inserted
        before its producer is reordered to run after it).
    """
    report = GraphReport()
    active = [(i, p) for i, p in enumerate(passes) if p.enabled]
    n = len(active)

    ios = []
    for _, p in active:
        io = p.describe_io()
        # optional_reads participate in edge construction (ordering) but
        # are not execution requirements (render_pass.PassIO).
        reads = set(io.reads) | set(getattr(io, "optional_reads", ()))
        writes = set(io.writes)
        ios.append((reads, writes))

    edges = set()
    for a in range(n):
        ra, wa = ios[a]
        for b in range(a + 1, n):
            rb, wb = ios[b]
            for res in (ra | wa) & (rb | wb):
                i_read, i_write = res in ra, res in wa
                j_read, j_write = res in rb, res in wb
                if i_write and (j_read or j_write):
                    edges.add((active[a][0], active[b][0]))
                elif j_write and i_read:
                    edges.add((active[b][0], active[a][0]))

    report.edges = sorted(edges)

    # Kahn toposort: initial zero-indegree set sorted by insertion order,
    # then a plain FIFO queue (frame_graph.hpp:147-170).
    indeg = {idx: 0 for idx, _ in active}
    succ = {idx: [] for idx, _ in active}
    for a, b in sorted(edges):
        indeg[b] += 1
        succ[a].append(b)

    queue = sorted([i for i, d in indeg.items() if d == 0])
    order = []
    head = 0
    while head < len(queue):
        cur = queue[head]
        head += 1
        order.append(cur)
        for nxt in succ[cur]:
            indeg[nxt] -= 1
            if indeg[nxt] == 0:
                queue.append(nxt)

    if len(order) != n:
        report.errors.append(
            "frame graph has a cycle; falling back to insertion order"
        )
        order = [idx for idx, _ in active]

    report.order = order
    return report
