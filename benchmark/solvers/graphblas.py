"""The GraphBLAS front end of suitesparse_tpu_torch as a graph-analytics
code drives it: GAP's PageRank (damping, tolerance and iteration cap from
the mix) on an undirected graph held by the program, each call from
uniform ranks to the stop, the ranks returned to the host.

The configuration's matrix is the strictly lower triangle L of the
graph's adjacency (``generators/kron_g500.py``): each undirected edge
once.  The front end hands it to the program as a symmetric matrix stored
by its lower triangle (a pattern ``SparseCSC`` with stype -1), which the
program's import (``graphblas.compact_graph``, in set-up inside the
harness's ``analyze`` span) expands to both directions on the device.
PageRank reads only the pattern: the value sets the harness makes (ones)
are not read.

Steps (a mix names one in its ``step``):

``step_pagerank``  ``graphblas.pagerank`` on the graph, inside the
                   harness's ``solve`` span.

It returns the answer the judge reads: (iterations run, ranks as a host
vector), the iterations from the program's counter
``graphblas.pagerank.iterations`` (imported here, so that a program
without its counters fails at once).  The ranks are in the program's
float type on the device (float32 on the card, float64 on the CPU), which
the configuration's ``dtype`` has to name.  There is no factor:
``factor()`` gives None.

The program's counts of each call (iterations, predicated steps run,
loop-program runs) are summed by the phase of the harness's spans
(``setup``, ``window``, ``traced``) in ``counters()["phases"]``, a table
the driver keeps filling after the harness has read ``counters()`` at the
end of set-up: the per-layer metrics read the window's calls from it, not
set-up's.
"""
from __future__ import annotations

import torch

from suitesparse_tpu_torch.core.sparse import SYM_LOWER, SparseCSC
from suitesparse_tpu_torch.graphblas import compact_graph, pagerank
from suitesparse_tpu_torch.utils.device import default_dtype, torch_dtype
from suitesparse_tpu_torch.utils.trace import counts

PR = "graphblas.pagerank"
COUNTS = ("iterations", "steps_run", "program_runs")


class Driver:
    """One configuration's graph on one device.

    A0:     the configuration's strictly lower triangle (SciPy CSC).
    config: the configuration (its ``dtype``: the ranks', a torch dtype's
            name, the program's on the device).
    spans:  the harness's span recorder (``harness.tracing.Spans``)."""

    def __init__(self, A0, config: dict, device, spans):
        self.A0 = A0
        self.device = torch.device(device)
        runs = torch_dtype(default_dtype(self.device))
        if getattr(torch, config["dtype"]) != runs:
            raise ValueError(f"the configuration's dtype {config['dtype']} "
                             f"is not the program's on {self.device}: "
                             f"{runs}")
        self.spans = spans
        self.G = None           # the program's graph (SparseCSC)
        self.graph = None       # its device layout
        self.phases = {}        # {phase: summed counts of its calls}

    def analyze(self) -> None:
        with self.spans("analyze"):
            A = self.A0
            self.G = SparseCSC(A.indptr, A.indices, None, A.shape,
                               stype=SYM_LOWER)
            self.graph = compact_graph(self.G, self.device)

    def set_values(self, values) -> None:
        """PageRank reads the pattern only.  The harness calls this at the
        start of each run: the counts by phase start anew."""
        self.phases.clear()

    def step_pagerank(self, pools, i: int) -> tuple:
        mix = pools.mix
        before = counts()
        with self.spans("solve"):
            r = pagerank(self.G, mix["damping"], mix["tol"],
                         mix["max_iter"], device=self.device)
        after = counts()
        got = {k: after.get(f"{PR}.{k}", 0) - before.get(f"{PR}.{k}", 0)
               for k in COUNTS}
        sums = self.phases.setdefault(self.spans.phase,
                                      dict.fromkeys(COUNTS + ("calls",), 0))
        sums["calls"] += 1
        for k in COUNTS:
            sums[k] += got[k]
        return got["iterations"], r

    def counters(self) -> dict:
        """The program's own counts: ``phases`` (the live table of the
        calls' counts by phase, see above), the graph's vertices, arcs and
        the ranks' bytes (for the work count), and the loop program's
        warm-up and capture seconds and graph nodes."""
        g = self.graph
        out = dict(program="pagerank", n=g.n, arcs=g.arcs,
                   itemsize=g.dinv.element_size(), phases=self.phases)
        for key, prog in self.G._loop_programs.items():
            if key[0] == "pagerank" and prog.graph is not None:
                out.update(warmup_s=prog.warmup_s, capture_s=prog.capture_s,
                           graph_nodes=prog.nodes)
        return out

    def factor(self):
        return None

    def close(self) -> None:
        """Drop the program's state (the graph, its layout and captured
        program)."""
        self.G = self.graph = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
