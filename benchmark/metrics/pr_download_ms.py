"""pr_download_ms: mean host time of the ranks' copy to the host per
PageRank call in the window: the program's span
graphblas.pagerank.download, one in each solve call."""
from harness import program_spans


def read(run):
    return program_spans.mean_ms(program_spans.window_calls(
        run, "solve", "graphblas.pagerank.download"))
