"""factor_graph_nodes: nodes of the captured factor program's CUDA graph
(cm.info factor_graph_nodes)."""


def read(run):
    n = run.counters.get("graph_nodes")
    return n if run.device.type == "cuda" and n else None
