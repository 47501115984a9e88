"""pr_steps_run: the predicated power steps a PageRank call ran, those
after the stop included: the program's counter
graphblas.pagerank.steps_run, summed over the window's calls by the front
end (counters()["phases"]["window"]), per call."""


def read(run):
    c = run.counters
    if c.get("program") != "pagerank":
        return None
    w = c.get("phases", {}).get("window")
    return w["steps_run"] / w["calls"] if w and w["calls"] else None
