"""block_chol_roofline_pct: the least time of one factor's block_chol
launches (per launch the larger of its flops over the float32 peak and its
bytes over the HBM peak, harness.counts) over their summed kernel time per
refactorization in the traced window, in %.  Nothing is read where the
trace's block_chol launches per refactorization differ from the plan's
count."""
import sys

from harness import counts


def read(run):
    t = run.trace
    bc = run.counters.get("block_chol")
    if t is None or run.device.type != "cuda" or not bc or not bc["trsm_inv"]:
        return None
    shapes = counts.block_chol_shapes(bc["fmeta"], bc["instr_cls"],
                                      bc["potrf_maxnp"])
    n = t["calls"].get("refactorize", 0)
    seen = t["kernel_n"].get("refactorize", {}).get("block_chol", 0)
    if not n or not shapes or seen != n * sum(shapes.values()):
        print(f"[bench] block_chol: {seen} launches in {n} traced "
              f"refactorizations, the plan counts "
              f"{sum(shapes.values())} each", file=sys.stderr)
        return None
    took = t["kernel_us"]["refactorize"]["block_chol"] / n / 1e6
    least = counts.block_chol_least_s(shapes, run.counters["itemsize"])
    return counts.share_of_peak(least, took, "block_chol")
