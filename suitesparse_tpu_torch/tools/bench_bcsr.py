"""Check and time the ``bcsr_spmm`` kernel of one source tree on lap3d_44's
block table, so that two versions of the kernel can be compared on one
card; and the kernel's checks that ``chip_smoke.py`` and the card tests
share (``measure``, ``inf_nan_case``).

    python3 suitesparse_tpu_torch/tools/bench_bcsr.py [--tree DIR]

imports ``suitesparse_tpu_torch`` from DIR (default: the tree that holds
this file), so a second tree unpacked beside the repository (for example
``git archive <commit> suitesparse_tpu_torch | tar -x -C build/parent``)
is timed with its own kernel source, built into its own ``build/kernels``.
Run the trees in turns (A, B, B, A) in one call to the card.

For each k in ``K_WIDTHS`` it builds lap3d_44's full symmetric pattern in
float32 (666 block rows x 7 slots), draws X (n, k) from a seeded normal
(the same X as ``chip_smoke.py``'s), and runs ``measure``.  It prints one
JSON line with the tree, a hash of its kernel source, the card's name and
power limit (nvidia-smi), and per k the time and the errors.  It fails
without a card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys

import numpy as np

K_WIDTHS = (32, 128)      # right-hand-side widths of the timed products
REPS = 50                 # launches a timed run
TOL = 1e-5                # relative, against plain and scipy in float64


def measure(bc, X, S) -> dict:
    """Check ``bcsr_spmm(bc, X)`` on the card against the plain version
    and against scipy's ``S @ X`` in float64 (TOL relative), and a
    repeated call for bit-identity; then time it: CUDA events over REPS
    back-to-back launches after one warm call.  Returns the mean ms a
    call and the errors; raises RuntimeError on a failed check."""
    import torch
    from suitesparse_tpu_torch.ops import spmv
    blocks, cols = bc.device_arrays(X.device)
    K = spmv.bcsr_spmm(bc, X)
    P = spmv.bcsr_spmm_plain(blocks, cols, X, bc.nslots, bc.shape)
    torch.cuda.synchronize()
    k = X.shape[1]
    ref = S @ X.double().cpu().numpy()
    e_plain = float((K - P).abs().max() / P.abs().max())
    e_ref = float(np.abs(K.double().cpu().numpy() - ref).max()
                  / np.abs(ref).max())
    if max(e_plain, e_ref) > TOL:
        raise RuntimeError(f"bcsr_spmm k={k}: {e_plain:.2e} from plain, "
                           f"{e_ref:.2e} from scipy")
    if not torch.equal(spmv.bcsr_spmm(bc, X), K):
        raise RuntimeError(f"bcsr_spmm k={k}: a repeated call differs")
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(REPS):
        spmv.bcsr_spmm(bc, X)
    e1.record()
    torch.cuda.synchronize()
    return dict(ms=e0.elapsed_time(e1) / REPS, rel_err_plain=e_plain,
                rel_err_scipy=e_ref,
                max_abs_err=float((K - P).abs().max()))


def inf_nan_case(rng):
    """A BCSR with pad slots, and an X, holding Inf and NaN: in A (an Inf,
    a -Inf and a NaN with a payload only in its low bits, at nonzeros of
    different block rows), in X (Inf, -Inf, NaN; the -Inf meets A values
    that are exact in TF32, whose lo part is 0) and in X's block 0 (row 5:
    an Inf that reaches every row with a pad slot through 0 * Inf)."""
    import scipy.sparse as sp
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    from suitesparse_tpu_torch.ops.spmv import to_bcsr
    S = sp.random(1000, 700, 0.00005, random_state=rng, format="lil")
    S[3, :] = rng.standard_normal(700)    # block row 0 holds every slot
    S[[40, 640, 900], 450] = [2.0, -6.0, 0.75]
    bc = to_bcsr(SparseCSC.from_scipy(S.tocsc()))
    bits = bc.blocks.view(np.uint32)
    nzb = np.flatnonzero((bc.blocks != 0).any((1, 2)))
    for b, val in zip(nzb[[0, len(nzb) // 2, -1]],
                      (0x7F800000, 0xFF800000, 0x7F800001)):
        i, j = np.argwhere(bc.blocks[b] != 0)[0]
        bits[b, i, j] = val
    X = rng.standard_normal((700, 9)).astype(np.float32)
    X[5, 0] = np.inf
    X[300, 2] = np.nan
    X[450, 4] = -np.inf
    return bc, X


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve()
                                          .parents[2]))
    args = ap.parse_args(argv)
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("bench_bcsr: no CUDA device", file=sys.stderr)
        return 2
    from suitesparse_tpu_torch.core.sparse import SparseCSC
    from suitesparse_tpu_torch.io.generators import synthetic_standin
    from suitesparse_tpu_torch.ops import spmv
    src = tree / "suitesparse_tpu_torch" / "csrc" / "bcsr_spmm.cu"
    assert pathlib.Path(spmv.__file__).resolve().is_relative_to(tree)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]

    A = synthetic_standin("lap3d_44").to_full_storage()
    A = SparseCSC(A.indptr, A.indices, A.data.astype(np.float32), A.shape)
    S = A.to_scipy().astype(np.float64)
    bc = spmv.to_bcsr(A)
    rng = np.random.default_rng(6)
    out = dict(tree=str(tree), source_sha1=hashlib.sha1(
        src.read_bytes()).hexdigest()[:12], card=smi, nrb=bc.nrb,
        nslots=bc.nslots, reps=REPS)
    for k in K_WIDTHS:
        X = torch.as_tensor(rng.standard_normal((A.ncol, k))
                            .astype(np.float32), device="cuda")
        out[f"k{k}"] = measure(bc, X, S)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
