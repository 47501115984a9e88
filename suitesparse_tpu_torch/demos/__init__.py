"""The five demo programs of the repository's ``demos/``, on the port.

    python -m suitesparse_tpu_torch.demos.cholmod_demo [name]
    python -m suitesparse_tpu_torch.demos.klu_demo
    python -m suitesparse_tpu_torch.demos.cs_demo [--device cpu]
    python -m suitesparse_tpu_torch.demos.umfpack_demo [--device cpu]
    python -m suitesparse_tpu_torch.demos.graphblas_demo [--device cpu]

Each prints the same lines as its counterpart in ``demos/`` (whose expected
output is ``demos/expected/<demo>.out``), on the genuine reference
fixtures that ``io.fixtures.load`` finds (``SSTPU_REFERENCE``).
``cs_demo``, ``umfpack_demo`` and ``graphblas_demo`` run on the card
unless ``--device cpu`` (``main(device="cpu")``) is asked for, and raise
without one; ``cholmod_demo`` and ``klu_demo`` run host code only, in
float64.
"""
