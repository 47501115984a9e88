"""setup_s: seconds from the process's start to the end of set-up (matrix,
pools, analysis, first refactorization with warm-up and capture, first
solve), on the host's clock."""


def read(run):
    return run.setup_s
