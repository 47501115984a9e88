from .common import Common, CholeskyOptions, LUOptions, QROptions, default_common
from .sparse import (SparseCSC, Triplet, add, aat, eye, spzeros, horzcat,
                     vertcat, submatrix, symmetry, invert_permutation,
                     extract_diagonal, UNSYM, SYM_UPPER, SYM_LOWER)
from .status import SparseError, Status
from .check import (check_sparse, check_triplet, check_perm, check_parent,
                    check_factor, print_sparse, print_factor, print_perm,
                    print_common)
