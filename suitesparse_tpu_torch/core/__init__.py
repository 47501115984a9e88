from .common import Common, CholeskyOptions, LUOptions, QROptions, default_common
from .sparse import (SparseCSC, Triplet, add, aat, eye, spzeros, horzcat,
                     vertcat, submatrix, symmetry, invert_permutation,
                     extract_diagonal, UNSYM, SYM_UPPER, SYM_LOWER)
from .status import SparseError, Status
