from .spqr import (QRSymbolic, QRNumeric, qr_symbolic, qr_factorize,
                   qr_rsolve, qr_rtsolve, qr_solve, qr_qmult, qr_q,
                   qr_min2norm, qr_numeric_from_numpy, r_diagonal,
                   qr_get_r, qr_program)
