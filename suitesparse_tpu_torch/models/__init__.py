from .factorize import Factorize, backslash
from .spqr_rank import (spqr_basic, spqr_null, spqr_pinv, spqr_rank)
from .sparseinv import sparseinv
from .meshnd import meshnd, meshsparse
from .ssmult import sfmult, ssmult
from . import csparse, ldl
