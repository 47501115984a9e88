from .sparseinv import sparseinv
from .ssmult import sfmult, ssmult
from . import ldl
