from .ssmult import sfmult, ssmult
from . import ldl
