from .ssmult import sfmult, ssmult
