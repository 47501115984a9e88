from .host import host_matmul, sdmult, ssmult, scale
from .spgemm import spgemm, spgemm_plan, spgemm_apply, cached_plan
from .spmv import spmv_program, spmm_program, to_bcsr, bcsr_spmm
