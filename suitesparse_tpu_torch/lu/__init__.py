from .klu import (KLUSymbolic, KLUNumeric, klu_analyze, klu_factor,
                  klu_refactor, klu_solve, klu_rcond, klu_condest, klu_rgrowth)
from .klu_device import (KLUDevicePlan, klu_device, klu_device_plan,
                         klu_refactor_jit, klu_solve_jit)
from .multifrontal import (UmfSymbolic, UmfNumeric, umf_symbolic, umf_numeric,
                           umf_solve, umf_wsolve, umf_lunz, umf_determinant,
                           umf_get_numeric)
from .slip import slip_backslash, slip_lu_analyze, slip_lu_factorize, slip_lu_solve
from . import report
