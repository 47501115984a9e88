from .symbolic import Symbolic, analyze, analyze_ordering
from .simplicial import (Factor, factorize_simplicial, solve, lsolve, ltsolve,
                         dsolve, rcond, rowfac, rowfac_mask, alloc_factor)
from .supernodal import SuperSymbolic, super_symbolic
from .super_numeric import (SuperFactor, NumericPlan, build_plan,
                            factor_from_numpy, factorize_super, solve_super)
from .api import CholeskySolver, cholesky, spsolve_chol, residual_norm
from .modify import updown, updown_solve, rowadd, rowdel
from .extra import spsolve, solve2, resymbol, lsolve_pattern, row_subtree
