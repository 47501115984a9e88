from .symbolic import Symbolic, analyze, analyze_ordering
from .supernodal import SuperSymbolic, super_symbolic
from .super_numeric import (SuperFactor, NumericPlan, build_plan,
                            factor_from_numpy, factorize_super, solve_super)
from .api import residual_norm
