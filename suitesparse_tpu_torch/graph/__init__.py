from .structure import (etree, postorder, col_counts, ereach, reach,
                        tree_levels, tree_depth_below, firstdesc,
                        chol_symbolic_flops)
from .btf import maxtrans, strongcomp, btf_order, dmperm, BTFResult, DMPermResult
from .partition import edge_cut, vertex_separator, EdgeCutOptions, EdgeCutResult
