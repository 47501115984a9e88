from .core import (GrBMatrix, Monoid, Semiring, semiring, mxv, vxm, mxm,
                   ewise_add, ewise_mult, apply, select, reduce_rows,
                   reduce_scalar, transpose, kron, build, extract_tuples,
                   extract, assign, ewise_union, concat, split, reshape,
                   sort, MONOIDS, BINOPS, UNARYOPS)
from .objects import (Descriptor, GrBVector, Storage, MatrixIterator,
                      iterate_entries, realize, to_csc, auto_format,
                      HYPERSPARSE, SPARSE, BITMAP, FULL, BY_ROW, BY_COL,
                      DESC_T0, DESC_T1, DESC_T0T1, DESC_C, DESC_S, DESC_R,
                      DESC_RC, DESC_SC)
from .extra import (POSITIONAL_BINOPS, positional_mxm, positional_mxv,
                    INDEXUNARY_OPS, apply_indexop, select_indexop,
                    pack_csc, unpack_csc, pack_csr, unpack_csr,
                    pack_coo, unpack_coo, pack_full, unpack_full,
                    pack_bitmap, unpack_bitmap)
from .algorithms import pagerank, bfs_levels, triangle_count
from ..utils.serialize import matrix_serialize, matrix_deserialize
