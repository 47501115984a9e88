from .native import has_native, get_lib
from .serialize import (save_sparse, load_sparse, save_factor, load_factor,
                        save_super_factor, load_super_factor, save_klu,
                        load_klu, save_umf_symbolic, load_umf_symbolic,
                        save_umf_numeric, load_umf_numeric,
                        matrix_serialize, matrix_deserialize)
