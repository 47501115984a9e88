from .native import has_native, get_lib
from .serialize import (save_sparse, load_sparse, save_factor, load_factor,
                        save_super_factor, load_super_factor,
                        matrix_serialize, matrix_deserialize)
