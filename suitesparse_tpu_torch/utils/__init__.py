from .native import has_native, get_lib
