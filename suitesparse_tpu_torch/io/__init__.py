from . import generators
