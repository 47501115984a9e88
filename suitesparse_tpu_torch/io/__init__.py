from .matrixmarket import mmread, mmwrite, mmread_dense
from .rbio import rbread, rbwrite, rbkind
from . import collection, generators
