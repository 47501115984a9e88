from .amd import amd, camd, amd_valid, amd_info
from .colamd import colamd, symamd, ccolamd, csymamd
from .nesdis import nested_dissection, bisect
