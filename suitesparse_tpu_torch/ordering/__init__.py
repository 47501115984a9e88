from .amd import amd, camd, amd_valid, amd_info
from .nesdis import nested_dissection, bisect
