"""File formats (.m models, .t tokenizers) and the Q40/Q80 block codecs."""

from .mfile import ArchType, HiddenAct, ModelFile, ModelHeader, RopeType, write_header  # noqa: F401
from .quants import F16, F32, Q40, Q80  # noqa: F401
from .tfile import TokenizerData, read_tfile, write_tfile  # noqa: F401
