from . import norms, smooth, stencil, stencil3d, transfer, transfer3d  # noqa: F401
from .stencil import Stencil, make_stencil  # noqa: F401
