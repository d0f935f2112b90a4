"""IO: trajectory files and evaluation (numpy, host side)."""

from .evaluation import align_horn, ate_rmse  # noqa: F401
from .trajectory import load_tum, save_tum  # noqa: F401
