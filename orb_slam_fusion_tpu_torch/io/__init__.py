"""IO: trajectory files and evaluation, trajectory writers, atlas
checkpoints and the EuRoC reader (numpy, host side)."""

from .euroc import EurocFrame, EurocSequence, load_gray  # noqa: F401
from .evaluation import align_horn, ate_rmse  # noqa: F401
from .serialization import load_map, save_map  # noqa: F401
from .trajectory import load_tum, save_tum  # noqa: F401
from .writers import save_euroc, save_kitti  # noqa: F401
