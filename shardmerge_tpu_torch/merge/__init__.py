from .base import MergeTensorsBase  # noqa: F401
from .fourier import FourierMerge  # noqa: F401

MERGE_METHODS = {
    "fourier": FourierMerge,
}
