from .addition import AdditionMerge
from .base import MergeTensorsBase  # noqa: F401
from .breadcrumbs import BreadcrumbsMerge
from .dare import DareMerge
from .della import DellaMerge
from .fourier import FourierMerge
from .fourier_legacy import LegacyFourierMerge
from .linear import LinearMerge
from .modelstock import ModelStockMerge
from .slerp import SlerpMerge
from .taskaddition import TaskAdditionMerge
from .ties import TiesMerge

MERGE_METHODS = {
    "fourier": FourierMerge,
    "fourier-legacy": LegacyFourierMerge,
    "addition": AdditionMerge,
    "task-addition": TaskAdditionMerge,
    "ties": TiesMerge,
    "dare": DareMerge,
    "della": DellaMerge,
    "breadcrumbs": BreadcrumbsMerge,
    "linear": LinearMerge,
    "slerp": SlerpMerge,
    "model-stock": ModelStockMerge,
}
