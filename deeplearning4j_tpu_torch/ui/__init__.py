"""The training dashboard (DL4J's StatsListener -> StatsStorage ->
UIServer): the port of ``deeplearning4j_tpu/ui/``."""

from deeplearning4j_tpu_torch.ui.stats import StatsListener  # noqa: F401
from deeplearning4j_tpu_torch.ui.storage import (FileStatsStorage,  # noqa: F401
                                                 InMemoryStatsStorage,
                                                 RemoteStatsStorageRouter)
from deeplearning4j_tpu_torch.ui.server import UIServer  # noqa: F401
from deeplearning4j_tpu_torch.ui.visualization import (  # noqa: F401
    ConvolutionalIterationListener, activations_to_grid,
)
from deeplearning4j_tpu_torch.ui.components import (  # noqa: F401
    ChartHistogram, ChartHorizontalBar, ChartLine, ChartScatter,
    ChartStackedArea, ChartTimeline, Component, ComponentTable,
    ComponentText, DecoratorAccordion, Style,
)
