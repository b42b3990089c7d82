from deeplearning4j_tpu_torch.clustering.vptree import VPTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.kmeans import KMeans  # noqa: F401
from deeplearning4j_tpu_torch.clustering.tsne import TSNE, BarnesHutTsne  # noqa: F401
