from xfr_torch.detection.detector import FasterRCNN, im_detect  # noqa: F401
from xfr_torch.detection.network import FasterRCNNNetwork  # noqa: F401
