"""Architecture configs ported so far: the paper's own CNN testbed
(VGG16/19, ResNet50/101). Importing this package registers them in
``repro_torch.config.registry``; select with ``--arch <id>``."""
from repro_torch.configs import cnn_testbed  # noqa: F401
