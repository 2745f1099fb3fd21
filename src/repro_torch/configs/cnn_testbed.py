"""The paper's own testbed: VGG16/19 and ResNet50/101 (Sec. IV-A).

These drive the faithful reproduction benches (Tables II/III, Figs. 2-8).
ImageNet geometry: 3x224x224 inputs, 1000 classes.
"""
from repro_torch.config.registry import register
from repro_torch.config.types import ModelConfig


def _cnn(spec_name: str) -> ModelConfig:
    return register(
        ModelConfig(
            arch_id=spec_name,
            family="cnn",
            source="arXiv:1409.1556" if "vgg" in spec_name
            else "arXiv:1512.03385",
            cnn_spec=spec_name,
            image_size=224,
            num_classes=1000,
            dtype="float32",
            param_dtype="float32",
        )
    )


VGG16 = _cnn("vgg16")
VGG19 = _cnn("vgg19")
RESNET50 = _cnn("resnet50")
RESNET101 = _cnn("resnet101")
