from .resnet import ResNet, ResNet50  # noqa: F401
from .transformer import (  # noqa: F401
    TransformerConfig, TransformerLM, lm_loss,
)
