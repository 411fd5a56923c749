"""Quantized models: MobileNetV2, the graph runtime with its zoo and ENet,
and the int8 BERT encoder."""

from .bert import (  # noqa: F401
    BertConfig, bert_encoder_forward, build_bert_encoder,
)
from .enet import enet_seg  # noqa: F401
from .graph import (  # noqa: F401
    ConvSpec, GraphBuilder, GraphModel, GraphSpec, graph_forward,
    params_from_jax,
)
from .mobilenet_v2 import (  # noqa: F401
    INVERTED_RESIDUAL_CFG, MobileNetV2, build_mobilenet_v2,
    mobilenet_v2_forward,
)
from .zoo import (  # noqa: F401
    SHUFFLENET_V2_CHANNELS, mobilenet_v1, resnet18, resnet50, shufflenet_v1,
    shufflenet_v2, squeezenet_v10, squeezenet_v11, vgg16,
)
