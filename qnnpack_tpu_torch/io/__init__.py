"""Host IO: native preprocessing bindings, prefetching input pipeline,
real-checkpoint import (TFLite flatbuffers), and accuracy-parity metrics -
a port of qnnpack_tpu/io/."""

from .accuracy import (  # noqa: F401
    element_agreement, top1_accuracy, top1_agreement,
)
from .native import (  # noqa: F401
    c_requantize, dequantize, native_available, quantize,
    resize_quantize_batch,
)
from .pipeline import BatchPrefetcher, image_pipeline  # noqa: F401
from .tflite_import import import_tflite, parse_tflite  # noqa: F401
