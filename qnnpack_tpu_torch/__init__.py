"""qnnpack_tpu_torch: the PyTorch/CUDA port of qnnpack_tpu.

Quantized uint8 inference with QNNPACK's operator contract, for NVIDIA
Hopper.  Plain tensor code is PyTorch; every kernel op of the MobileNetV2,
graph-runtime (models/graph.py with the zoo of models/zoo.py) and BERT
(models/bert.py) forwards and of the lifecycle operators (ops/) runs on a
CUDA kernel written for sm_90a (qnnpack_tpu_torch/kernels/).
Each kernel's wrapper runs its plain PyTorch version for tensors on the
CPU and launches the kernel for tensors on the GPU.  The JAX package
qnnpack_tpu is the reference; this package imports nothing of it.
"""
