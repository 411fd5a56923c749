"""Hand-written CUDA kernels for Hopper (sm_90a): one for each TPU kernel
ported, q8bmm and u8lut32norm for the two ops of the BERT path that the
JAX package runs without a Pallas form, q8requant for the epilogue of
the sharded products, and q8rope, q8swiglu, moe_route and moe_combine for
MiMo-V2-Flash's block (every op of a path runs on a kernel of this
package).  q8gemm_partial and q8conv_partial are instances of q8gemm.cu
and q8conv.cu with wrappers and launch counts of their own, as are
q8gemm_grouped (q8gemm.cu's grouped wgmma instance, an expert layer's
GEMMs), q8bmm_masked (q8bmm.cu's causal and banded instances with
grouped-query attention), q8attn_masked (q8bmm.cu's fused masked
attention: scores, softargmax and context in one launch, MiMo-V2-Flash's
path) and u8softmax_masked (in u8lut32norm.cu).

Each module holds a kernel's wrapper (`*_cuda`, which launches the kernel
for CUDA tensors and counts launches in its `launches` attribute) and its
plain PyTorch version (`*_plain`, which the wrapper runs for CPU tensors).
The CUDA sources are in csrc/; _build.py compiles them at first launch.
"""

from .moe import moe_combine_cuda, moe_route_cuda
from .pool import (q8avgpool_cuda, q8avgpool_plain, q8gavgpool_cuda,
                   q8gavgpool_plain, u8maxpool_cuda, u8maxpool_plain)
from .q8bmm import (q8attn_masked_cuda, q8bmm_cuda, q8bmm_masked_cuda,
                    q8bmm_plain)
from .q8conv import (q8conv_cuda, q8conv_partial_cuda, q8conv_partial_plain,
                     q8conv_plain)
from .q8dwconv import q8dwconv_cuda, q8dwconv_plain
from .q8gemm import (partial_acc_plain, q8gemm_cuda, q8gemm_grouped_cuda,
                     q8gemm_partial_cuda, q8gemm_plain)
from .q8requant import q8requant_cuda, q8requant_plain
from .q8stem import q8stem_cuda, q8stem_plain
from .vpu_ops import (q8rope_cuda, q8swiglu_cuda, q8vadd_cuda, q8vadd_plain,
                      u8clamp_cuda, u8clamp_plain, u8lut32norm_cuda,
                      u8lut32norm_plain, u8rmax_cuda, u8rmax_plain,
                      u8softmax_masked_cuda)

KERNELS = {
    "q8gemm": q8gemm_cuda,
    "q8dwconv": q8dwconv_cuda,
    "q8vadd": q8vadd_cuda,
    "q8gavgpool": q8gavgpool_cuda,
    "q8conv": q8conv_cuda,
    "q8stem": q8stem_cuda,
    "u8maxpool": u8maxpool_cuda,
    "q8avgpool": q8avgpool_cuda,
    "q8bmm": q8bmm_cuda,
    "u8rmax": u8rmax_cuda,
    "u8lut32norm": u8lut32norm_cuda,
    "u8clamp": u8clamp_cuda,
    "q8gemm_partial": q8gemm_partial_cuda,
    "q8conv_partial": q8conv_partial_cuda,
    "q8requant": q8requant_cuda,
    "q8gemm_grouped": q8gemm_grouped_cuda,
    "q8bmm_masked": q8bmm_masked_cuda,
    "u8softmax_masked": u8softmax_masked_cuda,
    "q8attn_masked": q8attn_masked_cuda,
    "q8rope": q8rope_cuda,
    "q8swiglu": q8swiglu_cuda,
    "moe_route": moe_route_cuda,
    "moe_combine": moe_combine_cuda,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """Launches of each kernel so far.  The counts run in Python, in the
    wrapper: a launch recorded by a CUDA-graph capture counts once, at the
    capture, and a replay of the graph counts nothing (ops.base.capture
    keeps a graph's own counts in Capture.launches)."""
    return {name: fn.launches for name, fn in KERNELS.items()}
