"""psac_tpu_torch — PyTorch + CUDA port of psac_tpu for NVIDIA Hopper GPUs.

Suffix array + LCP construction and the suffix tree of one text on one
device.  The package imports ``torch`` only; its hand-written CUDA kernels
(``csrc/``) are built with ``nvcc`` at first use.  Every entry point takes
an explicit ``device``: CPU tensors run each kernel's plain PyTorch
version, CUDA tensors run the kernel.
"""

from psac_tpu_torch.config import SAConfig  # noqa: F401
from psac_tpu_torch.models.suffix_array import (  # noqa: F401
    DeviceSuffixArray,
    SuffixArray,
    build_suffix_array,
)
from psac_tpu_torch.models.suffix_tree import build_suffix_tree  # noqa: F401
