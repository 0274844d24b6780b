"""psac_tpu_torch — PyTorch + CUDA port of psac_tpu for NVIDIA Hopper GPUs.

Suffix array + LCP construction, the suffix tree, the public ANSV and the
DESA pattern index of one text, and the generalized suffix array and suffix
tree of a string set, on one device; the artifact IO (``io``), the file
inputs and the command-line tools (``python -m psac_tpu_torch.cli``).
Every entry point also runs on a mesh of p shards
(``parallel.mesh.make_mesh``; ``mesh=`` of the entry points, ``--devices``
of the CLI).  The package imports
``torch`` only; its hand-written CUDA kernels (``csrc/``) are built with
``nvcc`` at first use.  Every entry point takes ``device``, the CUDA card
when it is None: CPU tensors (``device="cpu"``) run each kernel's plain
PyTorch version, CUDA tensors run the kernel.
"""

from psac_tpu_torch.config import SAConfig  # noqa: F401
from psac_tpu_torch.models.desa import DESA, build_desa  # noqa: F401
from psac_tpu_torch.models.gsa import (  # noqa: F401
    DeviceGSA,
    GeneralizedSuffixArray,
    build_gsa,
)
from psac_tpu_torch.models.suffix_array import (  # noqa: F401
    DeviceSuffixArray,
    SuffixArray,
    build_suffix_array,
)
from psac_tpu_torch.models.suffix_tree import (  # noqa: F401
    build_gst,
    build_suffix_tree,
)
from psac_tpu_torch.parallel.ansv import ansv  # noqa: F401
