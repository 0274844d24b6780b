"""Global tunables and dtype policy (PyTorch port of ``psac_tpu/config.py``).

Same fields and defaults as the JAX package's ``SAConfig`` so a
configuration converts one to one (``SAConfig.from_jax``).  Two JAX-side
options are not ported: ``pack_keys`` (a TPU sort-lane experiment, off by
default there) and ``fused=False`` (the multi-shard host-driven loop).
"""

from __future__ import annotations

import dataclasses

import torch

INT32_MAX = 2**31 - 1


def resolve_device(device=None) -> torch.device:
    """The device a build runs on: the CUDA card when ``device`` is None,
    else ``device`` as given (``"cpu"`` runs the kernels' plain versions).
    There is no fallback: without a card, ``None`` fails where torch first
    allocates on it."""
    return torch.device("cuda" if device is None else device)


def index_dtype(n: int) -> torch.dtype:
    """int32 while the padded length stays below 2^30 (bucket ids reach
    N+1 and doubling distances 2N, both of which must fit int32), int64
    beyond — the reference's ``index_t`` template parameter."""
    return torch.int32 if n < (1 << 30) else torch.int64


@dataclasses.dataclass(frozen=True)
class SAConfig:
    """Configuration of suffix-array construction (see the JAX package's
    ``SAConfig`` for the meaning of each field).  ``tail_threshold_frac``
    and ``tail_capacity_mult`` steer only the JAX package's host-driven
    loop and have no effect here; they are kept so configurations convert
    one to one.  ``resolve_div`` sizes the chunks of the LCP resolve's plain
    version, which CPU builds run; on the card one kernel launch takes the
    whole resolve."""

    construct_lcp: bool = True
    construct_lc: bool = False
    k: int = 0
    tail_threshold_frac: float = 0.1
    tail_capacity_mult: float = 1.25
    factor: int = 2
    fused: bool = True
    force_int64: bool = False
    dense_factor: int = 4
    resolve_div: int = 32
    pack_keys: bool = False
    kmer_words: int = 2
    fused_tail_div: int = 32

    @classmethod
    def from_jax(cls, cfg) -> "SAConfig":
        """Field-by-field copy of a ``psac_tpu.config.SAConfig``."""
        return cls(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cls)})

    def check_supported(self) -> None:
        """Raise for the options this port does not implement."""
        if self.pack_keys:
            raise NotImplementedError("pack_keys is a TPU sort-lane experiment")
        if not self.fused:
            raise NotImplementedError(
                "fused=False (the multi-shard host-driven loop) is not ported")


DEFAULT = SAConfig()
