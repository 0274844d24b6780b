"""Global tunables and dtype policy (PyTorch port of ``psac_tpu/config.py``).

Same fields and defaults as the JAX package's ``SAConfig`` so a
configuration converts one to one (``SAConfig.from_jax``), and every field
acts as it does there.
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
    ``SAConfig`` for the meaning of each field).  ``fused`` picks the
    driver: the fused path, or the host-driven loop, which enters its tail
    once fewer than N * ``tail_threshold_frac`` elements are unfinished
    (the fused path enters at N / ``fused_tail_div``).  ``factor`` steps
    SA-only builds (``construct_arr<L>``) and ``dense_factor`` the fused
    dense loop.  ``pack_keys`` packs pairs of int32 sort keys into int64
    lanes in sorts of 6 or more columns (factor 5 and up).
    ``tail_capacity_mult`` has no reader in either package; it is kept so
    configurations convert one to one.  ``resolve_div`` sizes the chunks of
    the fused path's LCP resolve in its plain version, which CPU builds
    run; on the card one kernel launch takes the whole resolve."""

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


DEFAULT = SAConfig()
