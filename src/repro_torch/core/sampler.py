"""The edge-sampler engine: one descend core, three backends.

Every generation path of the port (``rmat.sample_graph*``,
``SyntheticGraphPipeline.generate``) routes through this registry::

    backend = resolve_backend(None, n_edges, device="cuda")
    src, dst = backend.sample(key, thetas, n, m, n_edges,
                              id_dtype=torch.int64, device="cuda")

=============  ===========================================  =============
backend        what it is                                   reproduces
=============  ===========================================  =============
``reference``  plain torch: one threefry uniform per edge   ``xla``
               per level.  Runs everywhere.
``cuda_bits``  threefry words drawn into device memory,     ``pallas_bits``
               then the bits kernel (plain version on CPU).
``cuda_prng``  the kernel that makes the same threefry      ``pallas_bits``
               words in registers: the ids of
               ``cuda_bits``, with only the ids in memory.
=============  ===========================================  =============

"reproduces" names the JAX package's backend whose stream a port backend
gives bit for bit for the same key (``EdgeSamplerBackend.stream``).
``cuda_prng`` cannot reproduce the TPU-only ``pallas_prng``, whose bits
come from the TPU's hardware generator; it gives ``pallas_bits``'s ids.

Selection (``resolve_backend(None)``): on CUDA ``cuda_prng``, except for
batches below one ``MIN_BLOCK``, which stay on ``reference``; on the CPU
``reference``.  Id dtypes: int32 ids hold 31 bits; int64 ids are built
from the ``(hi, lo)`` word pair, up to 62 bits.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import random as trandom
from repro_torch.core.descend import (IdParts, as_torch_dtype,
                                      check_id_capacity, combine_ids,
                                      descend, narrow_ids)
from repro_torch.kernels import rmat_sample as rs

#: block size of the JAX package's Pallas kernels: it fixes the padded
#: edge count of the bits streams, so it stays part of the contract
DEFAULT_BLOCK = 8192

#: smallest block the engine pads to
MIN_BLOCK = 256


def choose_block(n_edges: int, block: int = DEFAULT_BLOCK) -> int:
    """Largest power-of-two block ≤ ``block`` that doesn't over-pad tiny
    batches (pad waste stays < 2× down to MIN_BLOCK)."""
    while block > MIN_BLOCK and block >= 2 * n_edges:
        block //= 2
    return block


def _pad_edges(n_edges: int, block: int) -> int:
    return -(-n_edges // block) * block


def _check_capacity(n: int, m: int, id_dtype, who: str) -> torch.dtype:
    dt = as_torch_dtype(id_dtype)
    check_id_capacity(n, dt, f"{who} (src levels)")
    check_id_capacity(m, dt, f"{who} (dst levels)")
    return dt


def _finalize(src: IdParts, dst: IdParts, n: int, m: int, dt: torch.dtype,
              n_edges: int):
    """Trim padding and materialize the contract dtype (on the device)."""
    if dt.itemsize <= 4:
        return narrow_ids(src, n_edges, dt), narrow_ids(dst, n_edges, dt)
    return (combine_ids(src, n, dt)[:n_edges],
            combine_ids(dst, m, dt)[:n_edges])


def _thetas_on(thetas, device) -> torch.Tensor:
    return torch.as_tensor(thetas, dtype=torch.float32,
                           device=device).contiguous()


class EdgeSamplerBackend:
    """One way of turning ``(key, thetas, n, m, n_edges)`` into edges."""

    name: str = "?"
    #: the JAX package's backend whose id stream this one reproduces
    stream: str = "?"

    def sample_parts(self, key, thetas, n: int, m: int, n_edges: int,
                     device) -> Tuple[IdParts, IdParts]:
        """``(src, dst)`` id words on ``device``, possibly padded past
        ``n_edges``."""
        raise NotImplementedError

    def sample(self, key, thetas, n: int, m: int, n_edges: int,
               id_dtype=torch.int32, device="cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """thetas: (max(n,m), 4) per-level (a,b,c,d).  Returns ids of
        ``id_dtype`` on ``device``."""
        dt = _check_capacity(n, m, id_dtype, f"{self.name} sampler")
        src, dst = self.sample_parts(key, thetas, n, m, n_edges,
                                     torch.device(device))
        return _finalize(src, dst, n, m, dt, n_edges)


class ReferenceBackend(EdgeSamplerBackend):
    """``split(key, L)``, then one ``uniform`` per level: the JAX
    ``xla`` backend's ``_xla_parts``."""
    name = "reference"
    stream = "xla"

    def sample_parts(self, key, thetas, n, m, n_edges, device):
        keys = trandom.split(key, max(n, m))
        th = _thetas_on(thetas, device)
        return descend(
            lambda ell: trandom.uniform(keys[ell], (n_edges,),
                                        device=device),
            lambda ell: (th[ell, 0], th[ell, 1], th[ell, 2]),
            n, m,
            lambda: torch.zeros(n_edges, dtype=torch.int32, device=device))


class CudaBitsBackend(EdgeSamplerBackend):
    """``bits(key, (L, E_pad))`` in device memory → the bits kernel."""
    name = "cuda_bits"
    stream = "pallas_bits"

    @staticmethod
    def draw_bits(key, L: int, n_edges: int, device="cpu") -> torch.Tensor:
        """The exact word stream the bits kernel reads (the JAX
        ``PallasBitsBackend.draw_bits``)."""
        return trandom.bits(key, (L, n_edges), device)

    def sample_parts(self, key, thetas, n, m, n_edges, device):
        pad = _pad_edges(n_edges, choose_block(n_edges))
        bits = self.draw_bits(key, max(n, m), pad, device)
        return rs.rmat_sample_bits(_thetas_on(thetas, device), bits, n, m)


class CudaPrngBackend(EdgeSamplerBackend):
    """The words of ``cuda_bits`` made in registers (kernel K2)."""
    name = "cuda_prng"
    stream = "pallas_bits"

    def sample_parts(self, key, thetas, n, m, n_edges, device):
        pad = _pad_edges(n_edges, choose_block(n_edges))
        return rs.rmat_sample_prng(key, _thetas_on(thetas, device), n, m,
                                   n_edges, pad)


_REGISTRY: Dict[str, EdgeSamplerBackend] = {}


def register_backend(backend: EdgeSamplerBackend) -> EdgeSamplerBackend:
    _REGISTRY[backend.name] = backend
    return backend


register_backend(ReferenceBackend())
register_backend(CudaBitsBackend())
register_backend(CudaPrngBackend())


def registered_backends() -> List[str]:
    return list(_REGISTRY)


def get_backend(name: str) -> EdgeSamplerBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown edge-sampler backend {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def resolve_backend(name: Optional[str] = None,
                    n_edges: Optional[int] = None,
                    device="cuda") -> EdgeSamplerBackend:
    """Explicit names win (``'auto'`` and ``None`` both auto-select);
    CUDA gets the in-register threefry kernel, sub-block batches and the
    CPU the reference path."""
    if name is not None and name != "auto":
        return get_backend(name)
    if torch.device(device).type == "cuda":
        if n_edges is not None and n_edges < MIN_BLOCK:
            return _REGISTRY["reference"]
        return _REGISTRY["cuda_prng"]
    return _REGISTRY["reference"]
