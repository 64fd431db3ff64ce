"""lodestar_tpu_torch — the PyTorch/CUDA port of lodestar_tpu's batched BLS
signature-set verification, for NVIDIA Hopper (H100, sm_90a), and of the
beacon chain that feeds it.

Layout mirrors the JAX package: ``crypto/bls`` holds the bigint oracle and
the verifier boundary, ``ops`` the fused field/point/pairing modules over
the hand-written CUDA kernels in ``ops/kernels``; ``node/dev_chain`` and
``chain/beacon_chain`` drive the state transition, fork choice and
database (``state_transition``, ``fork_choice``, ``ssz``, ``db``) and send
each block's signature sets through ``chain/bls_pool``.  A tensor on the CPU
takes each kernel's plain PyTorch version; a CUDA tensor takes the kernel.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  A CUDA device comes back with its index (``"cuda"`` is
    the current card of the calling thread, so that ``"cuda"`` and
    ``"cuda:0"`` name one device).  Raises when a CUDA device is asked for
    and none exists."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "lodestar_tpu_torch: no CUDA device available; pass device='cpu' "
            "to run the plain PyTorch versions"
        )
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())
