"""lodestar_tpu_torch — the PyTorch/CUDA port of lodestar_tpu's batched BLS
signature-set verification, for NVIDIA Hopper (H100, sm_90a).

Layout mirrors the JAX package: ``crypto/bls`` holds the bigint oracle and
the verifier boundary, ``ops`` the fused field/point/pairing modules over
the hand-written CUDA kernels in ``ops/kernels``.  A tensor on the CPU
takes each kernel's plain PyTorch version; a CUDA tensor takes the kernel.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when a CUDA device is asked for and none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lodestar_tpu_torch: no CUDA device available; pass device='cpu' "
            "to run the plain PyTorch versions"
        )
    return dev
