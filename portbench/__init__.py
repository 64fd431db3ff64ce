"""portbench: the benchmark of ``lodestar_tpu_torch``, the PyTorch and CUDA
port, on one NVIDIA card.

Mainnet gossip and blocks go open loop through the port's BLS batch pool
(``chain/bls_pool.BlsBatchPool`` over ``crypto/bls/torch_verifier
.TorchBlsVerifier``); each job is timed from the instant it was due to its
verdict, and every verdict of the window is held against a plain reference
that imports nothing of the port.  ``run.py`` is the command; the cells,
configurations and metrics are named in ``BENCHMARK.json`` at the root of
the repository and found here by name:

- ``configs/<config>.json``: one node deployment (preset numbers, the key
  bank, the guarantees);
- ``traffic/<traffic>.json``: one open-loop traffic mix (the offered
  sets/s and its source);
- ``metrics/<metric>.py``: one reader per per-layer metric.
"""
