"""Device side of the port: 8-bit float32 digit field elements (the JAX
package's representation) over hand-written CUDA kernels.

Modules keep the JAX package's names: ``fused_core`` (bound-tracked loose
values and the seven field kernels), ``fused_field``, ``fused_points``,
``fused_ladder`` (the three ladder-round kernels), ``fused_htc``,
``fused_pairing`` and ``fused_verify`` (the batched verification entry).
``limbs``, ``tower``, ``pairing`` and ``htc`` hold the numpy constants and
the host hash stage.
"""
