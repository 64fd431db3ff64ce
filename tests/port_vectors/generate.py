"""Golden vectors of the JAX fused kernels for the PyTorch port's tests.

    JAX_PLATFORMS=cpu python tests/port_vectors/generate.py

Runs the JAX package's ``fused_core`` ops (``f_mul``, ``f2_mul``,
``f2_sqr``, ``f_pow16mul``, ``f2_pow16mul``, ``f_fold``, ``f_canon``) and
``fused_ladder.point_mul_bits_ladder`` (4 bits over 2 rows) on the CPU in
Pallas interpret mode, on inputs made with numpy from a fixed seed, and
writes inputs and outputs to ``fused_core.npz`` and ``fused_ladder.npz``
beside this file.  The tests rebuild the inputs with ``core_inputs`` /
``ladder_inputs`` below, check them against the stored ones, and hold the
port's plain versions to the stored outputs bitwise.

Importing this module needs neither JAX nor torch.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CORE_NPZ = os.path.join(HERE, "fused_core.npz")
LADDER_NPZ = os.path.join(HERE, "fused_ladder.npz")
SEED = 20261016
ROWS = 8
LOOSE_MAX = (1 << 22) - 1

# Ops and their input arity / trailing value shape
CORE_OPS = {
    "f_mul": (2, (50,)),
    "f2_mul": (2, (2, 50)),
    "f2_sqr": (1, (2, 50)),
    "f_pow16mul": (2, (50,)),
    "f2_pow16mul": (2, (2, 50)),
    "f_fold": (1, (50,)),
    "f_canon": (1, (50,)),
}


def _digits(v: int) -> np.ndarray:
    return np.frombuffer(v.to_bytes(50, "little"), dtype=np.uint8).astype(np.float32)


def core_inputs() -> dict:
    """Per op, its input arrays (ROWS rows): row 0 zero, row 1 p, row 2 2p,
    row 3 every digit at the loose bound 2^22 - 1, rows 4.. random loose
    digits in [0, 2^22)."""
    from lodestar_tpu_torch.crypto.bls.fields import P

    rng = np.random.default_rng(SEED)
    out = {}
    for op, (arity, tail) in CORE_OPS.items():
        for k in range(arity):
            a = rng.integers(0, LOOSE_MAX + 1, size=(ROWS,) + tail).astype(np.float32)
            flat = a.reshape(ROWS, -1, 50)
            flat[0] = 0
            flat[1] = _digits(P)
            flat[2] = _digits(2 * P)
            flat[3] = LOOSE_MAX
            out[f"{op}_in{k}"] = a
    return out


def ladder_inputs() -> dict:
    """Two G2 points (affine, from the oracle's hash of seeded bytes) and
    4-bit scalars per row, LSB first."""
    from lodestar_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2

    rng = np.random.default_rng(SEED + 1)
    xs, ys = [], []
    for _ in range(2):
        x, y = hash_to_g2(rng.bytes(32)).to_affine()
        xs.append(np.stack([_digits(x.c0), _digits(x.c1)]))
        ys.append(np.stack([_digits(y.c0), _digits(y.c1)]))
    scalars = rng.integers(1, 16, size=2)
    bits = np.array([[(int(s) >> i) & 1 for i in range(4)] for s in scalars], np.float32)
    return {"x": np.stack(xs), "y": np.stack(ys), "bits": bits}


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from lodestar_tpu.ops import fused_core as J
    from lodestar_tpu.ops.fused_ladder import point_mul_bits_ladder
    from lodestar_tpu.ops.fused_points import fq2_ns, point_from_affine

    ins = core_inputs()
    outs = {}
    for op, (arity, _tail) in CORE_OPS.items():
        args = [J.lv(jnp.asarray(ins[f"{op}_in{k}"]), J.MAX_BOUND) for k in range(arity)]
        res = getattr(J, op)(*args, interpret=True)
        if op == "f2_sqr":
            outs["f2_sqr_out0"], outs["f2_sqr_out1"] = (np.asarray(r.a) for r in res)
        elif op == "f_canon":
            outs["f_canon_out0"] = np.asarray(res)
        else:
            outs[f"{op}_out0"] = np.asarray(res.a)
    np.savez_compressed(CORE_NPZ, **ins, **outs)

    lad = ladder_inputs()
    ns = fq2_ns(True)
    p = point_from_affine(J.lv(jnp.asarray(lad["x"])), J.lv(jnp.asarray(lad["y"])), ns)
    out = point_mul_bits_ladder(p, jnp.asarray(lad["bits"]), ns, interpret=True)
    np.savez_compressed(
        LADDER_NPZ, **lad, out_x=np.asarray(out[0].a), out_y=np.asarray(out[1].a),
        out_z=np.asarray(out[2].a),
    )
    print(f"wrote {CORE_NPZ} and {LADDER_NPZ}")


if __name__ == "__main__":
    main()
