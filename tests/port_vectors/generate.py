"""Golden vectors of the JAX package for the PyTorch port's tests.

    JAX_PLATFORMS=cpu python tests/port_vectors/generate.py [fused] [tower] [xla] [sharded] [fuse]

With no argument it writes every file; each takes the JAX package on the
CPU and inputs made with numpy from a fixed seed, and writes inputs and
outputs beside this file:

- ``fused_core.npz`` / ``fused_ladder.npz`` (``fused``): the ``fused_core``
  ops (``f_mul``, ``f2_mul``, ``f2_sqr``, ``f_pow16mul``, ``f2_pow16mul``,
  ``f_fold``, ``f_canon``) and ``fused_ladder.point_mul_bits_ladder`` (4
  bits over 2 rows) in Pallas interpret mode;
- ``tower_kernels.npz`` (``tower``): the four ``pallas_tower`` kernels
  (``fq2_mul``, ``fq2_sqr``, ``fq6_mul``, ``fq12_mul``) in interpret mode;
- ``xla_path.npz`` (``xla``, a few minutes of XLA compiles): the ``limbs``
  ops in their default ``ladder`` mode, ``htc.hash_to_g2_device`` at 2
  messages, ``points.g2_subgroup_check`` on a member and a non-member, and
  ``batch_verify``'s Miller product and verdicts at bucket 4;
- ``sharded.npz`` (``sharded``, on a CPU mesh of 4 virtual devices; the
  entry verdicts are about half an hour of XLA compiles): ``lax.all_gather``
  inside ``shard_map`` of seeded GT partials and verdict bits at 2 and 4
  shards, ``fused_pairing.f12_product_tree`` over the gathered partials
  (interpret mode), the ``sharded_verify`` combines at 4 shards, and the
  verdicts of ``verify_signature_sets_sharded(fused=False)`` at bucket 8:
  valid and corrupted over 2 shards, 5 live sets over 4 shards;
- ``library_fuse.npz`` (``fuse``): ``pallas_fuse(tower.fq2_mul)``, the
  kernel-library registry's instance, in interpret mode, at the
  registry's 4 rows and at FUSE_ROWS rows.

The split dispatch's tests reuse the bucket-4 and bucket-8 inputs above.

The tests rebuild the inputs with the ``*_inputs`` functions below, check
them against the stored ones, and hold the port to the stored outputs.

Importing this module needs neither JAX nor torch.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CORE_NPZ = os.path.join(HERE, "fused_core.npz")
LADDER_NPZ = os.path.join(HERE, "fused_ladder.npz")
TOWER_NPZ = os.path.join(HERE, "tower_kernels.npz")
XLA_NPZ = os.path.join(HERE, "xla_path.npz")
SHARDED_NPZ = os.path.join(HERE, "sharded.npz")
FUSE_NPZ = os.path.join(HERE, "library_fuse.npz")
FUSE_ROWS = 300
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


# pallas_tower kernels: input arity and trailing value shape
TOWER_OPS = {
    "fq2_mul": (2, (2, 50)),
    "fq2_sqr": (1, (2, 50)),
    "fq6_mul": (2, (3, 2, 50)),
    "fq12_mul": (2, (6, 2, 50)),
}


def _edge_rows(a: np.ndarray, top: int) -> np.ndarray:
    """Rows 0-3 of a: zero, p, 2p, every digit at top."""
    from lodestar_tpu_torch.crypto.bls.fields import P

    flat = a.reshape(a.shape[0], -1, 50)
    for r, edge in enumerate((0, _digits(P), _digits(2 * P), top)):
        flat[r] = edge
    return a


def tower_inputs() -> dict:
    """Per kernel, its semi-strict inputs (ROWS rows, digits <= 256): edge
    rows 0-3, then random digits in [0, 256]."""
    rng = np.random.default_rng(SEED + 2)
    out = {}
    for op, (arity, tail) in TOWER_OPS.items():
        for k in range(arity):
            a = rng.integers(0, 257, size=(ROWS,) + tail).astype(np.float32)
            out[f"{op}_in{k}"] = _edge_rows(a, 256)
    return out


def fuse_inputs() -> dict:
    """Semi-strict (digits <= 256) Fq2 operands of the library kernel:
    ``b4_in0/1`` at the registry's 4 rows, random; ``rows_in0/1`` at
    FUSE_ROWS rows, edge rows 0-3 (zero, p, 2p, every digit 256) in both,
    rows 4-7 of the second operand every digit 256, the rest random."""
    rng = np.random.default_rng(SEED + 5)
    out = {}
    for name, rows in (("b4", 4), ("rows", FUSE_ROWS)):
        for k in range(2):
            a = rng.integers(0, 257, size=(rows, 2, 50)).astype(np.float32)
            if rows > 4:
                _edge_rows(a, 256)
                if k == 1:
                    a[4:8] = 256
            out[f"{name}_in{k}"] = a
    return out


XLA_MSGS = [b"port xla path message 0", b"port xla path message 1"]


def xla_inputs() -> dict:
    """Inputs of the XLA-path vectors: digit arrays for the limbs ops
    (loose < 2^24, minuends < 2^23, subtrahends < 2^12, semi-strict <= 256
    with edge rows), the hash_to_field draws of XLA_MSGS, a G2 member and
    a non-member (affine), and the bucket-4 example batch with a corrupted
    twin (set 1 carries set 2's signature)."""
    from lodestar_tpu_torch.crypto.bls.hash_to_curve import hash_to_field_fq2, map_to_curve_g2
    from lodestar_tpu_torch.ops import batch_verify, htc, tower

    rng = np.random.default_rng(SEED + 3)
    draw = lambda top: rng.integers(0, top, size=(ROWS, 50)).astype(np.float32)  # noqa: E731
    out = {
        "loose": _edge_rows(draw(1 << 24), (1 << 24) - 1),
        "sub_a": _edge_rows(draw(1 << 23), (1 << 23) - 1),
        "sub_b": _edge_rows(draw(1 << 12), (1 << 12) - 1),
        "semi_a": _edge_rows(draw(257), 256),
        "semi_b": _edge_rows(draw(257), 256),
        "msg_u": htc.hash_to_field_limbs(XLA_MSGS),
    }
    pk_x, pk_y, sig_x, sig_y, msg_u, bits, mask = batch_verify.example_inputs(4)
    outside = map_to_curve_g2(hash_to_field_fq2(b"port xla path outside G2", 2)[0]).to_affine()
    out["g2_x"] = np.stack([sig_x[0], tower.fq2_const(outside[0])])
    out["g2_y"] = np.stack([sig_y[0], tower.fq2_const(outside[1])])
    for name, arr in zip(("pk_x", "pk_y", "sig_x", "sig_y", "msg_u4", "bits", "mask"),
                         (pk_x, pk_y, sig_x, sig_y, msg_u, bits, mask)):
        out[f"b4_{name}"] = arr
    bad_x, bad_y = sig_x.copy(), sig_y.copy()
    bad_x[1], bad_y[1] = sig_x[2], sig_y[2]
    out["b4_bad_sig_x"], out["b4_bad_sig_y"] = bad_x, bad_y
    return out


def bucket4(ins: dict, corrupted: bool = False) -> tuple:
    """The packed bucket-4 7-tuple of xla_inputs (valid or corrupted)."""
    sig = ("b4_bad_sig_x", "b4_bad_sig_y") if corrupted else ("b4_sig_x", "b4_sig_y")
    return (ins["b4_pk_x"], ins["b4_pk_y"], ins[sig[0]], ins[sig[1]], ins["b4_msg_u4"],
            ins["b4_bits"], ins["b4_mask"])


SHARD_COUNTS = (2, 4)


def sharded_inputs() -> dict:
    """Per shard count n: seeded semi-strict GT partials (n, 6, 2, 50),
    shard 0's first four Fq2 components the edges (zero, p, 2p, every
    digit 256), and 0/1 verdict bits (n, 2); then the bucket-8 example batch
    with lane 7 padding, its corrupted twin (one digit of signature 0
    bumped) and the mask of 5 live sets."""
    from lodestar_tpu_torch.ops import batch_verify

    rng = np.random.default_rng(SEED + 4)
    out = {}
    for n in SHARD_COUNTS:
        parts = rng.integers(0, 257, size=(n, 6, 2, 50)).astype(np.float32)
        _edge_rows(parts[0], 256)  # Fq2 components 0-3 of shard 0: zero, p, 2p, all 256
        out[f"parts{n}"] = parts
        out[f"bits{n}"] = rng.integers(0, 2, size=(n, 2)).astype(np.float32)
    pk_x, pk_y, sig_x, sig_y, msg_u, bits, mask = batch_verify.example_inputs(8)
    mask = mask.copy()
    mask[7] = False
    for name, arr in zip(("pk_x", "pk_y", "sig_x", "sig_y", "msg_u", "bits", "mask"),
                         (pk_x, pk_y, sig_x, sig_y, msg_u, bits, mask)):
        out[f"b8_{name}"] = arr
    bad = sig_x.copy()
    bad[0, 0, 0] += 1
    out["b8_bad_sig_x"] = bad
    live5 = np.zeros(8, dtype=bool)
    live5[:5] = True
    out["b8_live5_mask"] = live5
    return out


def bucket8(ins: dict, case: str = "valid") -> tuple:
    """The packed bucket-8 7-tuple of sharded_inputs: ``valid``,
    ``corrupted`` or ``live5``."""
    sig_x = ins["b8_bad_sig_x"] if case == "corrupted" else ins["b8_sig_x"]
    mask = ins["b8_live5_mask"] if case == "live5" else ins["b8_mask"]
    return (ins["b8_pk_x"], ins["b8_pk_y"], sig_x, ins["b8_sig_y"], ins["b8_msg_u"],
            ins["b8_bits"], mask)


def _write_sharded() -> None:
    import jax
    import jax.numpy as jnp
    from jax.experimental import shard_map as sm
    from jax.sharding import PartitionSpec as P

    from lodestar_tpu.ops import fused_pairing
    from lodestar_tpu.ops import sharded_verify as sv
    from lodestar_tpu.ops.fused_core import LV

    def mapped(mesh, body, n_in):
        return jax.jit(sm.shard_map(body, mesh=mesh, in_specs=(P(sv.MESH_AXIS),) * n_in,
                                    out_specs=P(sv.MESH_AXIS), check_rep=False))

    ins = sharded_inputs()
    outs = {}
    for n in SHARD_COUNTS:
        mesh = sv.make_mesh(n_devices=n)
        gather = mapped(mesh, lambda x: jax.lax.all_gather(x[0], sv.MESH_AXIS)[None], 1)
        # every shard's replica, stacked: (n, n, ...)
        outs[f"gather_parts{n}"] = gather(jnp.asarray(ins[f"parts{n}"]))
        outs[f"gather_bits{n}"] = gather(jnp.asarray(ins[f"bits{n}"]))
        tree = fused_pairing.f12_product_tree(LV(jnp.asarray(ins[f"parts{n}"]), 256), True)
        outs[f"f12_tree{n}"] = tree.a
    mesh = sv.make_mesh(n_devices=4)
    combines = {
        "fq12_all_gather": lambda x: sv.fq12_combine_all_gather(x[0])[None],
        "fq12_ring": lambda x: sv.fq12_combine_ring(x[0], 4)[None],
        "f12_ring": lambda x: sv.f12_combine_ring_lv(LV(x[0], 256), 4, True).a[None],
    }
    for name, body in combines.items():
        outs[f"combine_{name}4"] = mapped(mesh, body, 1)(jnp.asarray(ins["parts4"]))
    print("sharded: gathers, trees and combines done; compiling the entries", flush=True)
    for n, case in ((2, "valid"), (2, "corrupted"), (4, "live5")):
        full = jax.jit(sv.verify_signature_sets_sharded(sv.make_mesh(n_devices=n), fused=False))
        outs[f"verdict_{case}{n}"] = full(*map(jnp.asarray, bucket8(ins, case)))
        print(f"sharded entry {case} over {n} shards -> {bool(outs[f'verdict_{case}{n}'])}",
              flush=True)
    np.savez_compressed(SHARDED_NPZ, **ins, **{k: np.asarray(v) for k, v in outs.items()})


def _write_tower() -> None:
    import jax.numpy as jnp

    from lodestar_tpu.ops import pallas_tower

    ins = tower_inputs()
    outs = {}
    for op, (arity, _tail) in TOWER_OPS.items():
        args = [jnp.asarray(ins[f"{op}_in{k}"]) for k in range(arity)]
        outs[f"{op}_out"] = np.asarray(getattr(pallas_tower, op)(*args, interpret=True))
    np.savez_compressed(TOWER_NPZ, **ins, **outs)


def _write_xla() -> None:
    import jax
    import jax.numpy as jnp

    from lodestar_tpu.ops import batch_verify, htc, limbs, points

    ins = xla_inputs()
    j = {k: jnp.asarray(v) for k, v in ins.items()}
    outs = {
        "carry_exact": limbs.carry_exact(j["loose"]),
        "carry_ripple_exact": limbs.carry_ripple_exact(j["semi_a"]),  # its semi-strict contract
        "fp_strict": limbs.fp_strict(j["loose"]),
        "fp_sub": limbs.fp_sub(j["sub_a"], j["sub_b"]),
        "fp_neg": limbs.fp_neg(j["sub_b"]),
        "fp_mul_small": limbs.fp_mul_small(j["semi_a"], 12345),
        "fp_mul": limbs.fp_mul(j["semi_a"], j["semi_b"]),
        "fp_mul_loose": limbs.fp_mul(j["loose"], j["semi_b"], a_strict=False),
        "fp_reduce_full": limbs.fp_reduce_full(j["semi_a"]),
        "fp_eq": limbs.fp_eq(j["semi_a"], j["semi_b"]),
        "fp_is_zero": limbs.fp_is_zero(j["semi_a"]),
        "fp_inv": limbs.fp_inv(j["semi_a"]),
    }
    h = jax.jit(htc.hash_to_g2_device)(j["msg_u"])
    outs.update(htc_x=h[0], htc_y=h[1], htc_z=h[2])
    g2 = points.point_from_affine(j["g2_x"], j["g2_y"], points.FQ2_NS)
    outs["g2_subgroup"] = jax.jit(points.g2_subgroup_check)(g2)
    f, ok = jax.jit(batch_verify.miller_product_kernel)(*map(jnp.asarray, bucket4(ins)))
    outs.update(b4_f=f, b4_ok=ok)
    verdict = jax.jit(batch_verify.verify_signature_sets_kernel)
    outs["b4_verdict"] = verdict(*map(jnp.asarray, bucket4(ins)))
    outs["b4_bad_verdict"] = verdict(*map(jnp.asarray, bucket4(ins, corrupted=True)))
    np.savez_compressed(XLA_NPZ, **ins, **{k: np.asarray(v) for k, v in outs.items()})


def _write_fused() -> None:
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


def _write_fuse() -> None:
    import jax.numpy as jnp

    from lodestar_tpu.ops import tower
    from lodestar_tpu.ops.pallas_fuse import pallas_fuse

    ins = fuse_inputs()
    outs = {}
    for name in ("b4", "rows"):
        a, b = (jnp.asarray(ins[f"{name}_in{k}"]) for k in range(2))
        outs[f"{name}_out"] = np.asarray(pallas_fuse(tower.fq2_mul, a, b, interpret=True)(a, b))
    np.savez_compressed(FUSE_NPZ, **ins, **outs)


WRITERS = {"fused": _write_fused, "tower": _write_tower, "xla": _write_xla,
           "sharded": _write_sharded, "fuse": _write_fuse}


def main(names) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    # the sharded vectors' mesh: 4 virtual CPU devices, set before JAX loads
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} --xla_force_host_platform_device_count=4".strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in names or WRITERS:
        WRITERS[name]()
        print(f"wrote the {name} vectors", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
