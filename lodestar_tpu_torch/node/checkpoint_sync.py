"""Checkpoint-sync boot: fetch a finalized (state, block) pair from a
trusted beacon node's REST API and anchor a fresh chain on it.

Reference: packages/cli/src/cmds/beacon/initBeaconState.ts:104-136 +
packages/cli/src/networks/index.ts:171 (fetchWeakSubjectivityState): the
node downloads the remote's finalized state, checks it is within the
weak-subjectivity period, and uses it as the anchor instead of genesis;
BackfillSync (sync/backfill.py) then earns the history backwards.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..api.client import ApiClient
from ..config.chain_config import ChainConfig
from ..params import Preset
from ..state_transition import compute_epoch_at_slot
from ..state_transition.weak_subjectivity import is_within_weak_subjectivity_period
from ..utils.logger import get_logger

logger = get_logger("checkpoint-sync")


class CheckpointSyncError(Exception):
    pass


async def fetch_checkpoint_state(
    preset: Preset,
    cfg: ChainConfig,
    url: str,
    *,
    current_epoch: Optional[int] = None,
) -> Tuple[object, object, bytes]:
    """Fetch the remote's finalized state + matching block.

    Returns (state, signed_block, block_root).  Raises CheckpointSyncError
    when the state is malformed, the block doesn't match, or the
    checkpoint is outside the weak-subjectivity period.
    """
    from ..db.beacon import _fork_tagged_block_codec, _fork_tagged_state_codec
    from ..state_transition.upgrade import state_types

    from urllib.parse import urlsplit

    parts = urlsplit(url if "//" in url else f"http://{url}")
    if parts.scheme not in ("http", ""):
        raise CheckpointSyncError(
            f"unsupported scheme {parts.scheme!r} (plain http only; this "
            "client does not speak TLS)"
        )
    host = parts.hostname or "127.0.0.1"
    port = parts.port or 80
    api = ApiClient(host, port)

    raw_state = await api.get("/eth/v2/debug/beacon/states/finalized")
    if not isinstance(raw_state, (bytes, bytearray)) or len(raw_state) < 2:
        raise CheckpointSyncError("remote returned no state bytes")
    _enc_s, dec_s = _fork_tagged_state_codec(preset)
    try:
        state = dec_s(bytes(raw_state))
    except Exception as e:
        raise CheckpointSyncError(f"cannot decode checkpoint state: {e}") from e

    raw_block = await api.get("/eth/v2/beacon/blocks/finalized")
    if not isinstance(raw_block, (bytes, bytearray)):
        raise CheckpointSyncError("remote returned no block bytes")
    _enc_b, dec_b = _fork_tagged_block_codec(preset)
    try:
        signed_block = dec_b(bytes(raw_block))
    except Exception as e:
        raise CheckpointSyncError(f"cannot decode checkpoint block: {e}") from e

    # the block must actually be the state's latest block
    from ..state_transition.upgrade import block_types

    block = signed_block.message
    if bytes(block.state_root) != state_types(preset, state).BeaconState.hash_tree_root(state):
        raise CheckpointSyncError("checkpoint block.state_root does not match the state")
    block_root = block_types(preset, block).BeaconBlock.hash_tree_root(block)

    ws_epoch = compute_epoch_at_slot(preset, state.slot)
    if current_epoch is not None:
        now_epoch = current_epoch
    else:
        # wall-clock epoch from the fetched state's own genesis time — the
        # default MUST be the real clock, not the checkpoint's epoch, or
        # the staleness check below can never fire.  Dev/interop
        # chains carry a synthetic genesis_time (seconds since 1970 ≈ 0)
        # whose wall-clock epoch is astronomically large and meaningless:
        # there the TRUSTED remote's own head is the only clock available.
        import time as _time

        if int(state.genesis_time) < 1_000_000_000:  # pre-2001: synthetic
            syncing = await api.get("/eth/v1/node/syncing")
            head_slot = int(syncing["data"]["head_slot"])
            now_epoch = head_slot // preset.SLOTS_PER_EPOCH
        else:
            seconds = max(0, int(_time.time()) - int(state.genesis_time))
            now_epoch = seconds // cfg.SECONDS_PER_SLOT // preset.SLOTS_PER_EPOCH
    if not is_within_weak_subjectivity_period(preset, state, ws_epoch, now_epoch):
        raise CheckpointSyncError(
            f"checkpoint at epoch {ws_epoch} is outside the weak-subjectivity "
            f"period at epoch {now_epoch} — refusing to trust it"
        )
    logger.info(
        "checkpoint state fetched: slot %d, root %s", state.slot, block_root.hex()[:12]
    )
    return state, signed_block, block_root
