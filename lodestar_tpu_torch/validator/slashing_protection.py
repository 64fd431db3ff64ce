"""Slashing protection: double-vote, surround-vote, and double-proposal
guards with the EIP-3076 interchange format.

Reference: packages/validator/src/slashingProtection/ (index.ts:30;
attestation/ with MinMaxSurround, block/ with proposal uniqueness;
interchange/ for the JSON format).  Model: the min-max-surround espresso
scheme reduced to its observable contract — per validator we keep every
signed (source, target) pair and signed proposal slot, and refuse to sign
anything that is a double vote, surrounds/is surrounded by a prior vote,
or repeats a proposal slot with a different root.  The full interchange
round-trips through `export_interchange` / `import_interchange`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple


class SlashingError(Exception):
    pass


class SlashingProtection:
    """In-memory history plus an optional crash-safe store.

    When ``persist_path`` is set, every accepted record is appended to a
    write-ahead log (``<path>.wal``, one JSON line per record, fsync'd)
    BEFORE check_and_insert returns — the reference persists each record to
    its DB before releasing a signature for the same reason: an export only
    at graceful shutdown loses everything signed since startup on a crash,
    and the restarted process would happily double-sign.  ``checkpoint()``
    folds the WAL into the interchange file atomically."""

    def __init__(
        self,
        genesis_validators_root: bytes = b"\x00" * 32,
        persist_path: Optional[str] = None,
    ):
        self.genesis_validators_root = genesis_validators_root
        # pubkey -> list of (source_epoch, target_epoch, signing_root)
        self._attestations: Dict[bytes, List[Tuple[int, int, bytes]]] = {}
        # pubkey -> {slot: signing_root}
        self._proposals: Dict[bytes, Dict[int, bytes]] = {}
        self.persist_path = persist_path
        self._wal = None
        self._wal_records = 0
        # auto-fold threshold: bounds both WAL size and restart replay time
        # on long validator runs (one record per duty per key adds up)
        self.checkpoint_every = 4096
        if persist_path:
            if os.path.exists(persist_path):
                with open(persist_path) as f:
                    self.import_json(f.read())
            wal_path = persist_path + ".wal"
            if os.path.exists(wal_path):
                with open(wal_path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            # torn final line from a crash mid-append: its
                            # signature was never released (we fsync before
                            # returning), so stopping here is safe — dying
                            # at startup is not
                            break
                        self._replay_wal_record(rec)
            self._wal = open(wal_path, "a")

    def _replay_wal_record(self, rec: dict) -> None:
        pk = bytes.fromhex(rec["pubkey"])
        root = bytes.fromhex(rec["signing_root"])
        if rec["kind"] == "attestation":
            self._attestations.setdefault(pk, []).append(
                (int(rec["source_epoch"]), int(rec["target_epoch"]), root)
            )
        else:
            self._proposals.setdefault(pk, {})[int(rec["slot"])] = root

    def _wal_append(self, rec: dict) -> None:
        if self._wal is None:
            return
        self._wal.write(json.dumps(rec) + "\n")
        self._wal.flush()
        os.fsync(self._wal.fileno())
        self._wal_records += 1

    def _maybe_auto_checkpoint(self) -> None:
        """Called by check_and_insert_* AFTER the record is in memory (a
        checkpoint taken before the in-memory insert would drop it)."""
        if self._wal is not None and self._wal_records >= self.checkpoint_every:
            self.checkpoint()

    def checkpoint(self) -> None:
        """Fold the WAL into the interchange file (atomic replace) and
        truncate it.  Called on graceful shutdown and safe to call
        periodically."""
        if not self.persist_path:
            return
        tmp = self.persist_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.export_json())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.persist_path)
        if self._wal is not None:
            self._wal.close()
            self._wal = open(self.persist_path + ".wal", "w")
        self._wal_records = 0

    def close(self) -> None:
        self.checkpoint()
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    # -- attestations ----------------------------------------------------------

    def check_and_insert_attestation(
        self, pubkey: bytes, source_epoch: int, target_epoch: int, signing_root: bytes
    ) -> None:
        """Raises SlashingError if signing would be slashable; records the
        attestation otherwise.  Mirrors checkAndInsertAttestation
        (slashingProtection/index.ts:52)."""
        if source_epoch > target_epoch:
            raise SlashingError("source after target")
        hist = self._attestations.setdefault(pubkey, [])
        for s, t, root in hist:
            if t == target_epoch and root != signing_root:
                raise SlashingError(f"double vote at target {target_epoch}")
            if t == target_epoch and root == signing_root:
                return  # identical re-sign is safe
            # new surrounds old
            if source_epoch < s and target_epoch > t:
                raise SlashingError(f"surrounds prior vote ({s}->{t})")
            # old surrounds new
            if s < source_epoch and t > target_epoch:
                raise SlashingError(f"surrounded by prior vote ({s}->{t})")
        # durable before the caller may release a signature
        self._wal_append(
            {
                "kind": "attestation",
                "pubkey": pubkey.hex(),
                "source_epoch": source_epoch,
                "target_epoch": target_epoch,
                "signing_root": signing_root.hex(),
            }
        )
        hist.append((source_epoch, target_epoch, signing_root))
        self._maybe_auto_checkpoint()

    # -- proposals -------------------------------------------------------------

    def check_and_insert_block_proposal(
        self, pubkey: bytes, slot: int, signing_root: bytes
    ) -> None:
        """Raises SlashingError on a conflicting proposal at `slot`
        (checkAndInsertBlockProposal, block/index.ts)."""
        props = self._proposals.setdefault(pubkey, {})
        prior = props.get(slot)
        if prior is not None and prior != signing_root:
            raise SlashingError(f"double proposal at slot {slot}")
        if prior is None:
            self._wal_append(
                {
                    "kind": "proposal",
                    "pubkey": pubkey.hex(),
                    "slot": slot,
                    "signing_root": signing_root.hex(),
                }
            )
        props[slot] = signing_root
        self._maybe_auto_checkpoint()

    # -- EIP-3076 interchange --------------------------------------------------

    def export_interchange(self) -> dict:
        data = []
        pubkeys = set(self._attestations) | set(self._proposals)
        for pk in sorted(pubkeys):
            data.append(
                {
                    "pubkey": "0x" + pk.hex(),
                    "signed_blocks": [
                        {"slot": str(slot), "signing_root": "0x" + root.hex()}
                        for slot, root in sorted(self._proposals.get(pk, {}).items())
                    ],
                    "signed_attestations": [
                        {
                            "source_epoch": str(s),
                            "target_epoch": str(t),
                            "signing_root": "0x" + root.hex(),
                        }
                        for s, t, root in self._attestations.get(pk, [])
                    ],
                }
            )
        return {
            "metadata": {
                "interchange_format_version": "5",
                "genesis_validators_root": "0x" + self.genesis_validators_root.hex(),
            },
            "data": data,
        }

    def import_interchange(self, interchange: dict) -> None:
        meta = interchange.get("metadata", {})
        gvr = meta.get("genesis_validators_root")
        if gvr and bytes.fromhex(gvr[2:]) != self.genesis_validators_root:
            raise SlashingError("interchange genesis_validators_root mismatch")
        for entry in interchange.get("data", []):
            pk = bytes.fromhex(entry["pubkey"][2:])
            for blk in entry.get("signed_blocks", []):
                root = bytes.fromhex(blk.get("signing_root", "0x" + "00" * 32)[2:])
                self._proposals.setdefault(pk, {})[int(blk["slot"])] = root
            for att in entry.get("signed_attestations", []):
                root = bytes.fromhex(att.get("signing_root", "0x" + "00" * 32)[2:])
                self._attestations.setdefault(pk, []).append(
                    (int(att["source_epoch"]), int(att["target_epoch"]), root)
                )
        # migrated protection history must be durable BEFORE any signature
        # is released: a crash between a keymanager import and the next
        # auto-checkpoint would otherwise re-enable double-signing
        if self.persist_path:
            self.checkpoint()

    def export_json(self) -> str:
        return json.dumps(self.export_interchange(), indent=2)

    def import_json(self, raw: str) -> None:
        self.import_interchange(json.loads(raw))
