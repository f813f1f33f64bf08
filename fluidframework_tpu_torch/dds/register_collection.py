"""ConsensusRegisterCollection DDS — linearizable registers.

Reference parity: packages/dds/register-collection/src/
consensusRegisterCollection.ts:94: a write is *acknowledged at sequencing*
(not applied eagerly); a register keeps the set of concurrent "versions":
a sequenced write whose refSeq saw the previous winner replaces all
versions; one that raced it (refSeq < winner's seq) is appended as a
concurrent version. Reads choose Atomic (first/earliest version) or LWW
(latest).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..protocol.messages import SequencedDocumentMessage
from .shared_object import ChannelFactory, SharedObject


@dataclass(slots=True)
class _Register:
    # Each version: {"value": v, "seq": sequence number of the write}.
    versions: list[dict] = field(default_factory=list)


class ConsensusRegisterCollection(SharedObject):
    channel_type = "https://graph.microsoft.com/types/consensus-register-collection"

    ATOMIC = "atomic"
    LWW = "lww"

    def __init__(self, channel_id: str, runtime=None, attributes=None) -> None:
        super().__init__(channel_id, runtime, attributes)
        self._registers: dict[str, _Register] = {}
        # Local writes awaiting sequencing: callbacks keyed by a local id.
        self._next_pending = 0

    # -- public API -----------------------------------------------------------

    def write(self, key: str, value: Any) -> None:
        """Submit a register write; it takes effect when sequenced. Nothing
        changes locally until the ack arrives (consensus semantics)."""
        self._next_pending += 1
        self.submit_local_message({"type": "write", "key": key,
                                   "value": value}, self._next_pending)

    def read(self, key: str, policy: str = ATOMIC) -> Any:
        register = self._registers.get(key)
        if not register or not register.versions:
            return None
        version = (register.versions[0] if policy == self.ATOMIC
                   else register.versions[-1])
        return version["value"]

    def read_versions(self, key: str) -> list[Any]:
        register = self._registers.get(key)
        return [v["value"] for v in register.versions] if register else []

    def keys(self) -> list[str]:
        return sorted(self._registers)

    # -- sequenced apply -------------------------------------------------------

    def process_core(self, message: SequencedDocumentMessage, local: bool,
                     local_op_metadata: Any) -> None:
        op = message.contents
        assert op["type"] == "write"
        register = self._registers.setdefault(op["key"], _Register())
        ref_seq = message.reference_sequence_number
        seq = message.sequence_number
        # If this write saw every existing version (refSeq >= their seqs),
        # it supersedes them; otherwise it raced them and joins as a
        # concurrent version (consensusRegisterCollection.ts processCore).
        if all(ref_seq >= v["seq"] for v in register.versions):
            register.versions = [{"value": op["value"], "seq": seq}]
        else:
            register.versions.append({"value": op["value"], "seq": seq})

    def summarize_core(self) -> dict:
        return {"registers": {
            key: [dict(v) for v in register.versions]
            for key, register in sorted(self._registers.items())
        }}

    def load_core(self, content: dict) -> None:
        self._registers = {
            key: _Register(versions=[dict(v) for v in versions])
            for key, versions in content["registers"].items()
        }

    def apply_stashed_op(self, contents: Any) -> Any:
        self._next_pending += 1
        return self._next_pending


class ConsensusRegisterCollectionFactory(ChannelFactory):
    channel_type = ConsensusRegisterCollection.channel_type
    shared_object_cls = ConsensusRegisterCollection
