"""Device-side opcode constants shared by all batched kernels.

Everything the kernels see is int32. MessageType values come from
:class:`fluidframework_tpu.protocol.messages.MessageType` (stable wire
constants); this module adds ticket-outcome, send-type and nack codes.
"""

from __future__ import annotations

import numpy as np

INT32_MAX = np.int32(2**31 - 1)

# Ticket outcome (reference deli: sequenced message | nack | silent drop,
# server/routerlicious/packages/lambdas/src/deli/lambda.ts:236-470).
OUT_IGNORED = 0    # duplicate / dup-join / dup-leave: silently dropped
OUT_SEQUENCED = 1  # ticketed with a sequence number (or unrevved noop carrier)
OUT_NACK = 2       # rejected back to the submitting client

# Send heuristics (deli SendType).
SEND_IMMEDIATE = 0
SEND_LATER = 1     # delayed no-op consolidation
SEND_NEVER = 2

# Nack reasons (subset of NackErrorType + deli codes).
NACK_NONE = 0
NACK_GAP = 1            # gap in clientSequenceNumber (code 400)
NACK_REFSEQ_BELOW_MSN = 2  # referenceSequenceNumber < MSN (code 400)
NACK_NONEXISTENT_CLIENT = 3  # unknown or nacked client (code 400)
NACK_NO_SUMMARY_SCOPE = 4    # summarize without permission (code 403)
NACK_FUTURE = 5         # service is draining/rejecting all (control-driven)
NACK_INVALID_TYPE = 6   # client submitted a service-only message type
