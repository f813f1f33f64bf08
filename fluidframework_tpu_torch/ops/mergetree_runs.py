"""The rightward spread of the run-batch merge module.

Port of the one piece of ``fluidframework_tpu/ops/mergetree_runs.py``
that the block table needs (``_spread_right``, used by
:func:`.mergetree_blocks.from_flat`). The run-batch tick itself
(``apply_tick_runs``) is not ported: nothing on the serving path calls it.
"""

from __future__ import annotations

import torch


def _spread_right(planes: list[torch.Tensor], shift: torch.Tensor
                  ) -> list[torch.Tensor]:
    """Move element j of each plane to j + shift[:, j] along axis 1
    (``shift`` i32[B, S], monotone non-decreasing per row, so no two
    elements collide). Content pushed past the end is dropped; vacated
    and never-filled slots hold unspecified values — callers mask them."""
    b, s = shift.shape
    iota = torch.arange(s, device=shift.device)[None, :]
    dst = iota + shift.long()
    inside = (dst < s) & (shift > 0)
    rows = torch.arange(b, device=shift.device)[:, None].expand(b, s)
    rows, src_j, dst_j = rows[inside], iota.expand(b, s)[inside], dst[inside]
    out = []
    for p in planes:
        moved = p.clone()
        moved[rows, dst_j] = p[rows, src_j]
        out.append(moved)
    return out
