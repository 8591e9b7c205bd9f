"""Row gathers (port of lsr_tpu/core/gather.py: take_rows).

lsr_tpu feeds its row gathers flat int32 indices, the form XLA lowers to a
fast gather on the TPU.  Here the gather is plain tensor indexing with flat
int64 indices.  Ids index as jnp indexing does: a negative id counts from
the end, and one still out of range is clamped to the table, as XLA's
gather clamps it.
"""

from __future__ import annotations

import torch


def take_rows(table, idx):
    """table[idx] for a row table (R, ...) and any-shape integer ids:
    idx.shape + table.shape[1:]."""
    r = table.shape[0]
    flat = idx.reshape(-1).to(torch.int64)
    flat = torch.clamp(torch.where(flat < 0, flat + r, flat), 0, r - 1)
    return table[flat].reshape(tuple(idx.shape) + tuple(table.shape[1:]))
